"""The low-memory banded layouts of the port's IterativeStepper against
vasp_tpu's on the small FSI tube's first 3 layers: tests/test_iterative_stepper.py's
test_lowmem_banded_path, test_lowmem_hybrid_matches_lu and
test_lowmem_small_bandwidth_factor_escalation mirrored. vasp_tpu takes
its low-memory layout under VASP_FORCE_LOWMEM; the port under a
monkeypatched fem.banded.device_free_bytes, one byte short of the full
layout's peak. Besides the hybrid layout, the Sinv-only bf16 layout
(K12), the one banded_factor_dtype="bf16" takes there (its full bf16
layout's factors and apply: tests/test_torch_banded_lowmem.py).

The same layout and factor storage, the same Newton counts and ladder
tiers, and U within 3e-5 relative of vasp_tpu's (the bound of the gmres
path's parity, tests/test_torch_driver_gmres.py; measured 2.8e-12 to 1.2e-7:
both solve each direction to gmres_tol with float32 factors that differ
by rounding)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_small_fsi import MESH, SHORT_MESH, damage_sinv, loaded_pair, \
    quiet_step, torch_threads
from vasp_tpu.fem.timestepper import IterativeStepper as JaxStepper
from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
from vasp_tpu_torch.fem import banded as tb
from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

_threads = torch_threads(2)
TOL_U = 3e-5
_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.fixture(scope="module")
def pair():
    return loaded_pair(SHORT_MESH)


def _force_lowmem(monkeypatch, ts, dtype):
    """vasp_tpu under VASP_FORCE_LOWMEM; the port's free memory one byte
    short of its full layout's peak (returns that layout rule's choice)."""
    sizes = [tuple(b.dofs.shape) for b in ts.assembler.blocks]
    pat = tb.build_banded_pattern([b.dofs.numpy()
                                   for b in ts.assembler.blocks],
                                  ts.assembler.ndof)
    free = tb.banded_layout(pat, sizes, float("inf"), dtype).full_bytes - 1
    monkeypatch.setattr(tb, "device_free_bytes", lambda device: free)
    monkeypatch.setenv("VASP_FORCE_LOWMEM", "1")
    return tb.banded_layout(pat, sizes, free, dtype)


def _steppers(pair, opts, dtype, recompute_tstep=20):
    (js, jbc, _, _), (ts, tbc, _, _) = pair
    jst = JaxStepper(js, jbc, JaxOptions(banded_factor_dtype=dtype, **opts),
                     recompute_tstep=recompute_tstep)
    tst = IterativeStepper(ts, tbc, StepOptions(banded_factor_dtype=dtype,
                                                **opts),
                           recompute_tstep=recompute_tstep)
    return jst, tst


def _same_storage(jst, tst):
    return [_DTYPES[jnp.dtype(F.dtype)] for F in jst._pinv] == \
        [F.dtype for F in tst._pinv]


def _rel(tU, jU):
    tU, jU = tU.numpy(), np.asarray(jU)
    return np.linalg.norm(tU - jU) / np.linalg.norm(jU)


# (id, banded_factor_dtype, forced low-memory, load scales, the port's
# layout, its factor storage)
CASES = [
    ("hybrid", None, True, (1.0, 1.0), "hybrid",
     (torch.float32, torch.bfloat16, torch.bfloat16)),
    ("sinv_bf16", "bf16", True, (1.0,), "bf16", (torch.bfloat16,) * 3),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layout_steps_match_vasp_tpu(pair, monkeypatch, case):
    """test_lowmem_banded_path / test_lowmem_hybrid_matches_lu: the steps
    converge in both packages with the same counts; the hybrid run then
    reuses its factors for a second step and rebuilds them once more."""
    _, dtype, forced, loads, layout, storage = case
    (js, _, jload, jbcv), (ts, _, tload, tbcv) = pair
    if forced:
        assert _force_lowmem(monkeypatch, ts, dtype).layout == layout
    opts = dict(atol=1e-9, rtol=1e-9, max_it=10, gmres_tol=1e-8,
                gmres_restart=60, gmres_maxiter=600, overlap=2)
    jst, tst = _steppers(pair, opts, dtype)
    assert tst.layout.layout == layout
    assert jst._banded_lowmem == forced
    if forced:
        assert jst._lowmem_mode == layout
    jU, tU = js.zero_state(), ts.zero_state()
    for k, scale in enumerate(loads, start=1):
        jU1, jstats, jtiers = quiet_step(jst, jU, jbcv, scale * jload, k)
        tU1, tstats, ttiers = quiet_step(tst, tU, tbcv, scale * tload, k)
        assert tuple(F.dtype for F in tst._pinv) == storage
        assert _same_storage(jst, tst)
        assert jtiers == ttiers == tst.history[-1]["tiers"]
        assert tstats["iterations"] == int(jstats["iterations"])
        assert tstats["residual"] < 1e-8
        assert _rel(tU1, jU1) <= TOL_U
        jU, tU, jU_prev, tU_prev = jU1, tU1, jU, tU
    assert tst.rebuilds == 1  # the later steps reused the factors
    tst._rebuild(tU, tU_prev, len(loads) + 1)
    jst._rebuild(jU, jU_prev, len(loads) + 1)
    assert tuple(F.dtype for F in tst._pinv) == storage
    assert _same_storage(jst, tst)


def test_lowmem_f64_factor_tier_matches_vasp_tpu(monkeypatch):
    """test_lowmem_small_bandwidth_factor_escalation: under the hybrid
    layout, with the float64 factor tier fitting, damaged factors make a
    f32f step stall past the exact-residual retry, and both packages take
    the float64 factor tier (no probe exists on this path). On a tube of 7
    blocks: the tier's six c x c float64 temporaries (48 c^2 bytes) fit
    below the full layout's peak only where 2 F = 8 nb c^2 bytes exceed
    them, nb > 6: a thin tube of 10 layers (n_theta=6, n_r_fluid=1;
    5,561 dofs, c = 848)."""
    pair = loaded_pair(dict(MESH, n_theta=6, n_r_fluid=1, n_z=10,
                            length=0.016))
    (js, _, jload, jbcv), (ts, _, tload, tbcv) = pair
    assert _force_lowmem(monkeypatch, ts, None).f64_fits
    opts = dict(atol=1e-6, rtol=1e-6, max_it=8, gmres_tol=1e-8,
                gmres_restart=60, gmres_maxiter=60, overlap=2,
                residual_dtype="f32f")
    jst, tst = _steppers(pair, opts, None, recompute_tstep=1000)
    assert jst._lowmem_esc_ok and tst.layout.layout == "hybrid"
    assert tst.layout.f64_fits
    jU1, _, _ = quiet_step(jst, js.zero_state(), jbcv, jload, 1)
    tU1, _, _ = quiet_step(tst, ts.zero_state(), tbcv, tload, 1)
    assert not jst._banded_f64 and not tst._banded_f64
    damage_sinv(jst, tst)
    jU2, jstats, jtiers = quiet_step(jst, jU1, jbcv, 3.0 * jload, 2)
    tU2, tstats, ttiers = quiet_step(tst, tU1, tbcv, 3.0 * tload, 2)
    assert jst._banded_f64 and tst._banded_f64
    assert jtiers == ttiers == tst.history[-1]["tiers"] == [
        "fine_retry", "f64_factors"]
    assert tstats["iterations"] == int(jstats["iterations"])
    assert torch.isfinite(tU2).all() and tstats["residual"] < 1e-5
    assert _rel(tU2, jU2) <= TOL_U
