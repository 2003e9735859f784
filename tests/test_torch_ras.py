"""Parity of the port's RAS preconditioner (fem/ras.py, K18's plain
version, precond="ras" of IterativeStepper) with vasp_tpu.fem.ras on the
small FSI tube's first 3 layers (4 subdomains of 1,946 local dofs).

tests/test_iterative_stepper.py:50-167's three stepper runs
(test_ras_stepper_matches_lu, test_ras_stepper_reuses_preconditioner,
test_ras_stepper_f32_jacobian) leave precond at its default, "banded";
here both packages run them with precond="ras".

Tolerances, each with its reason:
- the float64 Ruiz scales of the float64 element Jacobians: 1e-15 (the
  same multiplies and max; sqrt and the divide correctly rounded);
- the pattern (idx, own): equal (the same host code on the same CSR, and
  vasp_tpu's native overlap layers equal the numpy ones);
- the local blocks: 1e-12 relative (the same slices of one CSR: equal);
- the inverses: 1e-10 relative per block (float64 LU inverses, LAPACK
  through numpy and through torch);
- the apply: float64 1e-12, float32 1e-6 relative (m-term float32 sums in
  another order);
- the runs: the same Newton counts and ladder tiers, U within 1e-6
  relative of vasp_tpu's (measured 6.2e-13 to 8.3e-10)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from _torch_small_fsi import SHORT_MESH, loaded_pair, quiet_step, \
    torch_threads
from vasp_tpu.fem import ras as jr
from vasp_tpu.fem.scaling import ruiz_scales as jax_ruiz_scales
from vasp_tpu.fem.timestepper import IterativeStepper as JaxStepper
from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
from vasp_tpu_torch.fem import ras as tr
from vasp_tpu_torch.fem.scaling import ruiz_scales
from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions
from vasp_tpu_torch.kernels import ras as kr

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def pair():
    return loaded_pair(SHORT_MESH)


@pytest.fixture(scope="module")
def scaled(pair):
    """The port's float64 Jacobians at the loaded tube's first step, each
    package's Ruiz scales of them, the scaled CSR from vasp_tpu's scales,
    and the dof coordinates of the port's stepper."""
    (js, jbc, _, _), (ts, tbc, _, tbcv) = pair
    asm = ts.assembler
    U0 = ts.zero_state()
    tjacs = asm.element_jacobians(torch.where(tbc.mask_on("cpu"), tbcv, U0),
                                  U0)
    dr, dc = jax_ruiz_scales(js.assembler.blocks,
                             [jnp.asarray(J.numpy()) for J in tjacs],
                             jnp.asarray(jbc.mask), asm.ndof, sweeps=4)
    A = asm.to_csr(tjacs, bc_mask=tbc.mask)
    A_s = (sp.diags(np.asarray(dr)) @ A @ sp.diags(np.asarray(dc))).tocsr()
    tdr, tdc = ruiz_scales(asm.blocks, tjacs, tbc.mask_on("cpu"), asm.ndof,
                           sweeps=4)
    coords = IterativeStepper(ts, tbc, StepOptions(precond="ras")
                              )._dof_coords()
    return (np.asarray(dr), np.asarray(dc)), (tdr, tdc), A_s, coords, \
        np.asarray(jbc.mask)


def test_ruiz_scales_f64_match_vasp_tpu(scaled):
    (jdr, jdc), (tdr, tdc), *_ = scaled
    assert tdr.dtype == torch.float64
    np.testing.assert_allclose(tdr.numpy(), jdr, rtol=1e-15)
    np.testing.assert_allclose(tdc.numpy(), jdc, rtol=1e-15)


@pytest.fixture(scope="module")
def patterns(scaled):
    _, _, A_s, coords, mask = scaled
    ndof = A_s.shape[0]
    adj = (abs(A_s) + abs(A_s.T)).tocsr()
    n_sub = max(2, ndof // 1500)
    return (jr.build_pattern_auto(adj, ndof, n_sub, coords=coords),
            tr.build_pattern_auto(adj, ndof, n_sub, coords=coords))


def test_pattern_blocks_and_inverses_match_vasp_tpu(scaled, patterns):
    _, _, A_s, _, mask = scaled
    jpat, tpat = patterns
    np.testing.assert_array_equal(tpat.idx, jpat.idx)
    np.testing.assert_array_equal(tpat.own, jpat.own)
    assert tpat.pad_dof == jpat.pad_dof == A_s.shape[0]
    # every real dof has exactly one owner (K18 relies on it)
    assert np.all(np.bincount(tpat.idx[tpat.own],
                              minlength=A_s.shape[0]) == 1)
    jblocks = jr.extract_local_blocks(A_s, jpat, mask)
    tblocks = tr.extract_local_blocks(A_s, tpat, mask)
    scale = np.abs(jblocks).max()
    assert np.abs(tblocks - jblocks).max() <= 1e-12 * scale
    jinv = np.asarray(jr.invert_blocks(jblocks))
    tinv = tr.invert_blocks(tblocks, torch.float64, "cpu").numpy()
    for s in range(jinv.shape[0]):
        assert np.linalg.norm(tinv[s] - jinv[s]) <= \
            1e-10 * np.linalg.norm(jinv[s])


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_apply_matches_vasp_tpu(scaled, patterns, dtype, tol):
    """K18's plain version against vasp_tpu's make_apply on the same
    inverses (stored in `dtype`) and the same vector."""
    _, _, A_s, _, mask = scaled
    jpat, tpat = patterns
    inv = np.asarray(jr.invert_blocks(jr.extract_local_blocks(
        A_s, jpat, mask))).astype(dtype)
    ndof = A_s.shape[0]
    r = np.random.default_rng(2).standard_normal(ndof)
    want = np.asarray(jr.make_apply(jpat, ndof)(jnp.asarray(inv),
                                                jnp.asarray(r)))
    got = tr.make_apply(tpat, "cpu")(torch.as_tensor(inv),
                                     torch.as_tensor(r))
    assert got.dtype == torch.float64
    assert np.linalg.norm(got.numpy() - want) <= tol * np.linalg.norm(want)
    # the plain version directly, float32 r: the inverses' type, then r's
    y = kr.apply_plain(torch.as_tensor(inv), torch.as_tensor(tpat.idx),
                       torch.as_tensor(tpat.own), torch.as_tensor(r,
                                                 dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (ndof,)


# tests/test_iterative_stepper.py:50-167's runs: (id, StepOptions, load
# scales per step)
RUNS = [
    ("matches_lu", dict(atol=1e-10, rtol=1e-10, max_it=8, gmres_tol=1e-9,
                        gmres_restart=60, gmres_maxiter=600, overlap=2),
     (1.0,)),
    ("reuses_preconditioner", dict(atol=1e-9, rtol=1e-9, max_it=8,
                                   gmres_tol=1e-8, gmres_restart=60,
                                   gmres_maxiter=600, overlap=2),
     (1.0, 1.5)),
    ("f32_jacobian", dict(atol=1e-9, rtol=1e-9, max_it=10, gmres_tol=1e-6,
                          gmres_restart=60, gmres_maxiter=600, overlap=2,
                          jac_dtype="f32"), (1.0,)),
]


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_ras_steps_match_vasp_tpu(pair, run):
    _, opts, loads = run
    (js, jbc, jload, jbcv), (ts, tbc, tload, tbcv) = pair
    jst = JaxStepper(js, jbc, JaxOptions(precond="ras", **opts),
                     recompute_tstep=20)
    tst = IterativeStepper(ts, tbc, StepOptions(precond="ras", **opts),
                           recompute_tstep=20)
    assert tst.layout is None and not hasattr(tst, "_bpat")
    jU, tU = js.zero_state(), ts.zero_state()
    for k, scale in enumerate(loads, start=1):
        jU, jstats, jtiers = quiet_step(jst, jU, jbcv, scale * jload, k)
        tU, tstats, ttiers = quiet_step(tst, tU, tbcv, scale * tload, k)
        assert jtiers == ttiers == tst.history[-1]["tiers"] == []
        assert tstats["iterations"] == int(jstats["iterations"])
        assert tstats["residual"] < opts["atol"] * 10
        jn = np.asarray(jU)
        assert np.linalg.norm(tU.numpy() - jn) <= 1e-6 * np.linalg.norm(jn)
    # one rebuild (step 1): later steps reuse the inverses
    assert tst.rebuilds == 1 and tst._last_rebuild == jst._last_rebuild == 1
    np.testing.assert_array_equal(tst._ras_pattern.idx, jst._pattern.idx)
    (pinv,) = tst._pinv
    assert pinv.dtype == (torch.float32 if opts.get("jac_dtype") == "f32"
                          else torch.float64)
