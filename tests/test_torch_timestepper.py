"""Parity of the port's IterativeStepper (banded preconditioner) with
vasp_tpu's on the small FSI tube under an interface pressure load: equal
Newton iterations per step, U within 1e-7 relative (1e-6 for the float32
Krylov run, see its docstring), factor reuse on the
second step, the float64 exact Newton variant, and the stall-triggered
rebuild under damaged factors.

U tolerance, 1e-7 relative: both sides converge to atol=1e-8 on the same
f64 residual, but their float32 Jacobians and factors round differently
(vasp_tpu computes Jacobians in float32 arithmetic, the port rounds float64
ones once), so their GMRES directions and the last Newton iterate differ
at that level (measured 7.8e-10 on the first step). Every step here takes
at most 8 Newton iterations, so vasp_tpu's 8-iteration chunking, which
the port does not have, changes nothing."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_dist import in_thread
from _torch_small_fsi import loaded_pair, torch_threads
from vasp_tpu.fem.timestepper import IterativeStepper as JaxStepper
from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

_threads = torch_threads(2)

OPTS = dict(atol=1e-8, rtol=1e-8, max_it=6, gmres_tol=1e-8,
            gmres_restart=40, gmres_maxiter=80, jac_dtype="f32",
            precond="banded")


@pytest.fixture(scope="module")
def pair():
    return loaded_pair()


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _two_steps(pair, **extra):
    (js, jbc, jload, jbcv), (ts, tbc, tload, tbcv) = pair
    jst = JaxStepper(js, jbc, JaxOptions(**OPTS, **extra), recompute_tstep=5)
    tst = IterativeStepper(ts, tbc, StepOptions(**OPTS, **extra),
                           recompute_tstep=5)

    def steps(st, U, bcv, load):
        out = []
        for tstep, scale in ((1, 1.0), (2, 1.5)):
            U, stats = st.step(U, bcv, scale * load, tstep)
            out.append((U, stats))
        return out

    # vasp_tpu's steps on a thread beside the port's: the two share nothing
    jax_steps = in_thread(steps, jst, js.zero_state(), jbcv, jload)
    port = steps(tst, ts.zero_state(), tbcv, tload)
    out = [(np.asarray(jU), jstats, tU, tstats)
           for (jU, jstats), (tU, tstats) in zip(jax_steps(), port)]
    return jst, tst, out


@pytest.fixture(scope="module")
def default_steps(pair):
    """Two steps of both steppers with OPTS (one rebuild, one reuse)."""
    return _two_steps(pair)


def test_steps_match_vasp_tpu(default_steps):
    jst, tst, out = default_steps
    for jU, jstats, tU, tstats in out:
        assert tU.dtype == torch.float64
        assert tstats["iterations"] == int(jstats["iterations"])
        assert tstats["residual"] <= 1e-8
        assert _rel(tU.numpy(), jU) <= 1e-7
    # the second step reused the first step's factors, as vasp_tpu did
    assert tst.rebuilds == 1 and tst._last_rebuild == jst._last_rebuild == 1
    assert tst.gmres_inner > 0
    for phase in ("rebuild_jacobians", "ruiz", "assemble", "factorize", "hg",
                  "probe", "jacobians", "residual", "gmres", "matvec",
                  "precond"):
        assert tst.timings[phase] > 0.0


def test_f32_krylov_ew_forcing_and_predictor_match_vasp_tpu(pair):
    """krylov_dtype="f32", forcing="ew" and predictor="extrapolate" change
    host scalars and dtypes only; iterations agree and U within 1e-6.

    The bound is not the 1e-7 of the float64 Krylov runs: two inexact-Newton
    runs whose float32 Krylov sums run in other orders (torch's threads and
    BLAS pick theirs) meet only to what atol=1e-8 bounds through the
    conditioning, and EW forcing solves the early directions to eta up to
    1e-2 only. Measured on the second step, at 1, 2, 4 and 8 torch threads:
    2.3e-8, 5.1e-8, 6.8e-8 and 9.4e-8, and 5.1e-8 at this module's 2
    threads under pytest -n 6 beside the rest of the suite; the bound is
    ten times the worst."""
    _, _, out = _two_steps(pair, krylov_dtype="f32", forcing="ew",
                           predictor="extrapolate")
    for jU, jstats, tU, tstats in out:
        assert tstats["iterations"] == int(jstats["iterations"])
        assert _rel(tU.numpy(), jU) <= 1e-6


def test_exact_newton_matches_vasp_tpu(pair, default_steps):
    """The exact variant (float64 Jacobians, float64 GMRES, 5x cycles) from
    the second step's state, on top of the first step's preconditioner."""
    (_, _, jload, jbcv), (_, _, tload, tbcv) = pair
    jst, tst, out = default_steps
    jU, _, tU, _ = out[-1]
    jU2, _, jstats = jst._newton_chunked(jnp.asarray(jU), jnp.asarray(jU),
                                         jbcv, 2.0 * jload, False,
                                         OPTS["max_it"], exact=True)
    tU2, tstats = tst._newton(tU, tU, tbcv, 2.0 * tload, OPTS["max_it"],
                              exact=True)
    assert tstats["iterations"] == int(jstats["iterations"])
    assert _rel(tU2.numpy(), np.asarray(jU2)) <= 1e-7


def test_stall_triggered_rebuild(pair):
    """Damaged factors at a step that does not rebuild must stall Newton,
    trip the stall-triggered rebuild and end no worse than the raw Newton
    run on the damaged factors (as vasp_tpu's test_iterative_stepper.py
    checks for its stepper)."""
    _, (ts, tbc, tload, tbcv) = pair
    tst = IterativeStepper(ts, tbc, StepOptions(**OPTS),
                           recompute_tstep=1000)
    U1, _ = tst.step(ts.zero_state(), tbcv, tload, 1)
    assert tst.rebuilds == 1
    rng = np.random.default_rng(0)
    Sinv, H, G = tst._pinv
    noise = torch.as_tensor(rng.uniform(-1.0, 1.0, tuple(Sinv.shape)),
                            dtype=Sinv.dtype)
    tst._pinv = (Sinv * (1.0 + 5.0 * noise), H, G)
    _, stale = tst._newton(U1, U1, tbcv, 3.0 * tload, OPTS["max_it"])
    assert stale["stalled"], "damaged factors must stall raw Newton"
    U2, stats = tst.step(U1, tbcv, 3.0 * tload, 2)
    assert tst.rebuilds == 2 and tst._last_rebuild == 2
    assert torch.isfinite(U2).all()
    assert stats["residual"] <= stale["residual"] * (1.0 + 1e-12)
