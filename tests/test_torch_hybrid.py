"""Parity of the port's hybrid-residual Newton (residual_dtype f32f and f32)
with vasp_tpu's IterativeStepper on the small FSI tube under a ramped
interface pressure load.

- The bench configuration (bench.py's StepOptions: f32f residuals, float32
  Jacobians and Krylov space, gmres_tol=1e-3, jac_recompute=2,
  atol=rtol=1e-6), two ramp steps: equal Newton iterations, equal `fine`
  flags, U within 1e-2 relative. The bound: each step converges in one
  inexact Newton iteration whose direction GMRES solves to 1e-3 only, with
  float32 sums in other orders on the two sides, so the two states meet
  only to what atol=1e-6 bounds through the conditioning. Measured 6.0e-6
  on the first step and 9.4e-4 on the second, where each package lies
  3e-3 from a tight float64 solve of the same steps.
- test_endgame_factor_certified of tests/test_iterative_stepper.py with
  residual_dtype="f32" and raw float64 fine residuals (delta_endgame=False,
  the only f32 endgame the port has): converged, the exit certified fine,
  equal iterations, U within 2e-4 of the LU solution (vasp_tpu's bound)."""
import numpy as np
import pytest

from _torch_small_fsi import loaded_pair, run_steps, torch_threads

_threads = torch_threads(2)

BENCH = dict(atol=1e-6, rtol=1e-6, max_it=12, recompute=2, gmres_tol=1e-3,
             gmres_restart=60, gmres_maxiter=120, jac_dtype="f32",
             krylov_dtype="f32", residual_dtype="f32f")


@pytest.fixture(scope="module")
def pair():
    return loaded_pair()


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_bench_configuration_matches_vasp_tpu(pair):
    tst, out = run_steps(pair, BENCH, [1 / 6, 2 / 6])
    for jU, jstats, tU, tstats, _, _ in out:
        assert tstats["iterations"] == int(jstats["iterations"])
        assert tstats["fine"] == bool(jstats["fine"])
        assert tstats["residual"] <= 1e-6
        assert _rel(tU.numpy(), jU) <= 1e-2
    assert tst.rebuilds == 1
    assert all(h["tiers"] == [] for h in tst.history)


def test_endgame_factor_certified(pair):
    (js, jbc, jload, jbcv), (ts, tbc, tload, tbcv) = pair
    opts = dict(atol=1e-6, rtol=1e-6, max_it=10, gmres_tol=1e-3,
                gmres_restart=60, gmres_maxiter=120, jac_dtype="f32",
                krylov_dtype="f32", residual_dtype="f32",
                delta_endgame=False, endgame_factor=3.0)
    _, [(jU, jstats, tU, tstats, _, _)] = run_steps(pair, opts, [1.0])
    assert tstats["residual"] <= 1e-6
    assert tstats["fine"], "exit residual must be f64-certified"
    assert tstats["iterations"] == int(jstats["iterations"])
    assert bool(jstats["fine"])
    U0 = ts.zero_state()
    U_lu, _ = ts.make_solver(tbc).solve(tbc.apply(U0, 0.001), U0, t=0.001,
                                        tstep=1, load=tload)
    a, b = U_lu.numpy(), tU.numpy()
    assert np.allclose(a, b, atol=2e-4 * np.abs(a).max()), (
        np.abs(a - b).max(), np.abs(a).max())
