"""The precision ladder of the port's IterativeStepper.step against
vasp_tpu's on the small FSI tube: f32f at atol=1e-11, under the float32
residual floor, from banded factors damaged before the step (every entry
of Sinv scaled by 1 + 5 u, u uniform in [-1, 1], as tests/
test_iterative_stepper.py injects them), so that every tier is taken for
a reason that does not depend on rounding. The damaged directions make no
progress (every trial state is worse than the start), so the coarse
phase, the fine retry and the exact tier each stall in two iterations,
and the rebuild at the current state lets the exact retry converge. The
same printed tier lines, Newton iterations and final residual as
vasp_tpu, and U within 1e-9 relative (measured 5.3e-13: both end on two
float64 Newton steps with fresh factors).

At the float32 floor itself the residual norm moves by ~15 % from state
to state against the 0.9 stall test, so there the tiers and counts would
depend on rounding (measured: 6 coarse iterations in vasp_tpu, 4 in the
port, at atol 1e-9 without damage)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_small_fsi import damage_sinv, loaded_pair, quiet_step, \
    torch_threads
from vasp_tpu.fem.timestepper import IterativeStepper as JaxStepper
from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def pair():
    return loaded_pair()


def test_ladder_tiers_match_vasp_tpu(pair):
    (js, jbc, jload, jbcv), (ts, tbc, tload, tbcv) = pair
    opts = dict(atol=1e-11, rtol=1e-11, max_it=8, gmres_tol=1e-8,
                gmres_restart=60, gmres_maxiter=60, jac_dtype="f32",
                krylov_dtype="f32", residual_dtype="f32f")
    jst = JaxStepper(js, jbc, JaxOptions(**opts), recompute_tstep=1000)
    tst = IterativeStepper(ts, tbc, StepOptions(**opts),
                           recompute_tstep=1000)
    # factors of the first step's start, damaged before the step
    jU0, tU0 = js.zero_state(), ts.zero_state()
    jst._rebuild(jnp.where(jst.mask, jbcv, jU0), jU0, 1)
    tst._rebuild(torch.where(tst.mask, tbcv, tU0), tU0, 1)
    damage_sinv(jst, tst)
    jU, jstats, jtiers = quiet_step(jst, jU0, jbcv, jload, 1)
    tU, tstats, ttiers = quiet_step(tst, tU0, tbcv, tload, 1)
    tiers = ["fine_retry", "exact", "exact_rebuild"]
    assert jtiers == ttiers == tst.history[-1]["tiers"] == tiers
    assert tstats["iterations"] == int(jstats["iterations"]) == 8
    assert tstats["residual"] <= 1e-11 and tstats["rfine"]
    assert tst.rebuilds == 2
    tU, jU = tU.numpy(), np.asarray(jU)
    assert np.linalg.norm(tU - jU) <= 1e-9 * np.linalg.norm(jU)
