"""The slice as a whole: the port's cylinder run on the bench configuration
of the Newton-Krylov path (bench.py's options as config keys:
residual_dtype="f32f", krylov_dtype="f32", gmres_tol=1e-3,
gmres_maxiter=120, jac_recompute=2, atol=rtol=1e-6, max_it=12) against
vasp_tpu's run of the same configuration, on the tube of
test_torch_driver_gmres.py (the port with device="cpu").

Checks: the same Newton iteration count per step and every step
converged; the final U within 5e-3 relative. The bound: each step is one
inexact Newton iteration whose direction GMRES solves to 1e-3 only, with
float32 element work and float32 Krylov sums in other orders on the two
sides, so the two states meet only to what atol=1e-6 bounds through the
conditioning (measured 4.7e-4 on the default tube, n_theta=12, n_z=8)."""
import json

import numpy as np
import pytest
import torch

from _torch_small_fsi import torch_threads
from vasp_tpu_torch.run.driver import run_simulation

_threads = torch_threads(2)

OVERRIDES = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=3,
                 linear_solver="gmres", residual_dtype="f32f",
                 krylov_dtype="f32", gmres_tol=1e-3, gmres_restart=60,
                 gmres_maxiter=120, jac_recompute=2, atol=1e-6, rtol=1e-6,
                 max_it=12, save_step=1, checkpoint_step=50, verbose=False,
                 generated_mesh_params=dict(n_theta=8, n_z=4))


def _run(run_simulation, folder, **extra):
    ns = run_simulation("cylinder", overrides=dict(
        OVERRIDES, folder=str(folder), **extra))
    steps = [json.loads(line) for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return ns, steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    jax_run = _run(jax_run_simulation, tmp_path_factory.mktemp("jax_f32f"))
    port_run = _run(run_simulation, tmp_path_factory.mktemp("port_f32f"),
                    device="cpu")
    return jax_run, port_run


def test_f32f_newton_iterations_and_state_match(runs):
    (jns, jsteps), (tns, tsteps) = runs
    assert [s["newton_iterations"] for s in tsteps] == \
        [s["newton_iterations"] for s in jsteps]
    assert len(tsteps) == 3 and all(s["converged"] for s in tsteps)
    opt = tns["solver"].opt
    assert (opt.residual_dtype, opt.krylov_dtype, opt.recompute,
            opt.gmres_tol) == ("f32f", "f32", 2, 1e-3)
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64
    assert np.linalg.norm(Ut.numpy() - Uj) <= 5e-3 * np.linalg.norm(Uj)
