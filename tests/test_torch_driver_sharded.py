"""The sharded path end to end: vasp-tpu-torch-run -p cylinder with
--n-devices 2 (device=cpu, dist_backend=gloo), started as the console
script starts it (driver.main spawns the two ranks), against vasp_tpu's
run_simulation with n_devices=2 (its ShardedBandedStepper on 2 of the
virtual CPU devices of tests/conftest.py).

Both runs take tests/test_torch_driver_gmres.py's tiny cylinder
(linear_solver="gmres"). Checks: the same Newton iterations per step;
the final U (read from each run's checkpoint files) within 3e-5 relative,
that test's bound (one inexact Newton step a time step, its direction
solved to gmres_tol = 1e-6, the two packages' float32 Jacobians rounded
differently); rank 0 alone writing metrics.jsonl and the log contract."""
import json

import h5py
import numpy as np
import pytest

from _torch_dist import in_thread
from _torch_small_fsi import torch_threads

_threads = torch_threads(2)

OVERRIDES = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=3,
                 atol=1e-7, rtol=1e-7, linear_solver="gmres", save_step=1,
                 checkpoint_step=50, verbose=True,
                 generated_mesh_params=dict(n_theta=8, n_z=4))


def _final_state(folder):
    parts = []
    for name, key in (("d", "displacement"), ("v", "velocity"),
                      ("p", "pressure")):
        with h5py.File(folder / "Checkpoint" / f"checkpoint_{name}1.h5",
                       "r") as f:
            parts.append(np.asarray(f[f"{key}/vector_0"][:]).ravel())
            tstep = int(f.attrs["tstep"])
    return np.concatenate(parts), tstep


def _iterations(folder):
    return [json.loads(line)["newton_iterations"] for line in
            (folder / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import io
    from contextlib import redirect_stdout

    from vasp_tpu.run.driver import run_simulation as jax_run_simulation
    from vasp_tpu_torch.run.driver import main

    # the port's ranks run while vasp_tpu's run does
    tfolder = tmp_path_factory.mktemp("port_sharded")
    args = [f"{k}={v}" for k, v in OVERRIDES.items()
            if k not in ("T", "dt")]
    port = in_thread(main, ["-p", "cylinder", "-T", "0.003", "-dt", "0.001",
                            "--folder", str(tfolder), "--n-devices", "2",
                            "--new-arguments", *args, "save_step=0",
                            "device=cpu", "dist_backend=gloo"])
    jfolder = tmp_path_factory.mktemp("jax_sharded")
    with redirect_stdout(io.StringIO()):
        jax_run_simulation("cylinder", overrides=dict(
            OVERRIDES, folder=str(jfolder), n_devices=2))
    assert port() is None
    return jfolder, tfolder


def test_newton_iterations_and_state_match(runs):
    jfolder, tfolder = runs
    jit, tit = _iterations(jfolder), _iterations(tfolder)
    assert len(tit) == 3 and tit == jit
    (Uj, jstep), (Ut, tstep) = _final_state(jfolder), _final_state(tfolder)
    assert jstep == tstep == 3
    assert np.isfinite(Ut).all()
    assert np.linalg.norm(Ut - Uj) <= 3e-5 * np.linalg.norm(Uj)


def test_rank_zero_alone_writes(runs):
    """One metrics line and one contract line per step (two ranks ran
    every step), and no Visualization series (save_step=0)."""
    _, tfolder = runs
    log = (tfolder / "run.log").read_text()
    assert log.count("Solved for timestep") == 3
    assert log.count("Newton iteration") == 3
    assert log.count("sharded banded preconditioner (chain): 2 ranks") == 1
    assert not (tfolder / "Visualization").exists()
