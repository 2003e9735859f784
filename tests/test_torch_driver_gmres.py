"""The slice as a whole: the port's cylinder run on the Newton-Krylov path
(linear_solver="gmres": banded preconditioner, float32 Jacobians, float64
GMRES and residual) against vasp_tpu's run of the same configuration.

Both packages run the tiny cylinder of conftest.py's cylinder_run with
linear_solver="gmres" (the port with device="cpu", i.e. the plain torch
versions of its kernels). vasp_tpu writes its output files (its driver
divides by save_step and checkpoint_step, so neither can be 0 there).

Checks: the same Newton iteration count per step (no step takes more
than 8 iterations, so vasp_tpu's dispatch chunking changes nothing); the
final U within 3e-5 relative; the stdout contract lines, their flow and
velocity values within 3e-4 relative (ten times what was measured). The bound on U: each step here
converges in one Newton iteration, so the step's state is one inexact
Newton update whose direction GMRES solves only to gmres_tol = 1e-6
relative, and the two packages' float32 Jacobians and factors round
differently (vasp_tpu computes Jacobians in float32 arithmetic, the port
rounds float64 ones once). Measured 3.0e-6 on U and 3.1e-5 on the
velocity extremes."""
import io
import json
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from vasp_tpu_torch.run.driver import main, run_simulation
from _torch_small_fsi import torch_threads

_threads = torch_threads(2)

OVERRIDES = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=3,
                 atol=1e-7, rtol=1e-7, linear_solver="gmres", save_step=1,
                 checkpoint_step=50, verbose=True)
CONTRACT = {
    "timestep": r"Solved for timestep (.*), t = (.*) in (.*) s",
    "newton": r"Newton iteration (.*): r \(atol\) = (.*) \(tol = .*\), "
              r"r \(rel\) = (.*) \(tol = .*\)",
    "flow": r"\s*Flow Rate at Inlet: (.*)",
    "velocity": r"\s*Velocity \(mean, min, max\): (.*), (.*), (.*)",
}


def _run(run_simulation, folder, **extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run_simulation("cylinder", overrides=dict(
            OVERRIDES, folder=str(folder), **extra))
    iters = [json.loads(line)["newton_iterations"] for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return ns, buf.getvalue(), iters


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    jax_run = _run(jax_run_simulation, tmp_path_factory.mktemp("jax_gmres"))
    port_run = _run(run_simulation, tmp_path_factory.mktemp("port_gmres"),
                    device="cpu")
    return jax_run, port_run


def test_newton_iterations_and_state_match(runs):
    (jns, _, jit), (tns, _, tit) = runs
    assert len(tit) == 3 and tit == jit
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64 and Ut.device.type == "cpu"
    assert np.linalg.norm(Ut.numpy() - Uj) <= 3e-5 * np.linalg.norm(Uj)
    # one rebuild: recompute_tstep=20 for the cylinder
    assert tns["solver"].rebuilds == 1


@pytest.mark.parametrize("line", sorted(CONTRACT))
def test_stdout_contract_lines(runs, line):
    (_, jlog, _), (_, tlog, _) = runs
    jm = re.findall(CONTRACT[line], jlog)
    tm = re.findall(CONTRACT[line], tlog)
    assert len(tm) == len(jm) == 3
    if line in ("flow", "velocity"):
        np.testing.assert_allclose(np.array(tm, dtype=float),
                                   np.array(jm, dtype=float), rtol=3e-4,
                                   atol=1e-12)


def test_console_entry_point_runs_gmres(tmp_path):
    """vasp-tpu-torch-run -p cylinder with linear_solver=gmres on the CPU."""
    folder = tmp_path / "cli"
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = main(["-p", "cylinder", "-T", "0.001", "-dt", "0.001",
                    "--folder", str(folder), "--new-arguments",
                    "mesh_path=None", "device=cpu", "quadrature_degree=3",
                    "linear_solver=gmres", "save_step=0",
                    "checkpoint_step=0"])
    assert out is None
    steps = [json.loads(line) for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    assert [s["converged"] for s in steps] == [True]
    assert "Solved for timestep 1, t = 0.0010" in buf.getvalue()
