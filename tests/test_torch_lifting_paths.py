"""The lifting and body-force options of the fluid and solid forms through
the driver, on the LU path, the port (device="cpu": the plain versions of
its kernels) against vasp_tpu:

- the tiny cylinder with extrapolation="elastic", p_stab=0.1 and solid
  gravity [0, 0, -9.81] in one run;
- extrapolation="no_extrapolation" in the other, through a problem file
  (one per package, from one template) that wraps -p cylinder and holds
  every fluid-only d dof at 0: without lifting those rows have no
  equation, as in vasp_tpu's fluid-only Poiseuille test.

Each run: the same Newton iteration count per step, U within 1e-8
relative (the LU path's bound; measured 1.7e-12 for the elastic run and
3.5e-13 for the no_extrapolation one, one Newton iteration a step in
each)."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from vasp_tpu_torch.run.driver import run_simulation
from _torch_small_fsi import torch_threads

_threads = torch_threads(2)

OVERRIDES = dict(T=0.002, dt=0.001, mesh_path=None, quadrature_degree=2,
                 save_step=1, checkpoint_step=50, atol=1e-7, rtol=1e-7,
                 recompute=5, recompute_tstep=1, verbose=True)
ELASTIC = dict(extrapolation="elastic", p_stab=0.1, gravity=[0.0, 0.0, -9.81])
# -p cylinder with no mesh lifting and a fixed fluid mesh
NO_LIFT_PROBLEM = '''"""-p cylinder, extrapolation="no_extrapolation", fluid-only d at 0."""
import numpy as np

from {pkg}.fem.dirichlet import DirichletBC
from {pkg}.models.cylinder import (  # noqa: F401
    get_mesh_domain_and_boundaries, post_solve, pre_solve)
from {pkg}.models.cylinder import create_bcs as _create_bcs
from {pkg}.models.cylinder import set_problem_parameters as _parameters


def set_problem_parameters(default_variables, **namespace):
    _parameters(default_variables)
    default_variables.update(extrapolation="no_extrapolation")
    return default_variables


def create_bcs(space, mesh, dx_s_id, **namespace):
    out = _create_bcs(space=space, mesh=mesh, dx_s_id=dx_s_id, **namespace)
    solid = np.unique(space.cell_dofs_p2[mesh.cell_markers == dx_s_id])
    fluid_only = np.setdiff1d(np.arange(space.n_p2), solid)
    out["bcs"].append(DirichletBC(space.field_dofs("d", fluid_only), 0.0))
    return out
'''


def _run(run, problem, folder, **extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run(problem, overrides=dict(OVERRIDES, folder=str(folder),
                                         **extra))
    iters = [json.loads(line)["newton_iterations"] for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return ns, iters


@pytest.fixture(scope="module", params=["elastic", "no_extrapolation"])
def runs(request, tmp_path_factory):
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    label = request.param
    out = []
    for pkg, run, extra in (("vasp_tpu", jax_run_simulation, {}),
                            ("vasp_tpu_torch", run_simulation,
                             dict(device="cpu"))):
        tmp = tmp_path_factory.mktemp(f"{label}_{pkg}")
        if label == "elastic":
            problem, extra = "cylinder", dict(extra, **ELASTIC)
        else:
            problem = tmp / "no_lift_cylinder.py"
            problem.write_text(NO_LIFT_PROBLEM.format(pkg=pkg))
            problem = str(problem)
        out.append(_run(run, problem, tmp / "run", **extra))
    return label, out


def test_run_matches_vasp_tpu(runs):
    label, ((jns, jit), (tns, tit)) = runs
    assert len(tit) == 2 and tit == jit
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64 and torch.isfinite(Ut).all()
    assert np.linalg.norm(Ut.numpy() - Uj) <= 1e-8 * np.linalg.norm(Uj)


def test_options_reach_the_element_kernels(runs):
    label, (_, (tns, _)) = runs
    Ut = tns["dvp_"]["n"]
    kern = {b.kernel.kind: b.kernel for b in tns["assembler"].blocks}
    assert kern["fluid"].lift == label
    if label == "elastic":
        assert kern["fluid"].p_stab == 0.1
        assert kern["solid"].gravity.tolist() == [0.0, 0.0, -9.81]
    else:
        # the fluid-only d rows are held; the interface moves with the wall
        d = tns["space"].split(Ut)[0]
        assert float(d.abs().max()) > 0.0
