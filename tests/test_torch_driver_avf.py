"""The slice as a whole: the port's AVF (the generated Y mesh, two
Mooney-Rivlin walls with their own constants, two inlets with the synthetic
patient series, list-valued ids, the Robin term) against vasp_tpu's.

- The generated mesh, at the tiny size below and at the 22,656-cell size
  chip_smoke.py runs: the port's is vasp_tpu's. vasp_tpu's TetMesh builds
  its facet tables with its native library where that loads, and the
  Y mesher extrudes the wall from them, so its cells and facets come in
  another order and its coordinates differ in the last bits of the wall's
  normal sums. Checks: with vasp_tpu's numpy facet tables (the port's)
  every array is equal; with its native ones, the same cells and facets
  with the same markers, and coordinates within 1e-15 m.
- The run on the LU path, the tiny AVF of tests/test_driver_avf.py cut to
  bound the test time (2 steps instead of 3, n_z=4 instead of 8: 1,536
  cells; the first step ramps the inflow, the second the pressure too):
  the same Newton iteration counts; the final U within 1e-8 relative
  (both float64 Newton on the same host LU, with sums in other orders);
  the printed probe, flow and minimum-Jacobian lines within 1e-6
  relative."""
import io
import json
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from _torch_small_fsi import canonical_entities, torch_threads
from vasp_tpu_torch.run.config import default_variables
from vasp_tpu_torch.run.driver import run_simulation

_threads = torch_threads(2)

OVERRIDES = dict(T=0.0002, dt=0.0001, mesh_path=None, patient_data_path=None,
                 quadrature_degree=2, save_deg=1, save_step=1,
                 checkpoint_step=10, atol=1e-6, rtol=1e-6, recompute=5,
                 recompute_tstep=1, vel_t_ramp=0.0002,
                 p_t_ramp_start=0.0001, p_t_ramp_end=0.0003,
                 generated_mesh_params=dict(n_theta=8, n_z=4), verbose=True)
LINES = {
    "probe_velocity": r"Probe Point \d+: Velocity: \((.*), (.*), (.*)\) \| "
                      r"Pressure: (.*)",
    "flow": r"\s*Flow Rate at Inlet: (.*)",
    "velocity": r"\s*Velocity \(mean, min, max\): (.*), (.*), (.*)",
    "minimum_jacobian": r"Minimum Jacobian: (.*)",
}


@pytest.mark.parametrize("params", [
    dict(n_theta=8, n_z=4), dict(m=8, n_parent=16, n_daughter=20)],
    ids=["tiny", "chip"])
def test_generated_mesh_matches_vasp_tpu(params, monkeypatch):
    from vasp_tpu import native
    from vasp_tpu.models import avf as javf
    from vasp_tpu_torch.models import avf as tavf

    cfg = tavf.set_problem_parameters(default_variables())
    cfg.update(mesh_path=None, generated_mesh_params=params)
    tm = tavf.get_mesh_domain_and_boundaries(**cfg)
    jm = javf.get_mesh_domain_and_boundaries(**cfg)
    assert np.abs(tm.coords - jm.coords).max() <= 1e-15
    for rows, markers in (("cells", "cell_markers"),
                          ("facets", "facet_markers")):
        np.testing.assert_array_equal(
            canonical_entities(getattr(tm, rows), getattr(tm, markers)),
            canonical_entities(getattr(jm, rows), getattr(jm, markers)))
    monkeypatch.setattr(native, "build_facets", lambda *a: None)
    jm = javf.get_mesh_domain_and_boundaries(**cfg)
    for key in ("coords", "cells", "cell_markers", "facets",
                "facet_markers"):
        np.testing.assert_array_equal(getattr(tm, key), getattr(jm, key))
    assert {1, 2, 1002} == set(np.unique(tm.cell_markers).tolist())
    if "m" in params:
        assert tm.num_cells == 22656


def _run(run, folder, **extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run("avf", overrides=dict(OVERRIDES, folder=str(folder),
                                       **extra))
    iters = [json.loads(line)["newton_iterations"] for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return ns, buf.getvalue(), iters


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    return (_run(jax_run_simulation, tmp_path_factory.mktemp("jax_avf")),
            _run(run_simulation, tmp_path_factory.mktemp("port_avf"),
                 device="cpu"))


def test_newton_iterations_and_state_match(runs):
    (jns, _, jit), (tns, _, tit) = runs
    assert tit == jit and len(tit) == 2
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64 and Ut.device.type == "cpu"
    assert np.linalg.norm(Ut.numpy() - Uj) <= 1e-8 * np.linalg.norm(Uj)


def test_blocks_carry_both_walls(runs):
    """Two Mooney-Rivlin solid blocks with their own constants, and a Robin
    block per outer-wall marker, as vasp_tpu builds them."""
    (jns, _, _), (tns, _, _) = runs
    tb, jb = tns["assembler"].blocks, jns["assembler"].blocks
    assert [b.name for b in tb] == [b.name for b in jb] == [
        "fluid_1", "solid_2", "solid_1002", "robin_33", "robin_1033"]
    assert [(b.kernel.props["material_model"], b.kernel.props["C11"])
            for b in tb[1:3]] == [("MooneyRivlin", 2.2e6),
                                  ("MooneyRivlin", 0.538e6)]
    for t, j in zip(tb, jb):
        assert t.dofs.shape == tuple(np.asarray(j.dofs).shape)


@pytest.mark.parametrize("line", sorted(LINES))
def test_printed_lines_match(runs, line):
    jlog, tlog = runs[0][1], runs[1][1]
    jm = np.array(re.findall(LINES[line], jlog), dtype=float)
    tm = np.array(re.findall(LINES[line], tlog), dtype=float)
    assert tm.shape == jm.shape and len(tm) >= 2
    assert np.all(np.isfinite(tm))
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
