"""The slice as a whole: the port's offset-stenosis run (Womersley inflow,
pulsatile interface pressure, the FSI sphere and the two-viscosity remark,
fluid and solid probes) against vasp_tpu's, on the LU path, on the tiny
stenosis of tests/test_driver_stenosis.py (the port with device="cpu",
i.e. the plain torch versions of its kernels).

Checks: the same Newton iteration count per step; the final U within 1e-8
relative (float64 Newton on the same host LU on both sides, with sums in
other orders); the same re-marked mesh; the printed probe, flow and
minimum-Jacobian lines within 1e-6 relative; the waveform lines."""
import io
import json
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from _torch_small_fsi import torch_threads
from vasp_tpu_torch.run.driver import run_simulation

_threads = torch_threads(2)

OVERRIDES = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=2,
                 save_deg=1, save_step=1, checkpoint_step=10, atol=1e-6,
                 rtol=1e-6, recompute=5, recompute_tstep=1,
                 fsi_region=[0.0, 0.0, 0.012, 0.01],
                 generated_mesh_params=dict(n_theta=8, n_z=10), verbose=True)
LINES = {
    "probe_velocity": r"Probe Point \d+: Velocity: \((.*), (.*), (.*)\) \| "
                      r"Pressure: (.*)",
    "probe_displacement": r"Probe Point \d+: Displacement: \((.*), (.*), "
                          r"(.*)\)",
    "flow": r"\s*Flow Rate at Inlet: (.*)",
    "velocity": r"\s*Velocity \(mean, min, max\): (.*), (.*), (.*)",
    "cfl": r"\s*CFL \(mean, min, max\): (.*), (.*), (.*)",
    "reynolds": r"\s*Reynolds Numbers \(mean, min, max\): (.*), (.*), (.*)",
    "minimum_jacobian": r"Minimum Jacobian: (.*)",
    "ramp_factor": r"ramp_factor = (.*) m\^3/s",
    "interface_stress": r"Instantaneous normal stress prescribed at the FSI "
                        r"interface (.*) Pa",
}


def _run(run, folder, **extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run("offset_stenosis",
                 overrides=dict(OVERRIDES, folder=str(folder), **extra))
    iters = [json.loads(line)["newton_iterations"] for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return ns, buf.getvalue(), iters


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    return (_run(jax_run_simulation, tmp_path_factory.mktemp("jax_stenosis")),
            _run(run_simulation, tmp_path_factory.mktemp("port_stenosis"),
                 device="cpu"))


def test_newton_iterations_and_state_match(runs):
    (jns, _, jit), (tns, _, tit) = runs
    assert tit == jit and len(tit) == 3
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64 and Ut.device.type == "cpu"
    assert np.linalg.norm(Ut.numpy() - Uj) <= 1e-8 * np.linalg.norm(Uj)


def test_remarked_mesh_matches(runs):
    """The FSI sphere and the two-viscosity remark give vasp_tpu's
    markers, and the two fluid zones' properties reach the system."""
    (jns, _, _), (tns, _, _) = runs
    jm, tm = jns["mesh"], tns["mesh"]
    # the two packages list the marked facets in other orders
    jf, tf = (_by_facet(m) for m in (jm, tm))
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tm.cell_markers, jm.cell_markers)
    assert (tm.facet_markers == 22).any() and (tm.facet_markers == 11).any()
    assert tns["system"].fluid_props == jns["system"].fluid_props


def _by_facet(mesh):
    """(sorted vertex triple, marker) rows of the marked facets, in
    lexicographic order."""
    rows = np.concatenate([np.sort(mesh.facets, axis=1),
                           mesh.facet_markers[:, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("line", sorted(LINES))
def test_printed_lines_match(runs, line):
    jlog, tlog = runs[0][1], runs[1][1]
    jm = np.array(re.findall(LINES[line], jlog), dtype=float)
    tm = np.array(re.findall(LINES[line], tlog), dtype=float)
    assert tm.shape == jm.shape and len(tm) >= 3
    assert np.all(np.isfinite(tm))
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
