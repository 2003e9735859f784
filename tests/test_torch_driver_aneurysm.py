"""The slice as a whole: the port's aneurysm run (Womersley inflow,
pulsatile interface pressure, the Robin term on the outer wall, probes and
mean fields) against vasp_tpu's, on the LU path, on the tiny aneurysm of
tests/test_driver_aneurysm.py (the port with device="cpu", i.e. the plain
torch versions of its kernels).

Checks: the same Newton iteration count per step; the final U within 1e-8
relative (both are float64 Newton on the same host LU, converged to atol
1e-6, with sums in other orders); the printed probe, flow and
minimum-Jacobian lines within 1e-6 relative; the mean-field files as
tests/test_driver_aneurysm.py checks vasp_tpu's."""
import io
import json
import re
from contextlib import redirect_stdout

import h5py
import numpy as np
import pytest
import torch

from _torch_small_fsi import torch_threads
from vasp_tpu_torch.fem.assembly import FacetBlock
from vasp_tpu_torch.run.driver import run_simulation

_threads = torch_threads(2)

OVERRIDES = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=2,
                 save_deg=1, save_step=1, checkpoint_step=10, atol=1e-6,
                 rtol=1e-6, recompute=5, recompute_tstep=1,
                 save_solution_after_tstep=2,
                 generated_mesh_params=dict(n_theta=8, n_z=8), verbose=True)
# the printed lines held within 1e-6 relative: (regex, number of groups)
LINES = {
    "probe_velocity": r"Probe Point \d+: Velocity: \((.*), (.*), (.*)\) \| "
                      r"Pressure: (.*)",
    "flow": r"\s*Flow Rate at Inlet: (.*)",
    "velocity": r"\s*Velocity \(mean, min, max\): (.*), (.*), (.*)",
    "cfl": r"\s*CFL \(mean, min, max\): (.*), (.*), (.*)",
    "reynolds": r"\s*Reynolds Numbers \(mean, min, max\): (.*), (.*), (.*)",
    "minimum_jacobian": r"Minimum Jacobian: (.*)",
}


def _run(run, folder, **extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run("aneurysm", overrides=dict(OVERRIDES, folder=str(folder),
                                            **extra))
    iters = [json.loads(line)["newton_iterations"] for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return ns, buf.getvalue(), folder, iters


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    return (_run(jax_run_simulation, tmp_path_factory.mktemp("jax_aneurysm")),
            _run(run_simulation, tmp_path_factory.mktemp("port_aneurysm"),
                 device="cpu"))


def test_newton_iterations_and_state_match(runs):
    (jns, _, _, jit), (tns, _, _, tit) = runs
    assert tit == jit and len(tit) == 3
    robin = [b for b in tns["system"].assembler.blocks
             if isinstance(b, FacetBlock)]
    assert [b.name for b in robin] == ["robin_33"]
    assert robin[0].dofs.shape[1] == 36
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64 and Ut.device.type == "cpu"
    assert np.linalg.norm(Ut.numpy() - Uj) <= 1e-8 * np.linalg.norm(Uj)


@pytest.mark.parametrize("line", sorted(LINES))
def test_printed_lines_match(runs, line):
    jlog, tlog = runs[0][1], runs[1][1]
    jm = np.array(re.findall(LINES[line], jlog), dtype=float)
    tm = np.array(re.findall(LINES[line], tlog), dtype=float)
    assert tm.shape == jm.shape and len(tm) >= 3
    assert np.all(np.isfinite(tm))
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)


def test_mean_fields_match(runs):
    """post_solve accumulates means after save_solution_after_tstep and
    finished() writes them in the write_checkpoint layout
    (tests/test_driver_aneurysm.py), the same fields as vasp_tpu's."""
    from vasp_tpu_torch.run.output import output_file_lists

    (jns, _, jfolder, _), (tns, _, tfolder, _) = runs
    assert tns["mean_count"] == jns["mean_count"] == 2  # steps 2 and 3
    for name in ("d_mean", "u_mean", "p_mean"):
        path = tfolder / "Visualization" / f"{name}.h5"
        h5s, times, idxs = output_file_lists(
            tfolder / "Visualization" / f"{name}.xdmf")
        assert h5s == [f"{name}.h5"] and idxs == [0]
        with h5py.File(path) as f, \
                h5py.File(jfolder / "Visualization" / f"{name}.h5") as g:
            key = f"{name}/{name}_0"
            arr = f[f"{key}/vector"][:]
            assert np.all(np.isfinite(arr))
            np.testing.assert_array_equal(f[f"{key}/cell_dofs"][:],
                                          g[f"{key}/cell_dofs"][:])
            ref = g[f"{key}/vector"][:]
            assert np.linalg.norm(arr - ref) <= 1e-8 * np.linalg.norm(ref)
    with h5py.File(tfolder / "Visualization" / "u_mean.h5") as f:
        assert np.abs(f["u_mean/u_mean_0/vector"][:]).max() > 0
