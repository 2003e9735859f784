"""The slice as a whole: the port's cylinder run against vasp_tpu's.

Both packages run the cylinder_run configuration of conftest.py on a
smaller generated tube (MESH: the host LU's factorizations take most of
this module's time, and no check depends on the tube's size; the port
with device="cpu", i.e. the plain torch versions of its kernels): the
same Newton iteration count per step, the final U within 1e-8 relative,
the same stdout contract lines, the same output datasets, and a restart
of the port from vasp_tpu's Checkpoint folder."""
import io
import json
import re
from contextlib import redirect_stdout

import h5py
import numpy as np
import pytest
import torch

from vasp_tpu_torch.run import checkpoint as tckpt
from vasp_tpu_torch.run.driver import main, run_simulation
from _torch_small_fsi import torch_threads

_threads = torch_threads(2)

MESH = dict(n_theta=8, n_z=4)
# conftest.py's cylinder_run overrides on MESH
JAX_OVERRIDES = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=3,
                     save_deg=2, save_step=1, checkpoint_step=2, atol=1e-7,
                     rtol=1e-7, recompute=5, recompute_tstep=1, verbose=True,
                     generated_mesh_params=MESH)
OVERRIDES = dict(JAX_OVERRIDES, device="cpu")
CONTRACT = {
    "timestep": r"Solved for timestep (.*), t = (.*) in (.*) s",
    "newton": r"Newton iteration (.*): r \(atol\) = (.*) \(tol = .*\), "
              r"r \(rel\) = (.*) \(tol = .*\)",
    "flow": r"\s*Flow Rate at Inlet: (.*)",
    "velocity": r"\s*Velocity \(mean, min, max\): (.*), (.*), (.*)",
    "cfl": r"\s*CFL \(mean, min, max\): (.*), (.*), (.*)",
    "reynolds": r"\s*Reynolds Numbers \(mean, min, max\): (.*), (.*), (.*)",
}


@pytest.fixture(scope="module")
def cylinder_run(tmp_path_factory):
    """vasp_tpu's run of conftest.py's cylinder_run configuration on MESH:
    (namespace, stdout, folder)."""
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    folder = tmp_path_factory.mktemp("cylinder_jax")
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = jax_run_simulation("cylinder", overrides=dict(
            JAX_OVERRIDES, folder=str(folder)))
    return ns, buf.getvalue(), folder


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("cylinder_torch")
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run_simulation("cylinder",
                            overrides=dict(OVERRIDES, folder=str(folder)))
    return ns, buf.getvalue(), folder


def _iterations(folder):
    return [json.loads(line)["newton_iterations"]
            for line in (folder / "metrics.jsonl").read_text().splitlines()]


def test_newton_iterations_and_state_match(cylinder_run, port_run):
    jns, _, jfolder = cylinder_run
    tns, _, tfolder = port_run
    assert _iterations(tfolder) == _iterations(jfolder)
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64 and Ut.device.type == "cpu"
    assert np.linalg.norm(Ut.numpy() - Uj) <= 1e-8 * np.linalg.norm(Uj)


@pytest.mark.parametrize("line", sorted(CONTRACT))
def test_stdout_contract_lines(cylinder_run, port_run, line):
    jlog, tlog = cylinder_run[1], port_run[1]
    jm = re.findall(CONTRACT[line], jlog)
    tm = re.findall(CONTRACT[line], tlog)
    assert len(tm) == len(jm) > 0
    if line in ("velocity", "cfl", "reynolds", "flow"):
        tv = np.array(tm, dtype=float)
        jv = np.array(jm, dtype=float)
        assert np.all(np.isfinite(tv))
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0)


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj.shape)
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("rel", [
    "Visualization/velocity.h5", "Visualization/displacement.h5",
    "Visualization/pressure.h5", "Checkpoint/checkpoint_d1.h5",
    "Checkpoint/checkpoint_v1.h5", "Checkpoint/checkpoint_p1.h5",
    "Mesh/mesh.h5"])
def test_output_files_match(cylinder_run, port_run, rel):
    jfolder, tfolder = cylinder_run[2], port_run[2]
    assert (tfolder / rel).exists()
    assert _datasets(tfolder / rel) == _datasets(jfolder / rel)
    if rel.endswith("velocity.h5"):
        assert (tfolder / "Visualization" / "velocity.xdmf").read_text() \
            .replace(str(tfolder), "") == \
            (jfolder / "Visualization" / "velocity.xdmf").read_text() \
            .replace(str(jfolder), "")


def test_restart_from_vasp_tpu_checkpoint(cylinder_run, tmp_path):
    """The port reads vasp_tpu's Checkpoint folder as it is; a run
    restarted INTO a copy of vasp_tpu's results folder starts from
    vasp_tpu's final state and appends to its Visualization series."""
    import shutil

    from vasp_tpu_torch.run.output import output_file_lists

    jns, _, jfolder = cylinder_run
    Uj = np.asarray(jns["dvp_"]["n"])
    U, t, tstep = tckpt.load_checkpoint(jfolder, _port_space(jns["mesh"]))
    assert (t, tstep) == (pytest.approx(0.003), 3)
    assert np.linalg.norm(U.numpy() - Uj) <= 1e-12 * np.linalg.norm(Uj)

    work = tmp_path / "restart_inplace"
    shutil.copytree(jfolder, work)
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run_simulation("cylinder", overrides=dict(
            OVERRIDES, T=0.004, folder=str(work), restart_folder=str(work),
            profile_dir=str(tmp_path / "profile")))
    assert re.findall(r"Solved for timestep (\d+),", buf.getvalue()) == ["4"]
    U0 = ns["dvp_"]["n-1"].numpy()
    assert np.linalg.norm(U0 - Uj) <= 1e-12 * np.linalg.norm(Uj)
    assert np.all(np.isfinite(ns["dvp_"]["n"].numpy()))
    h5s, times, _ = output_file_lists(work / "Visualization" /
                                      "velocity.xdmf")
    assert len(times) == 4 and times == sorted(times)
    assert set(h5s) == {"velocity.h5", "velocity_r1.h5"}
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0


def test_console_entry_point_runs_and_exits_clean(tmp_path):
    """main() parses the CLI as vasp-tpu-torch-run does and returns None, so
    the console script exits 0; save_step=0 and checkpoint_step=0 write no
    HDF5 at all."""
    folder = tmp_path / "cli"
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = main(["-p", "cylinder", "-T", "0.001", "-dt", "0.001",
                    "--folder", str(folder), "--new-arguments",
                    "mesh_path=None", "device=cpu", "quadrature_degree=3",
                    "recompute_tstep=1", "save_step=0", "checkpoint_step=0",
                    f"generated_mesh_params={MESH}"])
    assert out is None
    steps = [json.loads(line) for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    assert [s["converged"] for s in steps] == [True]
    assert "Solved for timestep 1, t = 0.0010" in buf.getvalue()
    assert (folder / "run.log").read_text() == buf.getvalue()
    assert not list(folder.rglob("*.h5"))


def _port_space(mesh):
    from vasp_tpu_torch.fem.functionspace import DVPSpace
    from vasp_tpu_torch.mesh.tetmesh import TetMesh

    return DVPSpace(TetMesh(coords=mesh.coords, cells=mesh.cells,
                            cell_markers=mesh.cell_markers,
                            facets=mesh.facets,
                            facet_markers=mesh.facet_markers))
