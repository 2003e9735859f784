"""The slice as a whole: the port's predeform run (theta=1 backward Euler,
Newton damping lmbda=0.5, the Mooney-Rivlin wall, the Robin term, the FSI
sphere), its predeformed mesh and the re-inflation on that mesh, against
vasp_tpu's, on the LU path, on the tiny predeform of
tests/test_driver_predeform.py (the port with device="cpu", i.e. the plain
torch versions of its kernels).

Checks and tolerances:
- the predeform run: the same Newton iteration count per step; the final U
  within 1e-8 relative (both are float64 Newton on the same host LU, with
  sums in other orders); the printed pressure and flow lines within 1e-6
  relative;
- the predeformed mesh files (each package's own stage on its own run):
  the same groups, cells and markers, coordinates within 1e-12 m of
  vasp_tpu's, and the port's coordinates equal to its mesh minus its
  final vertex displacement (1e-12 m, as tests/test_driver_predeform.py
  holds vasp_tpu's);
- the re-inflation on each package's own predeformed mesh (2 steps, cut
  from the test's 3 to bound the test time; the first step is the
  pressure-free one): the same Newton counts, and U within 1e-8
  relative, the bound of the first run. The two meshes differ by the
  first runs' displacement difference (about 1e-14 m), and
  tests/test_driver_predeform.py documents that this inflation's Newton
  slack at atol 5e-5 can map a geometry change to a far larger change of
  U (1e-6 of geometry moved U by O(1) there); at 1e-14 m it does not:
  measured 2.1e-11 relative.
"""
import io
import json
import re
from contextlib import redirect_stdout

import h5py
import numpy as np
import pytest
import torch

from _torch_small_fsi import canonical_entities, torch_threads
from vasp_tpu_torch.postprocessing.mesh_stages import predeform_mesh
from vasp_tpu_torch.run.driver import run_simulation

_threads = torch_threads(2)

# tests/test_driver_predeform.py's overrides, HDF5 output kept for the
# mesh stage
OVERRIDES = dict(
    T=0.03, dt=0.01, mesh_path=None, quadrature_degree=2, save_deg=1,
    save_step=1, checkpoint_step=3, atol=5e-5, rtol=1e-4,
    raise_on_fail=False, recompute=1, recompute_tstep=1,
    t_start_v=0.0, t_end_v=0.01, t_start_p=0.01, t_end_p=0.05,
    v_max_final=0.05, P_final=400.0, verbose=True,
    generated_mesh_params=dict(n_theta=8, n_z=4))
REINFLATE = dict(OVERRIDES, T=0.02)
LINES = {
    "pressure": r"^P = (.*) Pa$",
    "flow": r"\s*Flow Rate at Inlet: (.*)",
    "velocity": r"\s*Velocity \(mean, min, max\): (.*), (.*), (.*)",
    "reynolds": r"\s*Reynolds Numbers \(mean, min, max\): (.*), (.*), (.*)",
}


def _run(run, folder, **extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run("predeform", overrides=dict(OVERRIDES, folder=str(folder),
                                             **extra))
    iters = [json.loads(line)["newton_iterations"] for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return ns, buf.getvalue(), folder, iters


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per package: the predeform run, its predeformed mesh file and the
    re-inflation on it."""
    from vasp_tpu.postprocessing.mesh_stages import \
        predeform_mesh as jax_predeform_mesh
    from vasp_tpu.run.driver import run_simulation as jax_run_simulation

    out = []
    for run, stage, tag, extra in (
            (jax_run_simulation, jax_predeform_mesh, "jax", {}),
            (run_simulation, predeform_mesh, "port", dict(device="cpu"))):
        first = _run(run, tmp_path_factory.mktemp(f"{tag}_predeform"),
                     **extra)
        pre = stage(first[2])
        chain = _run(run, first[2] / "reinflate",
                     **dict(REINFLATE, mesh_path=str(pre), **extra))
        out.append((first, pre, chain))
    return out


def test_newton_iterations_and_state_match(runs):
    ((jns, _, _, jit), _, _), ((tns, _, _, tit), _, _) = runs
    assert tit == jit and len(tit) == 3
    assert tns["cfg"]["theta"] == 1.0 and tns["cfg"]["lmbda"] == 0.5
    solid = [b for b in tns["assembler"].blocks if b.name.startswith("solid")]
    assert [b.kernel.props["material_model"] for b in solid] \
        == ["MooneyRivlin"]
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"]
    assert Ut.dtype == torch.float64 and Ut.device.type == "cpu"
    assert np.linalg.norm(Ut.numpy() - Uj) <= 1e-8 * np.linalg.norm(Uj)


@pytest.mark.parametrize("line", sorted(LINES))
def test_printed_lines_match(runs, line):
    jlog, tlog = runs[0][0][1], runs[1][0][1]
    jm = np.array(re.findall(LINES[line], jlog, re.M), dtype=float)
    tm = np.array(re.findall(LINES[line], tlog, re.M), dtype=float)
    assert tm.shape == jm.shape and len(tm) >= 3
    assert np.all(np.isfinite(tm))
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)


def test_predeformed_mesh_matches_vasp_tpu(runs):
    (_, jpre, _), ((tns, _, tfolder, _), tpre, _) = runs
    assert tpre == tfolder / "Mesh" / "mesh_predeformed.h5"
    with h5py.File(jpre) as g, h5py.File(tpre) as f, \
            h5py.File(tfolder / "Mesh" / "mesh.h5") as src:
        assert sorted(f) == sorted(g) == sorted(src)
        d = tns["space"].split(tns["dvp_"]["n"])[0].numpy()
        for grp in f:
            assert sorted(f[grp]) == sorted(g[grp])
            x = f[grp]["coordinates"][:]
            assert np.abs(x - g[grp]["coordinates"][:]).max() <= 1e-12
            orig = src[grp]["coordinates"][:]
            assert np.abs(x - (orig - d[:len(orig)])).max() <= 1e-12
            assert not np.allclose(x, orig)
            np.testing.assert_array_equal(_entities(f[grp]),
                                          _entities(g[grp]))


def _entities(grp):
    """A mesh file group's cells or facets with their markers."""
    return canonical_entities(grp["topology"][:], grp["values"][:]
                              if "values" in grp else None)


def test_reinflation_matches_vasp_tpu(runs):
    (_, _, (jns, jlog, _, jit)), (_, _, (tns, tlog, _, tit)) = runs
    assert tit == jit and len(tit) == 2
    assert tlog.count("Solved for timestep") == 2
    Uj = np.asarray(jns["dvp_"]["n"])
    Ut = tns["dvp_"]["n"].numpy()
    assert np.all(np.isfinite(Ut))
    assert np.linalg.norm(Ut - Uj) <= 1e-8 * np.linalg.norm(Uj)
    # the wall inflates outward on the predeformed geometry
    sp = tns["space"]
    iface = sp.p2_dofs_on_facets(22)
    xy = sp.p2_coords[iface][:, :2]
    rhat = xy / np.linalg.norm(xy, axis=1, keepdims=True)
    d1 = sp.split(Ut)[0]
    assert np.einsum("ki,ki->k", d1[iface][:, :2], rhat).mean() > 0
