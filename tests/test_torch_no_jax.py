"""vasp_tpu_torch never imports jax or vasp_tpu (checked in a fresh
interpreter, since this test process has both loaded)."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SLICE = [
    "vasp_tpu_torch", "vasp_tpu_torch.device", "vasp_tpu_torch.convert",
    "vasp_tpu_torch.mesh", "vasp_tpu_torch.mesh.tetmesh",
    "vasp_tpu_torch.mesh.generate", "vasp_tpu_torch.mesh.io",
    "vasp_tpu_torch.mesh.refine", "vasp_tpu_torch.fem",
    "vasp_tpu_torch.fem.shape", "vasp_tpu_torch.fem.quadrature",
    "vasp_tpu_torch.fem.functionspace", "vasp_tpu_torch.fem.dirichlet",
    "vasp_tpu_torch.fem.smallmat", "vasp_tpu_torch.fem.kinematics",
    "vasp_tpu_torch.fem.forms", "vasp_tpu_torch.fem.assembly",
    "vasp_tpu_torch.fem.solver", "vasp_tpu_torch.fem.measures",
    "vasp_tpu_torch.fem.scaling", "vasp_tpu_torch.fem.krylov",
    "vasp_tpu_torch.fem.banded", "vasp_tpu_torch.fem.timestepper",
    "vasp_tpu_torch.native", "vasp_tpu_torch.kernels.build",
    "vasp_tpu_torch.kernels.element", "vasp_tpu_torch.kernels.measures",
    "vasp_tpu_torch.kernels.matvec", "vasp_tpu_torch.kernels.scaling",
    "vasp_tpu_torch.kernels.banded", "vasp_tpu_torch.bcs",
    "vasp_tpu_torch.bcs.waveforms", "vasp_tpu_torch.run.config",
    "vasp_tpu_torch.run.checkpoint", "vasp_tpu_torch.run.output",
    "vasp_tpu_torch.run.metrics", "vasp_tpu_torch.run.system",
    "vasp_tpu_torch.run.driver", "vasp_tpu_torch.models.cylinder",
    "vasp_tpu_torch.mesh.markers", "vasp_tpu_torch.kernels.facet",
    "vasp_tpu_torch.models.waveform_data",
    "vasp_tpu_torch.models.offset_stenosis", "vasp_tpu_torch.models.aneurysm",
    "vasp_tpu_torch.models.predeform", "vasp_tpu_torch.models.avf",
    "vasp_tpu_torch.preprocessing", "vasp_tpu_torch.preprocessing.bifurcation",
    "vasp_tpu_torch.postprocessing",
    "vasp_tpu_torch.postprocessing.mesh_stages",
    "vasp_tpu_torch.postprocessing.common", "vasp_tpu_torch.kernels.postproc",
    "vasp_tpu_torch.postprocessing.fields",
    "vasp_tpu_torch.postprocessing.fields.create_hdf5",
    "vasp_tpu_torch.postprocessing.fields.hemodynamics",
    "vasp_tpu_torch.postprocessing.fields.stress_strain",
    "vasp_tpu_torch.postprocessing.spectral",
    "vasp_tpu_torch.postprocessing.spectral.core",
    "vasp_tpu_torch.postprocessing.spectral.transform",
    "vasp_tpu_torch.postprocessing.spectral.hi_pass_viz",
    "vasp_tpu_torch.postprocessing.spectral.figures",
    "vasp_tpu_torch.postprocessing.spectral.point_trace",
    "vasp_tpu_torch.postprocessing.log_plotter", "vasp_tpu_torch.cli",
    "vasp_tpu_torch.fem.biharmonic", "vasp_tpu_torch.kernels.lifting",
    "vasp_tpu_torch.fem.ras", "vasp_tpu_torch.kernels.ras",
    "vasp_tpu_torch.fem.preconditioner", "vasp_tpu_torch.kernels.schwarz",
    "vasp_tpu_torch.kernels.nodeblock",
]


@pytest.mark.parametrize("forbidden", ["jax", "vasp_tpu", "h5py",
                                       "matplotlib"])
def test_slice_imports_without_jax(forbidden):
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m == {forbidden!r} "
        f"or m.startswith({forbidden + '.'!r}))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_source_mentions_jax_imports():
    """No module of the package has an import statement naming jax or
    vasp_tpu (a lazy import inside a function would escape the check
    above)."""
    bad = []
    for path in (ROOT / "vasp_tpu_torch").rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and \
                    words[1].split(".")[0] in ("jax", "jaxlib", "vasp_tpu"):
                bad.append(f"{path.name}:{n}: {line.strip()}")
    assert not bad
