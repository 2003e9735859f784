"""Convert visualization output to per-domain solver-readable series.

Counterpart of vasp_tpu.postprocessing.fields.create_hdf5 (host h5py and
numpy; h5py is imported inside the functions). Parity target:
vasp-create-hdf5
(reference: src/vasp/postprocessing/postprocessing_fenics/create_hdf5.py):
reads Visualization/{velocity,displacement} VisualisationVector arrays,
slices fluid / solid (or all) node ids, and writes
Visualization_separate_domain/u.h5 (/velocity/vector_i) and d_solid.h5 or
d.h5 (/displacement/vector_i) with a /time dataset. Node ids follow the
save_deg=2 refined numbering when the run was saved at save_deg=2 (our
refined numbering equals the P2 dof numbering by construction)."""
import logging
from pathlib import Path

import numpy as np

from vasp_tpu_torch.postprocessing.common import (
    get_domain_ids,
    get_domain_ids_refined,
    output_file_lists,
    read_parameters_from_file,
)


def create_hdf5(folder, mesh_path=None, extract_solid_only=True,
                fluid_domain_id=1, solid_domain_id=2, stride=1,
                start_time=None, end_time=None):
    import h5py

    folder = Path(folder)
    viz = folder / "Visualization"
    out_dir = folder / "Visualization_separate_domain"
    out_dir.mkdir(parents=True, exist_ok=True)
    params = read_parameters_from_file(folder) or {}
    save_deg = int(params.get("save_deg", 2))
    if params:
        fluid_domain_id = params.get("dx_f_id", fluid_domain_id)
        solid_domain_id = params.get("dx_s_id", solid_domain_id)
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"

    if save_deg == 2:
        fluid_ids, solid_ids, all_ids = get_domain_ids_refined(
            mesh_path, fluid_domain_id, solid_domain_id
        )
    else:
        fluid_ids, solid_ids, all_ids = get_domain_ids(
            mesh_path, fluid_domain_id, solid_domain_id
        )
    d_ids = solid_ids if extract_solid_only else all_ids
    d_name = "d_solid.h5" if extract_solid_only else "d.h5"

    h5v, times, idxv = output_file_lists(viz / "velocity.xdmf")
    h5d, _, idxd = output_file_lists(viz / "displacement.xdmf")

    sel = slice(None, None, stride)
    steps = list(range(len(times)))[sel]
    if start_time is not None:
        steps = [i for i in steps if times[i] >= start_time]
    if end_time is not None:
        steps = [i for i in steps if times[i] <= end_time]

    with h5py.File(out_dir / "u.h5", "w") as fu, \
         h5py.File(out_dir / d_name, "w") as fd:
        tlist = []
        prev = None
        for k, i in enumerate(steps):
            if k > 0 and abs(times[i] - prev - (times[steps[1]] - times[steps[0]])) > 1e-8:
                logging.warning("WARNING : Uneven temporal spacing detected")
            prev = times[i]
            with h5py.File(viz / h5v[i], "r") as f:
                u = f[f"VisualisationVector/{idxv[i]}"][:]
            with h5py.File(viz / h5d[i], "r") as f:
                d = f[f"VisualisationVector/{idxd[i]}"][:]
            fu.create_dataset(f"velocity/vector_{k}", data=u[fluid_ids])
            fd.create_dataset(f"displacement/vector_{k}", data=d[d_ids])
            tlist.append(times[i])
        fu.create_dataset("time", data=np.asarray(tlist))
        fd.create_dataset("time", data=np.asarray(tlist))
        fu.create_dataset("ids", data=fluid_ids)
        fd.create_dataset("ids", data=d_ids)
    return out_dir / "u.h5", out_dir / d_name


def create_separate_domain_visualization(folder, mesh_path=None,
                                         extract_solid_only=True):
    """u.h5 / d_solid.h5 -> velocity_fluid.{h5,xdmf} +
    displacement_solid.{h5,xdmf} on the separated meshes
    (reference: postprocessing_fenics/create_separate_domain_visualization.py)."""
    import h5py

    from vasp_tpu_torch.mesh.io import read_vasp_mesh
    from vasp_tpu_torch.run.output import VizWriter

    folder = Path(folder)
    sep = folder / "Visualization_separate_domain"
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"
    params = read_parameters_from_file(folder) or {}
    save_deg = int(params.get("save_deg", 2))
    suffix = "_refined" if save_deg == 2 else ""

    outputs = []
    spec = [("u.h5", "velocity", f"mesh_fluid{suffix}.h5", "velocity_fluid")]
    d_file = "d_solid.h5" if extract_solid_only else "d.h5"
    spec.append((d_file, "displacement", f"mesh_solid{suffix}.h5",
                 "displacement_solid"))
    for src_name, key, mesh_name, out_name in spec:
        src = sep / src_name
        submesh_path = mesh_path.with_name(mesh_name)
        if not (src.exists() and submesh_path.exists()):
            continue
        sub = read_vasp_mesh(submesh_path)
        writer = VizWriter(sep, out_name, sub.coords, sub.cells, vector=True)
        with h5py.File(src, "r") as f:
            times = f["time"][:]
            for k, t in enumerate(times):
                writer.write(f[f"{key}/vector_{k}"][:], t)
        outputs.append(sep / f"{out_name}.xdmf")
    return outputs
