"""Mesh postprocessing stages of a results folder: refine, separate,
predeform.

Counterpart of vasp_tpu.postprocessing.mesh_stages:
- vasp-tpu-torch-refine-mesh (reference: postprocessing_mesh/
  create_refined_mesh.py): uniform refinement whose node numbering matches
  the solver's save_deg=2 output (by construction: refined node i == P2
  dof i); refined cells = 8 x cells;
- vasp-tpu-torch-separate-mesh (reference: postprocessing_mesh/
  separate_mesh.py): fluid/solid submesh extraction with compact node
  renumbering, also for the refined variants, the original->compact vertex
  map stored in '/map/vertex_ids';
- vasp-tpu-torch-predeform-mesh (reference: postprocessing/
  predeform_mesh.py): add the final displacement x scale_factor (default
  -1) to all mesh coordinate arrays -> mesh_predeformed.h5, the geometry of
  the prestress chain's production run (predeform run -> this stage -> the
  run on the predeformed mesh).

h5py is imported inside the functions, so the module imports on a host
without it.
"""
from pathlib import Path

import numpy as np

from vasp_tpu_torch.mesh.io import read_vasp_mesh, write_vasp_mesh
from vasp_tpu_torch.mesh.refine import refine_uniform
from vasp_tpu_torch.mesh.tetmesh import TetMesh
from vasp_tpu_torch.run.output import output_file_lists


def create_refined_mesh(folder, mesh_path=None):
    """<folder>'s mesh -> mesh_refined.h5 (save_deg=2 node ordering)."""
    folder = Path(folder)
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"
    mesh = read_vasp_mesh(mesh_path)
    refined = refine_uniform(mesh)
    out = mesh_path.with_name(mesh_path.stem + "_refined.h5")
    write_vasp_mesh(out, refined, all_facets=False)
    return out


def _extract_submesh(mesh, cell_marker_ids):
    sel = np.isin(mesh.cell_markers, np.atleast_1d(cell_marker_ids))
    cells = mesh.cells[sel]
    verts = np.unique(cells)
    remap = -np.ones(mesh.num_vertices, np.int64)
    remap[verts] = np.arange(len(verts))
    new_cells = remap[cells]
    sub = TetMesh(mesh.coords[verts], new_cells,
                  mesh.cell_markers[sel])
    return sub, verts


def separate_mesh(folder, mesh_path=None, fluid_domain_id=1,
                  solid_domain_id=2):
    """mesh.h5 -> mesh_fluid.h5 + mesh_solid.h5 (+ refined variants when
    mesh_refined.h5 exists), compact numbering + vertex map."""
    import h5py

    folder = Path(folder)
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"
    outputs = []
    for path in [mesh_path,
                 mesh_path.with_name(mesh_path.stem + "_refined.h5")]:
        if not path.exists():
            continue
        mesh = read_vasp_mesh(path)
        for name, ids in (("fluid", fluid_domain_id),
                          ("solid", solid_domain_id)):
            sub, verts = _extract_submesh(mesh, ids)
            suffix = "_refined" if path.stem.endswith("_refined") else ""
            out = path.with_name(
                path.stem.replace("_refined", "") + f"_{name}{suffix}.h5"
            )
            write_vasp_mesh(out, sub, all_facets=False)
            with h5py.File(out, "a") as f:
                f.create_dataset("map/vertex_ids", data=verts)
            outputs.append(out)
    return outputs


def predeform_mesh(folder, mesh_path=None, scale_factor=-1.0):
    """Apply the last displacement step (scaled) to the mesh coordinates ->
    mesh_predeformed.h5 beside the mesh (reference: predeform_mesh.py:33-67).
    The run must have written its displacement series at save_deg=1 (the
    vertex values). Returns the output path."""
    import h5py

    folder = Path(folder)
    viz = folder / "Visualization"
    mesh_path = Path(mesh_path) if mesh_path else folder / "Mesh" / "mesh.h5"
    h5s, times, idxs = output_file_lists(viz / "displacement.xdmf")
    with h5py.File(viz / h5s[-1], "r") as f:
        disp = f[f"VisualisationVector/{idxs[-1]}"][:]
    out = mesh_path.with_name(mesh_path.stem + "_predeformed.h5")
    with h5py.File(mesh_path, "r") as src, h5py.File(out, "w") as dst:
        src.copy("mesh", dst)
        if "domains" in src:
            src.copy("domains", dst)
        if "boundaries" in src:
            src.copy("boundaries", dst)
        for grp in ("mesh", "domains", "boundaries"):
            if grp in dst:
                coords = dst[f"{grp}/coordinates"][:]
                n = coords.shape[0]
                coords += disp[:n] * scale_factor
                dst[f"{grp}/coordinates"][...] = coords
    return out
