"""Shared postprocessing utilities.

Counterpart of vasp_tpu.postprocessing.common (reference:
src/vasp/postprocessing/postprocessing_common.py):
- get_domain_ids (L16-60): node-id sets of fluid/solid/all domains,
- output_file_lists (L63-121): map timestep -> (h5 file, time, index) by
  parsing the XDMF time series (restart-split outputs supported),
- read_parameters_from_file (L124-145): Checkpoint/default_variables.json.

vasp_tpu's read_visualization_series has no caller and is not copied.
"""
import json
from pathlib import Path

import numpy as np

from vasp_tpu_torch.mesh.io import read_vasp_mesh
from vasp_tpu_torch.run.output import output_file_lists

__all__ = ["get_domain_ids", "get_domain_ids_refined", "get_interface_ids",
           "output_file_lists", "read_parameters_from_file"]


def get_domain_ids(mesh_path, fluid_domain_id=1, solid_domain_id=2):
    """Return (fluid_ids, solid_ids, all_ids) vertex-id arrays. Accepts
    scalar or list domain ids (reference: postprocessing_common.py:42-50)."""
    mesh = read_vasp_mesh(mesh_path)
    fluid_ids = mesh.domain_vertices(np.atleast_1d(fluid_domain_id))
    solid_ids = mesh.domain_vertices(np.atleast_1d(solid_domain_id))
    all_ids = np.unique(np.concatenate([fluid_ids, solid_ids]))
    return fluid_ids, solid_ids, all_ids


def get_domain_ids_refined(mesh_path, fluid_domain_id=1, solid_domain_id=2):
    """Vertex ids on the refined (save_deg=2) output mesh: original vertices
    plus edge-midpoint nodes (numbered Nn + edge_id by construction)."""
    mesh = read_vasp_mesh(mesh_path)
    out = []
    for dom in (fluid_domain_id, solid_domain_id):
        ids = np.atleast_1d(dom)
        verts = mesh.domain_vertices(ids)
        edges = mesh.num_vertices + mesh.domain_edges(ids)
        out.append(np.concatenate([verts, edges]))
    fluid_ids, solid_ids = out
    all_ids = np.unique(np.concatenate([fluid_ids, solid_ids]))
    return fluid_ids, solid_ids, all_ids


def get_interface_ids(mesh_path, fsi_id=22, refined=False):
    """Vertex ids on the FSI interface (the facet-marker nodes; the
    reference intersects the fluid and solid node sets,
    postprocessing_h5py_common.py:90-121)."""
    mesh = read_vasp_mesh(mesh_path)
    verts = mesh.facet_vertices(np.atleast_1d(fsi_id))
    if not refined:
        return verts
    edges = mesh.num_vertices + mesh.facet_edges(np.atleast_1d(fsi_id))
    return np.concatenate([verts, edges])


def read_parameters_from_file(folder):
    """Read Checkpoint/default_variables.json
    (reference: postprocessing_common.py:124-145)."""
    path = Path(folder) / "Checkpoint" / "default_variables.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)

