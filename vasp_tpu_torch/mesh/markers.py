"""Marker remapping utilities (host-side, return new TetMesh instances).

Counterpart of vasp_tpu.mesh.markers, the same numpy code. Covers the
reference's get_mesh_domain_and_boundaries mutations:
- restrict the FSI region to a sphere, re-marking fsi/outer facets outside
  it as rigid (reference: src/vasp/simulations/offset_stenosis.py:98-112,
  predeform.py:95-120, avf.py:109-138),
- re-mark fluid cells by a spatial predicate (two-viscosity zones,
  reference: offset_stenosis.py:129-138)."""
import numpy as np

from vasp_tpu_torch.mesh.tetmesh import TetMesh


def _with_markers(mesh, cell_markers=None, facet_markers=None):
    return TetMesh(
        mesh.coords,
        mesh.cells,
        mesh.cell_markers if cell_markers is None else cell_markers,
        mesh.facets,
        mesh.facet_markers if facet_markers is None else facet_markers,
    )


def restrict_fsi_to_sphere(mesh, fsi_ids, outer_ids, rigid_id, sphere):
    """Facets marked fsi/outer whose midpoint lies outside the sphere
    (x, y, z, radius) are re-marked rigid."""
    sx, sy, sz, rad = sphere
    mid = mesh.coords[mesh.facets].mean(axis=1)
    dist = np.sqrt((mid[:, 0] - sx) ** 2 + (mid[:, 1] - sy) ** 2
                   + (mid[:, 2] - sz) ** 2)
    ids = np.atleast_1d(fsi_ids).tolist() + np.atleast_1d(outer_ids).tolist()
    fm = mesh.facet_markers.copy()
    sel = np.isin(fm, ids) & (dist > rad)
    # list-valued ids pair up (e.g. [22,1022] -> [11,1011]); scalar rigid_id
    # replaces all
    rigid = np.atleast_1d(rigid_id)
    if len(rigid) == 1:
        fm[sel] = rigid[0]
    else:
        fsi_l = np.atleast_1d(fsi_ids)
        outer_l = np.atleast_1d(outer_ids)
        for k in range(len(rigid)):
            for group in (fsi_l, outer_l):
                if k < len(group):
                    fm[sel & (mesh.facet_markers == group[k])] = rigid[k]
    return _with_markers(mesh, facet_markers=fm)


def remark_cells(mesh, from_id, to_id, predicate):
    """Cells with marker from_id whose centroid satisfies predicate(x,y,z)
    get marker to_id."""
    cent = mesh.coords[mesh.cells].mean(axis=1)
    cm = mesh.cell_markers.copy()
    sel = (cm == from_id) & predicate(cent[:, 0], cent[:, 1], cent[:, 2])
    cm[sel] = to_id
    return _with_markers(mesh, cell_markers=cm)
