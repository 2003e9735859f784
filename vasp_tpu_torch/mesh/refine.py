"""Uniform (red) tet refinement with deterministic P2-matched node ordering.

The reference visualizes save_deg=2 (P2) results on a once-refined P1 mesh
and then has to *repair* node numbering to match the solver's output order
(reference: src/vasp/postprocessing/postprocessing_mesh/create_refined_mesh.py:24-153).
Here the refinement is defined so that refined node i IS P2 dof i:
vertices keep their ids and edge-midpoint node ids are Nn + edge_id — the
exact layout of vasp_tpu_torch.fem.functionspace.DVPSpace. No repair needed, and
the refined-cells = 8 x cells invariant holds
(reference: tests/test_postprocess_mesh.py:31-42)."""
import numpy as np

from vasp_tpu_torch.mesh.tetmesh import TetMesh
from vasp_tpu_torch.fem.shape import TET_EDGES

# local edge index for vertex pair, from TET_EDGES order
_EDGE_OF = {pair: k for k, pair in enumerate(TET_EDGES)}


def refine_uniform(mesh: TetMesh) -> TetMesh:
    """Refine each tet into 8 (4 corner tets + 4 octahedron tets around the
    m01-m23 diagonal); each marked boundary facet into 4 triangles."""
    Nn = mesh.num_vertices
    coords = mesh.p2_coords  # vertices then edge midpoints — P2 dof order
    c = mesh.cells.astype(np.int64)
    me = (Nn + mesh.cell_edges).astype(np.int64)  # (Nc,6) midpoint node ids
    m01, m02, m03, m12, m13, m23 = (me[:, k] for k in range(6))
    v0, v1, v2, v3 = (c[:, k] for k in range(4))

    subtets = [
        (v0, m01, m02, m03),
        (v1, m01, m12, m13),
        (v2, m02, m12, m23),
        (v3, m03, m13, m23),
        (m01, m23, m02, m12),
        (m01, m23, m12, m13),
        (m01, m23, m13, m03),
        (m01, m23, m03, m02),
    ]
    cells = np.concatenate(
        [np.stack(t, axis=1) for t in subtets], axis=0
    )
    markers = np.tile(mesh.cell_markers, 8)

    # refined marked facets: need midpoint node ids of facet edges
    if len(mesh.facets):
        f = np.sort(mesh.facets.astype(np.int64), axis=1)
        pairs = np.stack([f[:, [0, 1]], f[:, [0, 2]], f[:, [1, 2]]], axis=1)
        edges = mesh.edges.astype(np.int64)
        key_all = edges[:, 0] * (Nn + 1) + edges[:, 1]
        order = np.argsort(key_all)
        key = pairs[:, :, 0] * (Nn + 1) + pairs[:, :, 1]
        pos = np.searchsorted(key_all[order], key.ravel())
        eidx = order[np.clip(pos, 0, len(order) - 1)].reshape(key.shape)
        mab, mac, mbc = (Nn + eidx[:, k] for k in range(3))
        a, b, cc = f[:, 0], f[:, 1], f[:, 2]
        facets = np.concatenate(
            [
                np.stack(t, axis=1)
                for t in [(a, mab, mac), (b, mab, mbc), (cc, mac, mbc),
                          (mab, mbc, mac)]
            ],
            axis=0,
        )
        fmarkers = np.tile(mesh.facet_markers, 4)
    else:
        facets, fmarkers = None, None

    return TetMesh(coords, cells, markers, facets, fmarkers)
