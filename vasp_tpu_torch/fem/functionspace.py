"""Mixed DVP function space on a tetrahedral mesh.

The monolithic unknown vector U packs three fields, matching the reference's
mixed space sub(0)=displacement, sub(1)=velocity, sub(2)=pressure with
degrees d_deg=2, v_deg=2, p_deg=1 — Taylor-Hood P2/P1 fluid + P2 solid
(reference: tests/test_data/hemodynamics_data/Checkpoint/default_variables.json,
src/vasp/simulations/offset_stenosis.py:170-176, 217-219).

Layout (field-blocked, row-major within a field):

    U = [ d_0x d_0y d_0z ... d_{n2-1}z | v ... | p_0 ... p_{n1-1} ]

with n2 = num P2 dofs = Nn + Ne (vertices then edge midpoints),
     n1 = num P1 dofs = Nn.
"""
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from vasp_tpu_torch.mesh.tetmesh import TetMesh

# local dof count of the monolithic element vector [d(10x3), v(10x3), p(4)]
ELEM_NDOF = 64


@dataclass(frozen=True)
class DVPSpace:
    mesh: TetMesh

    @cached_property
    def n_p1(self) -> int:
        return self.mesh.num_vertices

    @cached_property
    def n_p2(self) -> int:
        return self.mesh.num_vertices + self.mesh.num_edges

    @cached_property
    def ndof(self) -> int:
        return 6 * self.n_p2 + self.n_p1

    # field offsets
    @property
    def off_d(self) -> int:
        return 0

    @cached_property
    def off_v(self) -> int:
        return 3 * self.n_p2

    @cached_property
    def off_p(self) -> int:
        return 6 * self.n_p2

    # ---------------- cell dof tables ----------------
    @cached_property
    def cell_dofs_p2(self) -> np.ndarray:
        """(Nc,10): 4 vertex dofs then 6 edge dofs (TET_EDGES order)."""
        m = self.mesh
        return np.concatenate(
            [m.cells, m.num_vertices + m.cell_edges], axis=1
        ).astype(np.int32)

    @cached_property
    def cell_dofs_p1(self) -> np.ndarray:
        return self.mesh.cells.astype(np.int32)

    @cached_property
    def cell_dofs_mixed(self) -> np.ndarray:
        """(Nc,64) global indices of the local element vector
        [d(10x3 row-major), v(10x3), p(4)]."""
        p2 = self.cell_dofs_p2.astype(np.int64)
        d_idx = (3 * p2[:, :, None] + np.arange(3)[None, None, :]).reshape(-1, 30)
        v_idx = d_idx + self.off_v
        p_idx = self.cell_dofs_p1.astype(np.int64) + self.off_p
        return np.concatenate([d_idx, v_idx, p_idx], axis=1).astype(np.int32)

    # ---------------- facet dof tables ----------------
    def facet_dofs_p2(self, facet_verts: np.ndarray) -> np.ndarray:
        """(K,6) P2 dofs of boundary triangles: 3 vertices + 3 edge dofs.

        facet_verts rows must be sorted ascending (TetMesh stores them so);
        the local P2 triangle dof order is then vertices (a,b,c) followed by
        edges (a,b),(a,c),(b,c) — consistent with fem.shape.p2_tri."""
        m = self.mesh
        fv = np.sort(facet_verts.astype(np.int64), axis=1)
        pairs = np.stack([fv[:, [0, 1]], fv[:, [0, 2]], fv[:, [1, 2]]], axis=1)
        # lookup edge ids
        edges = m.edges.astype(np.int64)
        ev = edges[:, 0] * (m.num_vertices + 1) + edges[:, 1]
        order = np.argsort(ev)
        key = pairs[:, :, 0] * (m.num_vertices + 1) + pairs[:, :, 1]
        pos = np.searchsorted(ev[order], key.ravel())
        pos = np.clip(pos, 0, len(order) - 1)
        eidx = order[pos].reshape(key.shape)
        if not np.all(ev[eidx.ravel()] == key.ravel()):
            raise ValueError("facet edge not found in mesh edges")
        return np.concatenate([fv, m.num_vertices + eidx], axis=1).astype(np.int32)

    # ---------------- split / pack ----------------
    def split(self, U):
        """U -> (d (n2,3), v (n2,3), p (n1,)). Works for numpy arrays and
        torch tensors (views, no copy)."""
        n2, n1 = self.n_p2, self.n_p1
        d = U[: 3 * n2].reshape(n2, 3)
        v = U[3 * n2: 6 * n2].reshape(n2, 3)
        p = U[6 * n2: 6 * n2 + n1]
        return d, v, p

    def pack(self, d, v, p):
        parts = [d.reshape(-1), v.reshape(-1), p.reshape(-1)]
        if isinstance(d, np.ndarray):
            return np.concatenate(parts)
        return torch.cat(parts)

    # ---------------- dof set helpers ----------------
    def p2_dofs_on_facets(self, marker) -> np.ndarray:
        """All scalar P2 dof ids (vertex + edge) on facets with marker(s)."""
        m = self.mesh
        vd = m.facet_vertices(marker)
        ed = m.num_vertices + m.facet_edges(marker)
        return np.concatenate([vd, ed]).astype(np.int64)

    def field_dofs(self, field: str, p2_scalar_dofs, components=(0, 1, 2)):
        """Global U-vector indices of a vector field at given scalar dofs."""
        base = {"d": self.off_d, "v": self.off_v}[field]
        p2 = np.asarray(p2_scalar_dofs, np.int64)
        idx = base + 3 * p2[:, None] + np.asarray(components)[None, :]
        return idx.reshape(-1)

    def pressure_dofs(self, p1_scalar_dofs) -> np.ndarray:
        return self.off_p + np.asarray(p1_scalar_dofs, np.int64)

    @cached_property
    def p2_coords(self) -> np.ndarray:
        return self.mesh.p2_coords

    def solid_only_pressure_dofs(self, dx_f_id, dx_s_id) -> np.ndarray:
        """P1 dofs strictly interior to the solid (not shared with any fluid
        cell). The continuity equation only lives on the fluid domain, so
        these dofs carry no equation; we pin them to zero (well-posedness —
        the reference's MUMPS handled the same structural rank deficiency
        with null-pivot detection)."""
        fluid_v = self.mesh.domain_vertices(np.atleast_1d(dx_f_id))
        solid_v = self.mesh.domain_vertices(np.atleast_1d(dx_s_id))
        only = np.setdiff1d(solid_v, fluid_v)
        return only.astype(np.int64)
