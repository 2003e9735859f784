"""Unstructured tetrahedral mesh substrate.

The mesh is *static data*: plain integer/float arrays, fully constructed on
the host (numpy) at load time, then copied to the device as tensors by the
assembler. This replaces DOLFIN's C++
Mesh/MeshFunction/connectivity machinery
(reference: src/vasp/simulations/cylinder.py:75-86 reads /mesh /boundaries
/domains via dolfin HDF5File).

Marker conventions follow the reference pipeline: cell (domain) markers
fluid=1, solid=2 (+ zone variants like 1001/1002,
reference: src/vasp/preprocessing/preprocessing_common.py:229-237); facet
markers inlet=2, outlets=3.., inlet/outlet-solid=11, FSI interface=22,
solid outer wall=33 (reference: src/vasp/simulations/cylinder.py:47-51).
"""
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from vasp_tpu_torch.fem.shape import TET_EDGES

# local facet f of a tet = the 3 vertices excluding local vertex f
TET_FACETS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def _sorted_rows(a):
    return np.sort(a, axis=1)


def _row_view(a):
    """View of int rows usable as a 1D structured array for unique/searchsorted."""
    a = np.ascontiguousarray(a)
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


@dataclass(frozen=True)
class TetMesh:
    """Tetrahedral mesh with cell and facet markers.

    coords:        (Nn, 3) float64 vertex coordinates
    cells:         (Nc, 4) int32 vertex ids per tet
    cell_markers:  (Nc,)   int32 subdomain ids (fluid=1, solid=2, zones 1001..)
    facets:        (Nf, 3) int32 vertex ids of *marked* facets (value > 0)
    facet_markers: (Nf,)   int32 facet ids
    """

    coords: np.ndarray
    cells: np.ndarray
    cell_markers: np.ndarray
    facets: np.ndarray = field(default=None)
    facet_markers: np.ndarray = field(default=None)

    def __post_init__(self):
        object.__setattr__(self, "coords", np.asarray(self.coords, np.float64))
        object.__setattr__(self, "cells", np.asarray(self.cells, np.int32))
        object.__setattr__(
            self, "cell_markers", np.asarray(self.cell_markers, np.int32)
        )
        if self.facets is None:
            object.__setattr__(self, "facets", np.zeros((0, 3), np.int32))
            object.__setattr__(self, "facet_markers", np.zeros((0,), np.int32))
        else:
            object.__setattr__(self, "facets", np.asarray(self.facets, np.int32))
            object.__setattr__(
                self, "facet_markers", np.asarray(self.facet_markers, np.int32)
            )

    # ---------------- basic sizes ----------------
    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    # ---------------- edges (P2 dofs) ----------------
    @cached_property
    def _edge_data(self):
        """Unique mesh edges and the (Nc,6) cell->edge map in TET_EDGES order.

        Edge numbering is CANONICAL (lexicographic by vertex pair), the same
        numbering the JAX package builds, so P2 dof ids agree between them."""
        c = self.cells.astype(np.int64)
        pairs = np.stack(
            [np.stack([c[:, a], c[:, b]], axis=1) for (a, b) in TET_EDGES], axis=1
        )  # (Nc, 6, 2)
        flat = _sorted_rows(pairs.reshape(-1, 2))
        uniq, inv = np.unique(_row_view(flat), return_inverse=True)
        uniq_rows = uniq.view(np.int64).reshape(-1, 2)
        cell_edges = inv.reshape(-1, 6).astype(np.int32)
        return uniq_rows.astype(np.int32), cell_edges

    @property
    def edges(self) -> np.ndarray:
        """(Ne,2) unique edges, each row sorted ascending."""
        return self._edge_data[0]

    @property
    def cell_edges(self) -> np.ndarray:
        """(Nc,6) edge index per local edge (TET_EDGES order)."""
        return self._edge_data[1]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @cached_property
    def edge_midpoints(self) -> np.ndarray:
        e = self.edges
        return 0.5 * (self.coords[e[:, 0]] + self.coords[e[:, 1]])

    @cached_property
    def p2_coords(self) -> np.ndarray:
        """(Nn+Ne, 3) coordinates of P2 dofs: vertices then edge midpoints."""
        return np.concatenate([self.coords, self.edge_midpoints], axis=0)

    # ---------------- facet <-> cell connectivity ----------------
    @cached_property
    def _facet_tables(self):
        """All unique facets of the mesh with their adjacent cells.

        Returns (facet_verts (F,3) sorted rows, cell0 (F,), lfacet0 (F,),
        cell1 (F,), lfacet1 (F,)); cell1 = -1 for exterior facets.
        """
        c = self.cells.astype(np.int64)
        tris = np.stack(
            [np.stack([c[:, a], c[:, b], c[:, d]], axis=1) for (a, b, d) in TET_FACETS],
            axis=1,
        )  # (Nc, 4, 3)
        flat = _sorted_rows(tris.reshape(-1, 3))
        view = _row_view(flat)
        order = np.argsort(view, kind="stable")
        sv = view[order]
        new_group = np.ones(len(sv), bool)
        new_group[1:] = sv[1:] != sv[:-1]
        group_id = np.cumsum(new_group) - 1
        F = group_id[-1] + 1 if len(sv) else 0
        cell_of = order // 4
        lfac_of = order % 4
        cell0 = np.full(F, -1, np.int64)
        lf0 = np.full(F, -1, np.int64)
        cell1 = np.full(F, -1, np.int64)
        lf1 = np.full(F, -1, np.int64)
        first = new_group
        cell0[group_id[first]] = cell_of[first]
        lf0[group_id[first]] = lfac_of[first]
        second = ~new_group
        cell1[group_id[second]] = cell_of[second]
        lf1[group_id[second]] = lfac_of[second]
        facet_verts = flat[order[first]]
        return (
            facet_verts.astype(np.int32),
            cell0.astype(np.int32),
            lf0.astype(np.int32),
            cell1.astype(np.int32),
            lf1.astype(np.int32),
        )

    def _match_marked_facets(self):
        """Match self.facets rows against the global facet table.

        Returns indices into the global facet table for each marked facet.
        """
        fv, *_ = self._facet_tables
        view_all = _row_view(fv)
        order = np.argsort(view_all)
        key = _row_view(_sorted_rows(self.facets.astype(np.int64)).astype(np.int32))
        pos = np.searchsorted(view_all[order], key)
        pos = np.clip(pos, 0, len(order) - 1)
        idx = order[pos]
        ok = view_all[idx] == key
        if not np.all(ok):
            raise ValueError(
                f"{(~ok).sum()} marked facets not found in mesh connectivity"
            )
        return idx

    @cached_property
    def marked_facet_cells(self):
        """For each marked facet: (cell0, lfacet0, cell1, lfacet1); cell1=-1 if exterior."""
        fv, c0, l0, c1, l1 = self._facet_tables
        idx = self._match_marked_facets()
        return c0[idx], l0[idx], c1[idx], l1[idx]

    def exterior_facets(self, marker=None):
        """(facet_vertex_ids (K,3), cell (K,), local_facet (K,)) of exterior
        marked facets, optionally filtered by marker value(s)."""
        c0, l0, c1, _ = self.marked_facet_cells
        ext = c1 < 0
        sel = ext
        if marker is not None:
            markers = np.atleast_1d(marker)
            sel = ext & np.isin(self.facet_markers, markers)
        return self.facets[sel], c0[sel], l0[sel]

    def interior_facets(self, marker):
        """Interior facets with given marker(s), oriented so that the FIRST
        cell is the one with the HIGHER domain marker (the reference's ('+')
        restriction convention: "solid domain has a higher domain ID",
        reference: src/vasp/simulations/cylinder.py:168).

        Returns (facet_vertex_ids, cell_plus, lfacet_plus, cell_minus,
        lfacet_minus)."""
        c0, l0, c1, l1 = self.marked_facet_cells
        markers = np.atleast_1d(marker)
        sel = (c1 >= 0) & np.isin(self.facet_markers, markers)
        c0, l0, c1, l1 = c0[sel], l0[sel], c1[sel], l1[sel]
        m0 = self.cell_markers[c0]
        m1 = self.cell_markers[c1]
        swap = m1 > m0
        cp = np.where(swap, c1, c0)
        lp = np.where(swap, l1, l0)
        cm = np.where(swap, c0, c1)
        lm = np.where(swap, l0, l1)
        return self.facets[sel], cp, lp, cm, lm

    # ---------------- vertex sets ----------------
    def facet_vertices(self, marker) -> np.ndarray:
        """Unique vertex ids lying on facets with the given marker(s)."""
        markers = np.atleast_1d(marker)
        sel = np.isin(self.facet_markers, markers)
        return np.unique(self.facets[sel])

    def facet_edges(self, marker) -> np.ndarray:
        """Unique edge ids (P2 midpoint dofs) on facets with given marker(s)."""
        markers = np.atleast_1d(marker)
        sel = np.isin(self.facet_markers, markers)
        tris = _sorted_rows(self.facets[sel].astype(np.int64))
        pairs = np.concatenate(
            [tris[:, [0, 1]], tris[:, [0, 2]], tris[:, [1, 2]]], axis=0
        )
        pairs = np.unique(_sorted_rows(pairs), axis=0)
        ev = _row_view(self.edges.astype(np.int64))
        order = np.argsort(ev)
        key = _row_view(pairs)
        pos = np.searchsorted(ev[order], key)
        pos = np.clip(pos, 0, len(order) - 1)
        idx = order[pos]
        ok = ev[idx] == key
        return np.unique(idx[ok]).astype(np.int32)

    def domain_vertices(self, cell_marker) -> np.ndarray:
        """Unique vertex ids of cells with the given domain marker(s).

        Mirrors reference get_domain_ids
        (reference: src/vasp/postprocessing/postprocessing_common.py:16-60)."""
        markers = np.atleast_1d(cell_marker)
        sel = np.isin(self.cell_markers, markers)
        return np.unique(self.cells[sel])

    def domain_edges(self, cell_marker) -> np.ndarray:
        markers = np.atleast_1d(cell_marker)
        sel = np.isin(self.cell_markers, markers)
        return np.unique(self.cell_edges[sel])

    # ---------------- geometry ----------------
    @cached_property
    def cell_volumes(self) -> np.ndarray:
        x = self.coords[self.cells]  # (Nc,4,3)
        J = x[:, 1:4] - x[:, :1]
        return np.abs(np.linalg.det(J)) / 6.0

    @cached_property
    def hmin(self) -> float:
        """Min cell diameter proxy (min edge length), cf. dolfin mesh.hmin()."""
        e = self.edges
        d = np.linalg.norm(self.coords[e[:, 0]] - self.coords[e[:, 1]], axis=1)
        return float(d.min())
