"""Boundary measures, DG0 projections and point probes on torch tensors.

Counterpart of vasp_tpu.fem.measures: inlet area / barycenter / normal
via facet integrals (reference: src/vasp/simulations/cylinder.py:99-104,
172-177), flow rate |int v.n ds| (reference: simulation_common.py:278-280),
the DG0 local projections (reference: simulation_common.py:225-346) and
the probe evaluation (reference: simulation_common.py:157-222). The
per-step ones, dg0_project_speed, integrate_p2_dot_n and
dg0_project_jacobian, run as CUDA kernels on CUDA tensors
(kernels/measures.py), on tables built once per space and device.
PointProbes is host numpy, as in vasp_tpu: its cell search runs once, and
each evaluation is a gather of a few dofs from a host copy of the state.
"""
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from vasp_tpu_torch.fem.assembly import cell_geometry
from vasp_tpu_torch.fem.quadrature import tet_quadrature, tri_quadrature
from vasp_tpu_torch.fem.shape import p1_tet, p1_tri, p2_tet, p2_tri
from vasp_tpu_torch.kernels import measures as kmeasures


def _f64(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                           device=device)


@dataclass
class BoundaryMeasure:
    """Integration over exterior facets with a given marker (a `ds(id)`).

    Geometry is host numpy; integrate_p2_dot_n runs on the field's device."""

    space: object
    marker: object
    quad_degree: int = 6

    def __post_init__(self):
        mesh = self.space.mesh
        fv, cells, lf = mesh.exterior_facets(self.marker)
        self.facet_verts = np.sort(fv.astype(np.int64), axis=1)
        self.cells = cells
        x = mesh.coords[self.facet_verts]  # (K,3,3)
        e1 = x[:, 1] - x[:, 0]
        e2 = x[:, 2] - x[:, 0]
        cr = np.cross(e1, e2)
        self.area2 = np.linalg.norm(cr, axis=1)  # = 2*area
        n = cr / np.maximum(self.area2[:, None], 1e-300)
        # orient outward: away from the attached cell centroid
        cc = mesh.coords[mesh.cells[cells]].mean(axis=1)
        fc = x.mean(axis=1)
        flip = np.einsum("ki,ki->k", n, fc - cc) < 0
        n[flip] *= -1.0
        self.normals = n
        self.x = x
        pts, wq = tri_quadrature(self.quad_degree)
        self.qp = pts
        self.wq = wq
        self.N2, _ = p2_tri(pts)
        self.N1, _ = p1_tri(pts)
        if len(self.facet_verts):
            self.dofs_p2 = self.space.facet_dofs_p2(self.facet_verts)
        else:
            self.dofs_p2 = np.zeros((0, 6), np.int32)
        self.dofs_p1 = self.facet_verts.astype(np.int32)
        self._on_device = {}

    @cached_property
    def quad_coords(self):
        """(K, nq, 3) physical coordinates of quadrature points."""
        x0 = self.x[:, 0]
        e1 = self.x[:, 1] - self.x[:, 0]
        e2 = self.x[:, 2] - self.x[:, 0]
        return (
            x0[:, None, :]
            + self.qp[None, :, 0, None] * e1[:, None, :]
            + self.qp[None, :, 1, None] * e2[:, None, :]
        )

    @cached_property
    def area(self) -> float:
        return float(np.sum(self.wq.sum() * self.area2))

    @cached_property
    def centroid(self) -> np.ndarray:
        xq = self.quad_coords  # (K,nq,3)
        integ = np.einsum("q,kqi->i", self.wq, xq * self.area2[:, None, None])
        return integ / self.area

    @cached_property
    def mean_normal(self) -> np.ndarray:
        """Unit-normalized integral of the outward normal
        (reference: src/vasp/simulations/cylinder.py:175-177)."""
        ni = np.einsum("k,ki->i", self.wq.sum() * self.area2, self.normals)
        return ni / np.linalg.norm(ni)

    def device_tables(self, device):
        """(dofs (K,6) int64, normals, area2, N2 (nq,6), wq) on `device`."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = (
                torch.as_tensor(self.dofs_p2.astype(np.int64), device=device),
                _f64(self.normals, device), _f64(self.area2, device),
                _f64(self.N2, device), _f64(self.wq, device))
        return self._on_device[device]

    def integrate_p2_dot_n(self, field):
        """int_Gamma (u . n) ds for a P2 vector field (n2,3) tensor — the
        flow rate. A 0-d tensor on the field's device."""
        return kmeasures.integrate_p2_dot_n(field,
                                            *self.device_tables(field.device))

    def integrate_scalar_fn(self, fn):
        """int_Gamma f(x) ds for a coordinate function (host-side)."""
        vals = fn(self.quad_coords.reshape(-1, 3)).reshape(len(self.area2), -1)
        return float(np.einsum("q,kq,k->", self.wq, vals, self.area2))


# ---------------- DG0 projections ----------------
def cell_tables(space, device, quad_degree):
    """(cell_dofs (Nc,10) int64, Jinv (Nc,3,3), N2 (nq,10), dN2 (nq,10,3),
    wq (nq,)) on `device` for the tet rule of `quad_degree`: built on the
    first call and kept on the space, as BoundaryMeasure keeps its facet
    tables."""
    device = torch.device(device)
    cache = vars(space).setdefault("_measure_tables", {})
    key = (device, int(quad_degree))
    if key not in cache:
        pts, wq = tet_quadrature(quad_degree)
        N2, dN2 = p2_tet(pts)
        mesh = space.mesh
        Jinv = cell_geometry(mesh.coords, mesh.cells)[0]
        cache[key] = (
            torch.as_tensor(space.cell_dofs_p2.astype(np.int64), device=device),
            _f64(Jinv, device), _f64(N2, device), _f64(dN2, device),
            _f64(wq, device))
    return cache[key]


def dg0_project_speed(space, v, quad_degree=2):
    """DG0 (cellwise) L2-projection of |v| for a P2 field (n2,3) tensor:
    the cell average (reference local_project of sqrt(inner(v,v)) onto DG0,
    reference: simulation_common.py:253-317). (Nc,) on v's device."""
    dofs, _, N2, _, wq = cell_tables(space, v.device, quad_degree)
    return kmeasures.dg0_project_speed(v.contiguous(), dofs, N2, wq)


def dg0_project_jacobian(space, d, quad_degree=2):
    """DG0 projection of J(d) = det(I + grad d) per cell for a P2 field
    (n2,3) tensor (reference compute_minimum_jacobian,
    simulation_common.py:320-348). (Nc,) on d's device."""
    dofs, Jinv, _, dN2, wq = cell_tables(space, d.device, quad_degree)
    return kmeasures.dg0_project_jacobian(d.contiguous(), dofs, Jinv, dN2, wq)


# ---------------- point evaluation (probes) ----------------
class PointProbes:
    """Evaluate (d, v, p) at fixed physical points (the reference's peval /
    print_probe_points, simulation_common.py:157-222). Cell search is done
    once on the host; evaluation is a tiny gather of host numpy arrays."""

    def __init__(self, space, points):
        self.space = space
        points = np.atleast_2d(np.asarray(points, np.float64))
        mesh = space.mesh
        Jinv, _, _ = cell_geometry(mesh.coords, mesh.cells)
        x0 = mesh.coords[mesh.cells[:, 0]]  # (Nc,3)
        cells = []
        bary = []
        for pt in points:
            # xi = A^{-1} (x - x0); Jinv rows are d(xi_j)/d(x_i) as stored
            xi = np.einsum("kji,ki->kj", Jinv, pt[None, :] - x0)
            lam0 = 1.0 - xi.sum(axis=1)
            lam = np.concatenate([lam0[:, None], xi], axis=1)
            ok = np.all(lam >= -1e-10, axis=1)
            idx = np.nonzero(ok)[0]
            if len(idx) == 0:
                # nearest fallback
                idx = [int(np.argmax(lam.min(axis=1)))]
            cells.append(int(idx[0]))
            bary.append(lam[idx[0]])
        self.cells = np.asarray(cells)
        self.points = points
        ref = np.stack([b[1:] for b in bary], axis=0)  # reference coords
        self.N2, _ = p2_tet(ref)  # (P,10) basis values at each point
        self.N1, _ = p1_tet(ref)
        self.dofs_p2 = space.cell_dofs_p2[self.cells]  # (P,10)
        self.dofs_p1 = space.cell_dofs_p1[self.cells]

    def eval_p2(self, field):
        """field (n2, m) or (n2,) host array -> (P, m)."""
        fe = np.asarray(field)[self.dofs_p2]  # (P,10,...)
        return np.einsum("pa,pa...->p...", self.N2, fe)

    def eval_p1(self, field):
        fe = np.asarray(field)[self.dofs_p1]
        return np.einsum("pa,pa...->p...", self.N1, fe)
