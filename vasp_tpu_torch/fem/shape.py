"""Lagrange shape functions on reference simplices (P1 / P2, tets + tris).

Conventions (framework-internal; all global numbering is built on these):

- Reference tet vertices: v0=(0,0,0) v1=(1,0,0) v2=(0,1,0) v3=(0,0,1);
  barycentric l0 = 1-x-y-z, l1 = x, l2 = y, l3 = z.
- Local edges, lexicographic: TET_EDGES = [(0,1),(0,2),(0,3),(1,2),(1,3),(2,3)].
- P2 tet dof order: 4 vertex dofs then 6 edge-midpoint dofs in TET_EDGES order.
- Reference triangle vertices (0,0),(1,0),(0,1); TRI_EDGES = [(0,1),(0,2),(1,2)];
  P2 tri dofs: 3 vertices then 3 edge midpoints.

Values are returned as numpy arrays tabulated at given points; these tables
are uploaded once as constant tables for the element kernels.
"""
import numpy as np

TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
TRI_EDGES = ((0, 1), (0, 2), (1, 2))


def _bary_tet(pts):
    pts = np.asarray(pts, dtype=np.float64)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    lam = np.stack([1.0 - x - y - z, x, y, z], axis=1)  # (nq,4)
    dlam = np.array(
        [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )  # (4,3) gradients wrt reference coords
    return lam, dlam


def p1_tet(pts):
    """P1 tet basis. Returns (N (nq,4), dN (nq,4,3))."""
    lam, dlam = _bary_tet(pts)
    nq = lam.shape[0]
    dN = np.broadcast_to(dlam, (nq, 4, 3)).copy()
    return lam.copy(), dN


def p2_tet(pts):
    """P2 tet basis. Returns (N (nq,10), dN (nq,10,3))."""
    lam, dlam = _bary_tet(pts)
    nq = lam.shape[0]
    N = np.zeros((nq, 10))
    dN = np.zeros((nq, 10, 3))
    for i in range(4):
        N[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
        dN[:, i, :] = (4.0 * lam[:, i] - 1.0)[:, None] * dlam[i]
    for e, (a, b) in enumerate(TET_EDGES):
        N[:, 4 + e] = 4.0 * lam[:, a] * lam[:, b]
        dN[:, 4 + e, :] = 4.0 * (
            lam[:, a][:, None] * dlam[b] + lam[:, b][:, None] * dlam[a]
        )
    return N, dN


def _bary_tri(pts):
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    lam = np.stack([1.0 - x - y, x, y], axis=1)
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    return lam, dlam


def p1_tri(pts):
    """P1 triangle basis. Returns (N (nq,3), dN (nq,3,2))."""
    lam, dlam = _bary_tri(pts)
    nq = lam.shape[0]
    return lam.copy(), np.broadcast_to(dlam, (nq, 3, 2)).copy()


def p2_tri(pts):
    """P2 triangle basis. Returns (N (nq,6), dN (nq,6,2))."""
    lam, dlam = _bary_tri(pts)
    nq = lam.shape[0]
    N = np.zeros((nq, 6))
    dN = np.zeros((nq, 6, 2))
    for i in range(3):
        N[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
        dN[:, i, :] = (4.0 * lam[:, i] - 1.0)[:, None] * dlam[i]
    for e, (a, b) in enumerate(TRI_EDGES):
        N[:, 3 + e] = 4.0 * lam[:, a] * lam[:, b]
        dN[:, 3 + e, :] = 4.0 * (
            lam[:, a][:, None] * dlam[b] + lam[:, b][:, None] * dlam[a]
        )
    return N, dN
