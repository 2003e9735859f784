"""Simplex quadrature via collapsed (Duffy) Gauss–Jacobi rules.

This is the same family of rules FFC's "canonical" quadrature scheme uses, so
integrals agree with the reference's JIT-compiled element kernels (the
reference sets ``quadrature_degree=6`` for problem forms,
reference: src/vasp/simulations/offset_stenosis.py:18).

Reference tetrahedron: vertices (0,0,0),(1,0,0),(0,1,0),(0,0,1), volume 1/6.
Reference triangle: vertices (0,0),(1,0),(0,1), area 1/2.

Construction (tet): substitute
    x = xi, y = eta (1 - xi), z = zeta (1 - xi)(1 - eta)
with Jacobian (1-xi)^2 (1-eta); the weights (1-xi)^2 and (1-eta) are absorbed
into Gauss–Jacobi rules (alpha=2 and alpha=1 respectively), so an n-point
tensor rule integrates total degree 2n-1 exactly.
"""
from functools import lru_cache

import numpy as np
from scipy.special import roots_jacobi


def _gauss_jacobi_01(n: int, alpha: float):
    """Nodes/weights on [0,1] with weight (1-x)^alpha."""
    x, w = roots_jacobi(n, alpha, 0.0)
    # map [-1,1] -> [0,1]; weight transform: (1-x)^a dx, x = 2t-1 =>
    # (2-2t)^a 2 dt = 2^(a+1) (1-t)^a dt
    t = 0.5 * (x + 1.0)
    wt = w / (2.0 ** (alpha + 1.0))
    return t, wt


@lru_cache(maxsize=None)
def tet_quadrature(degree: int):
    """Return (points (nq,3), weights (nq,)) integrating exactly to `degree`.

    Weights sum to 1/6 (reference tet volume).
    """
    n = max(1, (degree + 2) // 2)
    xi, wx = _gauss_jacobi_01(n, 2.0)
    eta, wy = _gauss_jacobi_01(n, 1.0)
    zeta, wz = _gauss_jacobi_01(n, 0.0)
    pts = []
    wts = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                x = xi[i]
                y = eta[j] * (1.0 - xi[i])
                z = zeta[k] * (1.0 - xi[i]) * (1.0 - eta[j])
                pts.append((x, y, z))
                wts.append(wx[i] * wy[j] * wz[k])
    return np.asarray(pts, dtype=np.float64), np.asarray(wts, dtype=np.float64)


@lru_cache(maxsize=None)
def tri_quadrature(degree: int):
    """Return (points (nq,2), weights (nq,)) on the reference triangle.

    Weights sum to 1/2.
    """
    n = max(1, (degree + 2) // 2)
    xi, wx = _gauss_jacobi_01(n, 1.0)
    eta, wy = _gauss_jacobi_01(n, 0.0)
    pts = []
    wts = []
    for i in range(n):
        for j in range(n):
            x = xi[i]
            y = eta[j] * (1.0 - xi[i])
            pts.append((x, y))
            wts.append(wx[i] * wy[j])
    return np.asarray(pts, dtype=np.float64), np.asarray(wts, dtype=np.float64)
