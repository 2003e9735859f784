"""Parity of the port's GMRES (K5) with vasp_tpu.fem.krylov.gmres on a
seeded dense nonsymmetric system with a seeded right preconditioner.

Tolerance: x to 1e-10 relative and the same (cycles, inner). Both run the
same float64 algorithm; only the summation order of the projections and
matvecs differs (BLAS against XLA)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vasp_tpu.fem.krylov import gmres as jax_gmres
from vasp_tpu_torch.fem.krylov import gmres
from _torch_small_fsi import torch_threads

_threads = torch_threads(1)


def _system(n, seed):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.normal(size=(n, n)) / np.sqrt(n)
    A[np.arange(n - 1), np.arange(1, n)] += 1.5  # nonsymmetric coupling
    b = rng.normal(size=n)
    # preconditioner: the inverse of A's tridiagonal part
    T = np.triu(np.tril(A, 1), -1)
    return A, b, np.linalg.inv(T)


@pytest.mark.parametrize("restart,cycles,tol", [
    (8, 6, 1e-10),    # several restart cycles
    (40, 2, 1e-8),    # early exit inside the first cycle
    (5, 2, 1e-12),    # runs out of cycles unconverged
], ids=["restarts", "early_exit", "budget"])
def test_gmres_matches_vasp_tpu(restart, cycles, tol):
    A, b, P = _system(120, seed=11)
    xj, (rj, kj, ij) = jax_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                                 M=lambda v: jnp.asarray(P) @ v,
                                 restart=restart, cycles=cycles, tol=tol)
    At, Pt, bt = (torch.as_tensor(a) for a in (A, P, b))
    xt, (rt, kt, it) = gmres(lambda v: At @ v, bt, M=lambda v: Pt @ v,
                             restart=restart, cycles=cycles, tol=tol)
    xj = np.asarray(xj)
    assert (kt, it) == (int(kj), int(ij))
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)
    assert rt == pytest.approx(float(rj), rel=1e-4, abs=1e-12)


def test_gmres_float32_basis():
    """krylov_dtype="f32": the whole Krylov space, rotations included, in
    float32; the result and residual come back in float32."""
    A, b, P = _system(60, seed=12)
    A, b, P = (a.astype(np.float32) for a in (A, b, P))
    At, Pt, bt = (torch.as_tensor(a) for a in (A, P, b))
    xt, (rt, kt, it) = gmres(lambda v: At @ v, bt, M=lambda v: Pt @ v,
                             restart=20, cycles=3, tol=1e-5)
    xj, (rj, kj, ij) = jax_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                                 M=lambda v: jnp.asarray(P) @ v,
                                 restart=20, cycles=3, tol=1e-5)
    assert xt.dtype == torch.float32
    assert (kt, it) == (int(kj), int(ij))
    assert rt <= 1e-5 * float(np.linalg.norm(b))
    xj = np.asarray(xj)
    # float32 rounding of different summation orders: 1e-5 relative
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-5 * np.linalg.norm(xj)
