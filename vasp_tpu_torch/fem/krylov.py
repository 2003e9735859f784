"""Matrix-free restarted GMRES: the iterative path's (K5), and the
counterpart of jax.scipy.sparse.linalg.gmres(solve_method="incremental")
that vasp_tpu's NewtonSolver takes on its Krylov branch.

``gmres``: right-preconditioned (K5).

Counterpart of vasp_tpu.fem.krylov.gmres, with the same algorithm and the
same result tuple: an Arnoldi basis updated by classical Gram-Schmidt with
one reorthogonalization (CGS2), Givens rotations applied on the fly (the
running residual norm of the original system comes for free under right
preconditioning), an early exit once that norm reaches the target, and a
back-substitution per cycle.

Device work per inner iteration: one operator and one preconditioner
application, the two projection passes V w and V^T h (cuBLAS GEMVs on the
card) and a norm. The Hessenberg column is read to the host once per
inner iteration (one synchronisation), where the rotations, the early exit
test and the back-substitution run in numpy in the basis' precision.

``gmres_incremental``: left-preconditioned, with JAX 0.9.0's semantics
(jax/_src/scipy/sparse/linalg.py), which NewtonSolver's Newton counts
depend on: see its docstring. Host control over device vectors, like K5.
"""
import math

import numpy as np
import scipy.linalg
import torch


def gmres(matvec, b, M, restart=30, cycles=4, tol=1e-5, atol=0.0,
          reduce_fn=None):
    """Solve A x = b from x = 0. Returns (x, (rnorm, cycles, inner)): the
    true final residual norm, the restart cycles used and the inner
    iterations over all cycles (the operator/preconditioner application
    count).

    matvec: x -> A x; M: right preconditioner r -> M r (approximate
    A^{-1}); restart: Krylov dimension per cycle; cycles: most restarts;
    tol, atol: residual target |b - A x| <= max(tol |b|, atol);
    reduce_fn: the cross-rank sum of the sharded path, where b, x and the
    basis hold one rank's dofs: every inner product and projection is
    contracted locally and summed (None on one device). vasp_tpu's x0,
    which no caller sets, is left out."""
    n = b.shape[0]
    m = restart
    dtype = b.dtype
    fdt = np.float64 if dtype == torch.float64 else np.float32
    red = reduce_fn if reduce_fn is not None else (lambda v: v)

    def norm(v):
        return torch.sqrt(red(torch.dot(v, v)))

    target = max(fdt(tol) * fdt(norm(b).item()), fdt(atol))
    x = torch.zeros_like(b)

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = norm(r)
        beta_h = fdt(beta.item())
        V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
        V[0] = r / (beta if beta_h > 0 else 1.0)
        H = np.zeros((m + 1, m), fdt)
        cs = np.zeros(m, fdt)
        sn = np.zeros(m, fdt)
        g = np.zeros(m + 1, fdt)
        g[0] = beta_h
        j = 0
        while j < m and abs(g[j]) > target:
            w = matvec(M(V[j]))
            Vj = V[:j + 1]
            h1 = red(Vj @ w)
            w = w - Vj.T @ h1
            h2 = red(Vj @ w)
            w = w - Vj.T @ h2
            hj1 = norm(w)
            V[j + 1] = w / torch.where(hj1 > 0, hj1, 1.0)
            # the one host read of the iteration: h[0..j] and h[j+1]
            col = torch.cat([h1 + h2, hj1[None]]).cpu().numpy().astype(fdt)
            h = np.zeros(m + 1, fdt)
            h[:j + 2] = col
            for i in range(j):  # previous rotations
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = hi, hi1
            denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c = h[j] / denom if denom > 0 else fdt(1.0)
            s = h[j + 1] / denom if denom > 0 else fdt(0.0)
            h[j] = c * h[j] + s * h[j + 1]
            h[j + 1] = 0.0
            cs[j], sn[j] = c, s
            gj = g[j]
            g[j], g[j + 1] = c * gj, -s * gj
            H[:, j] = h
            j += 1
        # back-substitution on H[:m,:m]; untouched columns are zero, so
        # their guard gives y[i] = 0 and they drop out of the update
        y = np.zeros(m, fdt)
        for i in range(m - 1, -1, -1):
            hii = H[i, i]
            if abs(hii) > 1e-300:
                y[i] = (g[i] - np.dot(H[i, :m], y)) / hii
        if j == 0:
            return x, 0
        yd = torch.as_tensor(y[:j], dtype=dtype, device=b.device)
        return x + M(V[:j].T @ yd), j

    rnorm = fdt(norm(b - matvec(x)).item())
    k = inner = 0
    while k < cycles and rnorm > target:
        x, j = arnoldi_cycle(x)
        rnorm = fdt(norm(b - matvec(x)).item())
        k += 1
        inner += j
    return x, (float(rnorm), k, inner)


def _norm(v):
    return torch.sqrt(torch.dot(v, v))


def _safe_normalize(x, thresh):
    """(x / |x|, |x|), or (0, 0) where |x| <= thresh: JAX's
    _safe_normalize, on the device (no host read)."""
    norm = _norm(x)
    use = norm > thresh
    return (torch.where(use, x / norm, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _givens(a, b):
    """JAX's _givens_rotation(a, b): (cs, sn)."""
    if b == 0:
        return 1.0, 0.0
    if abs(a) < abs(b):
        t = -a / b
        r = 1.0 / math.sqrt(1.0 + t * t)
        return r * t, r
    t = -b / a
    r = 1.0 / math.sqrt(1.0 + t * t)
    return r, r * t


def _rotate(v, i, cs, sn):
    """JAX's _rotate_vectors on a host vector, in place."""
    x1, y1 = v[i], v[i + 1]
    v[i] = cs * x1 - sn * y1
    v[i + 1] = sn * x1 + cs * y1


def gmres_incremental(matvec, b, M=None, tol=1e-5, atol=0.0, restart=20,
                      maxiter=None):
    """Solve A x = b from x = 0 as jax.scipy.sparse.linalg.gmres(A, b,
    tol=tol, atol=atol, restart=restart, maxiter=maxiter, M=M,
    solve_method="incremental") does in JAX 0.9.0. Returns (x, (restarts,
    iterations)): the restart cycles and the Arnoldi iterations over all
    of them.

    The semantics kept, since Newton counts depend on them:
    - left preconditioning: the Arnoldi vector is M(A(v)), each restart's
      residual M(b - A x);
    - atol = max(tol |b|, atol) is checked between restarts against the
      preconditioned residual norm, ptol = |M b| min(1, atol / |b|) inside
      a restart against the rotated residual estimate;
    - maxiter counts restarts (default 10 n), restart = min(restart, n);
    - one classical Gram-Schmidt pass: JAX's iterative one, called with at
      most two passes, tests for the second only while its pass count is
      below one after the first pass has made it one, so it never takes
      it;
    - JAX's Givens sign convention, and _safe_normalize's thresholds (the
      dtype's eps absolute, eps |v| relative for the new basis vector);
    - the triangular factor starts as the identity: after an early exit
      the solve takes the residual estimate as the coefficient of the last
      basis vector, as JAX's does.

    Device work per iteration: the operator and preconditioner
    applications, the projection (two GEMVs) and norms; the Hessenberg row
    comes to the host once, where the rotations and the exit test run in
    float64; the triangular solve runs on the host at each restart's end.
    """
    M = M if M is not None else (lambda v: v)
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    eps = torch.finfo(dtype).eps
    m = min(restart, n)
    if maxiter is None:
        maxiter = 10 * n
    b_norm = float(_norm(b))
    atol = max(tol * b_norm, atol)
    with np.errstate(divide="ignore", invalid="ignore"):
        ptol = float(_norm(M(b))) * float(np.minimum(
            1.0, np.float64(atol) / np.float64(b_norm)))

    def cycle(x, unit_residual, residual_norm):
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = unit_residual
        R = np.eye(m, m + 1)
        givens = np.zeros((m, 2))
        beta = np.zeros(m + 1)
        beta[0] = residual_norm
        k, err = 0, residual_norm
        while k < m and err > ptol:
            v = M(matvec(V[k]))
            v_norm_0 = _safe_normalize(v, eps)[1]
            h = V @ v  # unfilled rows of V are zero
            v = v - V.T @ h
            unit_v, v_norm_1 = _safe_normalize(v, eps * v_norm_0)
            V[k + 1] = unit_v
            h[k + 1] = v_norm_1
            # the one host read of the iteration
            row = h.cpu().numpy().astype(np.float64)
            for i in range(k):
                _rotate(row, i, *givens[i])
            givens[k] = _givens(row[k], row[k + 1])
            _rotate(row, k, *givens[k])
            R[k] = row
            _rotate(beta, k, *givens[k])
            err = abs(beta[k + 1])
            k += 1
        y = scipy.linalg.solve_triangular(R[:, :-1].T, beta[:-1],
                                          lower=False)
        x = x + V[:-1].T @ torch.as_tensor(y, dtype=dtype, device=dev)
        unit_residual, rn = _safe_normalize(M(b - matvec(x)), eps)
        return x, unit_residual, float(rn), k

    x = torch.zeros_like(b)
    unit_residual, rn = _safe_normalize(M(b - matvec(x)), eps)
    residual_norm = float(rn)
    restarts = iterations = 0
    while restarts < maxiter and residual_norm > atol:
        x, unit_residual, residual_norm, k = cycle(x, unit_residual,
                                                   residual_norm)
        restarts += 1
        iterations += k
    return x, (restarts, iterations)
