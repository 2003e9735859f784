"""Matrix-free right-preconditioned restarted GMRES (K5).

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
"""
import numpy as np
import torch


def gmres(matvec, b, M, restart=30, cycles=4, tol=1e-5):
    """Solve A x = b from x = 0. Returns (x, (rnorm, cycles, inner)): the
    true final residual norm, the restart cycles used and the inner
    iterations over all cycles (the operator/preconditioner application
    count).

    matvec: x -> A x; M: right preconditioner r -> M r (approximate
    A^{-1}); restart: Krylov dimension per cycle; cycles: most restarts;
    tol: relative residual target |b - A x| <= tol |b|. vasp_tpu's x0,
    atol and reduce_fn, which no caller of the port sets, are left out."""
    n = b.shape[0]
    m = restart
    dtype = b.dtype
    fdt = np.float64 if dtype == torch.float64 else np.float32

    def norm(v):
        return torch.sqrt(torch.dot(v, v))

    target = fdt(tol) * fdt(norm(b).item())
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
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
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
