"""K8 (banded assembly) and K6 (banded apply, block-Thomas solve).

Plain torch versions (``assemble_plain``, ``solve_blocks_plain``,
``apply_plain``), CUDA launches (csrc/banded.cu) and the dispatch
fem/banded.py calls: a CPU tensor takes the plain version, a CUDA tensor
launches the kernels or raises.

Replaces vasp_tpu/fem/banded.py assemble_banded_planned (scatter mode) and
make_banded_apply with bgemv. Costs and design: see the head of
csrc/banded.cu. ``solve_blocks`` is the two scans on an (nb, c) block
vector; the apply wraps it in the permutation, and the probe
(fem/banded.py probe_rel) calls it directly.
"""
import torch

from vasp_tpu_torch.kernels import build

_FLOATS = (torch.float32, torch.float64)


# ------------------------------------------------------------ plain ----
def assemble_plain(jacs, plans, nb, c, diag_flat):
    """(C, D, B) f32 (nb, c, c): the element entries scatter-added by the
    plan in its order, then +1 on the diag_flat slots of D."""
    dev = jacs[0].device
    bufs = [torch.zeros(nb * c * c, dtype=torch.float32, device=dev)
            for _ in range(3)]
    for A, per_t in zip(jacs, plans):
        v = A.to(torch.float32).reshape(-1)
        for buf, p in zip(bufs, per_t):
            buf.index_add_(0, p["dst"].long(), v[p["src"].long()])
    bufs[1][diag_flat] += 1.0
    return tuple(b.view(nb, c, c) for b in bufs)


def bgemv(M, v):
    """Batched block GEMV: M (..., c, c) times v (..., c)."""
    return torch.matmul(M, v[..., None])[..., 0]


def solve_blocks_plain(Sinv, H, G, rb):
    """x (nb, c) with t_k = Sinv_k r_k, w_k = t_k - H_k w_{k-1},
    x_k = w_k - G_k x_{k+1}."""
    t = bgemv(Sinv, rb)
    w = [t[0]]
    for k in range(1, t.shape[0]):
        w.append(t[k] - bgemv(H[k], w[-1]))
    x = [w[-1]]
    for k in range(t.shape[0] - 2, -1, -1):
        x.append(w[k] - bgemv(G[k], x[-1]))
    return torch.stack(x[::-1])


def apply_plain(Sinv, H, G, perm, r):
    nb, c, _ = Sinv.shape
    ndof = perm.shape[0]
    rp = torch.zeros(nb * c, dtype=torch.float32, device=r.device)
    rp[:ndof] = r[perm].to(torch.float32)
    x = solve_blocks_plain(Sinv, H, G, rp.view(nb, c)).reshape(-1)[:ndof]
    out = torch.empty(ndof, dtype=r.dtype, device=r.device)
    out[perm] = x.to(r.dtype)
    return out


# ------------------------------------------------------------- cuda ----
def assemble_cuda(jacs, plans, nb, c, diag_flat):
    lib = build.library()
    dev = jacs[0].device
    stream = build.stream_handle(dev)
    bufs = [torch.zeros(nb * c * c, dtype=torch.float32, device=dev)
            for _ in range(3)]
    for A, per_t in zip(jacs, plans):
        build.require(A, "A", torch.float32, A.shape, dev)
        for buf, p in zip(bufs, per_t):
            nseg, nsrc = p["udst"].shape[0], p["src"].shape[0]
            build.require(p["src"], "src", torch.int32, (nsrc,), dev)
            build.require(p["udst"], "udst", torch.int32, (nseg,), dev)
            build.require(p["starts"], "starts", torch.int32, (nseg,), dev)
            build.check(lib.vt_banded_segsum(
                build.ptr(A), build.ptr(p["src"]), build.ptr(p["udst"]),
                build.ptr(p["starts"]), nseg, nsrc, build.ptr(buf), stream),
                "banded_assemble")
    build.LAUNCHES["banded_assemble"] += 1
    bufs[1][diag_flat] += 1.0
    return tuple(b.view(nb, c, c) for b in bufs)


def _check_factors(Sinv, H, G):
    nb, c, _ = Sinv.shape
    if c % 4:
        raise ValueError(f"K6 needs a block size divisible by 4, got {c}")
    for name, M in (("Sinv", Sinv), ("H", H), ("G", G)):
        build.require(M, name, torch.float32, (nb, c, c), Sinv.device)
    return nb, c


def solve_blocks_cuda(Sinv, H, G, rb):
    nb, c = _check_factors(Sinv, H, G)
    build.require(rb, "rb", torch.float32, (nb, c), Sinv.device)
    x = rb.clone()
    w = torch.empty_like(x)
    build.check(build.library().vt_banded_solve(
        *map(build.ptr, (Sinv, H, G, x, w)), nb, c,
        build.stream_handle(x.device)), "banded_apply")
    build.LAUNCHES["banded_apply"] += 1
    return x


def apply_cuda(Sinv, H, G, perm, r):
    lib = build.library()
    nb, c = _check_factors(Sinv, H, G)
    dev, ndof = r.device, perm.shape[0]
    if r.dtype not in _FLOATS:
        raise ValueError(f"K6 takes a float32/float64 vector, got {r.dtype}")
    build.require(r, "r", r.dtype, (ndof,), dev)
    build.require(perm, "perm", torch.int64, (ndof,), dev)
    stream = build.stream_handle(dev)
    f64 = int(r.dtype == torch.float64)
    rp = torch.empty(nb * c, dtype=torch.float32, device=dev)
    build.check(lib.vt_banded_permute(build.ptr(r), f64, build.ptr(perm),
                                      ndof, nb * c, build.ptr(rp), stream),
                "banded_permute")
    x = solve_blocks_cuda(Sinv, H, G, rp.view(nb, c))
    out = torch.empty_like(r)
    build.check(lib.vt_banded_unpermute(build.ptr(x), build.ptr(perm), ndof,
                                        build.ptr(out), f64, stream),
                "banded_unpermute")
    return out


# --------------------------------------------------------- dispatch ----
def assemble(jacs, plans, nb, c, diag_flat):
    if build.on_cuda(jacs[0], "banded_assemble"):
        return assemble_cuda(jacs, plans, nb, c, diag_flat)
    return assemble_plain(jacs, plans, nb, c, diag_flat)


def solve_blocks(Sinv, H, G, rb):
    if build.on_cuda(rb, "banded_apply"):
        return solve_blocks_cuda(Sinv, H, G, rb)
    return solve_blocks_plain(Sinv, H, G, rb)


def apply(Sinv, H, G, perm, r):
    if build.on_cuda(r, "banded_apply"):
        return apply_cuda(Sinv, H, G, perm, r)
    return apply_plain(Sinv, H, G, perm, r)
