"""K8 (banded assembly), K6 (banded apply, block-Thomas solve), K12 (the
folded apply of the low-memory layouts) and K21a (one rank's stages of the
sharded applies).

Plain torch versions (``assemble_plain``, ``solve_blocks_plain``,
``apply_plain``, ``solve_blocks_lowmem_plain``, ``apply_lowmem_plain``),
CUDA launches (csrc/banded.cu) and the dispatch fem/banded.py calls: a CPU
tensor takes the plain version, a CUDA tensor launches the kernels or
raises.

Replaces vasp_tpu/fem/banded.py assemble_banded_planned (scatter mode),
make_banded_apply and make_banded_apply_lowmem with bgemv. Each factor is
stored in float32 or bfloat16 (K6: Sinv, and H/G together; K12: Sinv, and
C/B together); bf16 entries are widened to float32 and the vector and the
sums are float32, as vasp_tpu's bgemv promotes bf16 * f32 (on the card
the sums of K12 and of K6's bf16-storage instances are compensated). Costs and
design: see the head of csrc/banded.cu. ``solve_blocks`` is the two scans
on an (nb, c) block vector; the apply wraps it in the permutation, and the
probe (fem/banded.py probe_rel) calls it directly.

K21a replaces one rank's part of vasp_tpu/parallel/banded_shard.py
make_sharded_chain_apply and make_sharded_banded_apply: ``carry_stage`` is
one stage of the rank's solve on its (nb_loc, c) blocks, t = Sinv r, the
forward scan from an incoming carry w_in (H_0 couples to rank p - 1) or the
backward scan from x_in (G_{nb_loc-1} couples to rank p + 1), a missing
carry being zero; ``carry_update`` is the chain's w_last + Tf carry.
parallel/banded_shard.py runs the stages between its exchanges;
``solve_blocks_carry_cuda`` and ``solve_blocks_carry_plain`` run the three
with both carries (a rank's pass, for the checks). The SPIKE apply runs
its local solves as these stages with no carry and its reduced sweeps and
corrections as ``carry_update`` (K21f-b).

K21f-a replaces the refinement residual of vasp_tpu/parallel/
banded_shard.py make_sharded_spike_apply: ``tri_residual`` is r - (D x +
C x_{k-1} + B x_{k+1}) over a rank's blocks, the neighbours' boundary
rows given (None: zero); on the card every product exact in double and
each row summed in double and rounded once.
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
    """Batched block GEMV: M (..., c, c) times v (..., c), in v's dtype (a
    bf16 M widened exactly)."""
    return torch.matmul(M.to(v.dtype), v[..., None])[..., 0]


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


def solve_blocks_lowmem_plain(Sinv, C, B, rb):
    """x (nb, c) with w_k = Sinv_k (r_k - C_k w_{k-1}) and x_k = w_k -
    Sinv_k (B_k x_{k+1}): the K6 scans with H = Sinv C and G = Sinv B
    folded in."""
    w = [bgemv(Sinv[0], rb[0])]
    for k in range(1, rb.shape[0]):
        w.append(bgemv(Sinv[k], rb[k] - bgemv(C[k], w[-1])))
    x = [w[-1]]
    for k in range(rb.shape[0] - 2, -1, -1):
        x.append(w[k] - bgemv(Sinv[k], bgemv(B[k], x[-1])))
    return torch.stack(x[::-1])


def _carry_factor(Sinv, H, G, stage):
    """The factor a K21a stage reads: Sinv, H (forward) or G (backward)."""
    return {"times": Sinv, "forward": H, "backward": G}[stage]


def carry_stage_plain(Sinv, H, G, stage, a, carry=None):
    """(nb, c) float32: stage "times" Sinv_k a_k; "forward" y_0 = a_0 - H_0
    carry, y_k = a_k - H_k y_{k-1}; "backward" y_{nb-1} = a_{nb-1} -
    G_{nb-1} carry, y_k = a_k - G_k y_{k+1}; a carry of None is zero (the
    first block is a's)."""
    M = _carry_factor(Sinv, H, G, stage)
    if stage == "times":
        return bgemv(M, a)
    nb = a.shape[0]
    y = torch.empty_like(a)
    prev = carry
    for k in (range(nb - 1, -1, -1) if stage == "backward" else range(nb)):
        y[k] = a[k] if prev is None else a[k] - bgemv(M[k], prev)
        prev = y[k]
    return y


def carry_update_plain(T, v, a):
    """a + T v (the chain's carry update), float32."""
    return a + bgemv(T, v)


def tri_residual_plain(Cb, Db, Bb, x, r, xprev=None, xnext=None):
    """(m, c) float32: r - (D_k x_k + C_k x_{k-1} + B_k x_{k+1}), x_{-1} =
    xprev and x_m = xnext (None: zero), vasp_tpu's three bgemv."""
    z = x.new_zeros(x.shape[1])
    xm = torch.cat([(z if xprev is None else xprev)[None], x,
                    (z if xnext is None else xnext)[None]])
    m = x.shape[0]
    return r - (bgemv(Db, x) + bgemv(Cb, xm[:m]) + bgemv(Bb, xm[2:]))


def solve_blocks_carry_plain(Sinv, H, G, rb, w_in=None, x_in=None):
    return _solve_carry(carry_stage_plain, Sinv, H, G, rb, w_in, x_in)


def _solve_carry(stage, Sinv, H, G, rb, w_in, x_in):
    """(x, w_last, x_first) of one rank's solve with both carries."""
    t = stage(Sinv, H, G, "times", rb)
    w = stage(Sinv, H, G, "forward", t, w_in)
    x = stage(Sinv, H, G, "backward", w, x_in)
    return x, w[-1], x[0]


def _permuted_solve(solve, F1, F2, F3, perm, r):
    """solve on r permuted into float32 blocks (zero padding), unpermuted
    into r's dtype."""
    nb, c, _ = F1.shape
    ndof = perm.shape[0]
    rp = torch.zeros(nb * c, dtype=torch.float32, device=r.device)
    rp[:ndof] = r[perm].to(torch.float32)
    x = solve(F1, F2, F3, rp.view(nb, c)).reshape(-1)[:ndof]
    out = torch.empty(ndof, dtype=r.dtype, device=r.device)
    out[perm] = x.to(r.dtype)
    return out


def apply_plain(Sinv, H, G, perm, r):
    return _permuted_solve(solve_blocks_plain, Sinv, H, G, perm, r)


def apply_lowmem_plain(Sinv, C, B, perm, r):
    return _permuted_solve(solve_blocks_lowmem_plain, Sinv, C, B, perm, r)


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


_F32, _BF16 = torch.float32, torch.bfloat16
# (Sinv's storage, the other pair's) -> the instance's launch counter: K6
# in the full f32 layout, the hybrid one (f32 Sinv, bf16 H/G) and all
# bf16; K12 with bf16 C/B and bf16 or f32 Sinv
K6_INSTANCES = {(_F32, _F32): "banded_apply",
                (_F32, _BF16): "banded_apply_hybrid",
                (_BF16, _BF16): "banded_apply_bf16"}
K12_INSTANCES = {(_BF16, _BF16): "banded_apply_lowmem_bf16",
                 (_F32, _BF16): "banded_apply_lowmem_f32"}


def _check_factors(Sinv, M1, M2, names, instances):
    """(nb, c, counter): each factor contiguous (nb, c, c), M1 and M2 of one
    type, the storage pair one of `instances`, c a multiple of the entries
    of a 16-byte load (4 float32, 8 bf16)."""
    nb, c, _ = Sinv.shape
    name = instances.get((Sinv.dtype, M1.dtype))
    if name is None or M2.dtype != M1.dtype:
        raise ValueError(f"no banded kernel for Sinv {Sinv.dtype} with "
                         f"{names} {M1.dtype}/{M2.dtype}; instances: "
                         f"{sorted(instances.values())}")
    for label, M in (("Sinv", Sinv), *zip(names, (M1, M2))):
        build.require(M, label, M.dtype, (nb, c, c), Sinv.device)
    lane = 4 if Sinv.dtype == M1.dtype == _F32 else 8
    if c % lane:
        raise ValueError(f"{name} needs a block size divisible by {lane}, "
                         f"got {c}")
    return nb, c, name


def solve_blocks_cuda(Sinv, H, G, rb):
    nb, c, name = _check_factors(Sinv, H, G, ("H", "G"), K6_INSTANCES)
    build.require(rb, "rb", torch.float32, (nb, c), Sinv.device)
    x = rb.clone()
    w = torch.empty_like(x)
    build.check(build.library().vt_banded_solve(
        *map(build.ptr, (Sinv, H, G, x, w)), nb, c,
        int(Sinv.dtype == _BF16), int(H.dtype == _BF16),
        build.stream_handle(x.device)), name)
    build.LAUNCHES[name] += 1
    return x


def solve_blocks_lowmem_cuda(Sinv, C, B, rb):
    nb, c, name = _check_factors(Sinv, C, B, ("C", "B"), K12_INSTANCES)
    build.require(rb, "rb", torch.float32, (nb, c), Sinv.device)
    x = rb.clone()
    w = torch.empty_like(x)
    u = torch.empty(c, dtype=torch.float32, device=x.device)
    build.check(build.library().vt_banded_solve_lowmem(
        *map(build.ptr, (Sinv, C, B, x, w, u)), nb, c,
        int(Sinv.dtype == _BF16), build.stream_handle(x.device)), name)
    build.LAUNCHES[name] += 1
    return x


K21A_INSTANCES = {(_F32, _F32): "banded_carry",
                  (_F32, _BF16): "banded_carry_hybrid",
                  (_BF16, _BF16): "banded_carry_bf16"}
_STAGES = {"times": 0, "forward": 1, "backward": 2}


def carry_stage_cuda(Sinv, H, G, stage, a, carry=None):
    nb, c, name = _check_factors(Sinv, H, G, ("H", "G"), K21A_INSTANCES)
    M = _carry_factor(Sinv, H, G, stage)
    build.require(a, "a", torch.float32, (nb, c), Sinv.device)
    if carry is not None:
        build.require(carry, "carry", torch.float32, (c,), Sinv.device)
    y = torch.empty_like(a)
    build.check(build.library().vt_banded_carry(
        build.ptr(M), build.ptr(a), build.ptr(y), build.ptr(carry), nb, c,
        int(M.dtype == _BF16), int(H.dtype == _BF16), _STAGES[stage],
        build.stream_handle(a.device)), name)
    build.LAUNCHES[name] += 1
    return y


def carry_update_cuda(T, v, a):
    c = a.shape[0]
    for label, t, shape in (("T", T, (c, c)), ("v", v, (c,)), ("a", a, (c,))):
        build.require(t, label, torch.float32, shape, a.device)
    y = torch.empty_like(a)
    build.check(build.library().vt_banded_carry_update(
        *map(build.ptr, (T, v, a, y)), c, build.stream_handle(a.device)),
        "banded_carry_update")
    build.LAUNCHES["banded_carry_update"] += 1
    return y


def tri_residual_cuda(Cb, Db, Bb, x, r, xprev=None, xnext=None):
    m, c = x.shape
    dev = x.device
    for label, t in (("C", Cb), ("D", Db), ("B", Bb)):
        build.require(t, label, torch.float32, (m, c, c), dev)
    for label, t, shape in (("x", x, (m, c)), ("r", r, (m, c)),
                            ("xprev", xprev, (c,)), ("xnext", xnext, (c,))):
        if t is not None:
            build.require(t, label, torch.float32, shape, dev)
    y = torch.empty_like(x)
    build.check(build.library().vt_banded_tri_residual(
        *map(build.ptr, (Cb, Db, Bb, x, xprev, xnext, r, y)), m, c,
        build.stream_handle(dev)), "banded_tri_residual")
    build.LAUNCHES["banded_tri_residual"] += 1
    return y


def solve_blocks_carry_cuda(Sinv, H, G, rb, w_in=None, x_in=None):
    return _solve_carry(carry_stage_cuda, Sinv, H, G, rb, w_in, x_in)


def _permute_cuda(solve, F1, F2, F3, perm, r):
    lib = build.library()
    nb, c, _ = F1.shape
    dev, ndof = r.device, perm.shape[0]
    if r.dtype not in _FLOATS:
        raise ValueError(f"the banded apply takes a float32/float64 vector, "
                         f"got {r.dtype}")
    build.require(r, "r", r.dtype, (ndof,), dev)
    build.require(perm, "perm", torch.int64, (ndof,), dev)
    stream = build.stream_handle(dev)
    f64 = int(r.dtype == torch.float64)
    rp = torch.empty(nb * c, dtype=torch.float32, device=dev)
    build.check(lib.vt_banded_permute(build.ptr(r), f64, build.ptr(perm),
                                      ndof, nb * c, build.ptr(rp), stream),
                "banded_permute")
    x = solve(F1, F2, F3, rp.view(nb, c))
    out = torch.empty_like(r)
    build.check(lib.vt_banded_unpermute(build.ptr(x), build.ptr(perm), ndof,
                                        build.ptr(out), f64, stream),
                "banded_unpermute")
    return out


def apply_cuda(Sinv, H, G, perm, r):
    return _permute_cuda(solve_blocks_cuda, Sinv, H, G, perm, r)


def apply_lowmem_cuda(Sinv, C, B, perm, r):
    return _permute_cuda(solve_blocks_lowmem_cuda, Sinv, C, B, perm, r)


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


def apply_lowmem(Sinv, C, B, perm, r):
    if build.on_cuda(r, "banded_apply_lowmem"):
        return apply_lowmem_cuda(Sinv, C, B, perm, r)
    return apply_lowmem_plain(Sinv, C, B, perm, r)


def carry_stage(Sinv, H, G, stage, a, carry=None):
    if build.on_cuda(a, "banded_carry"):
        return carry_stage_cuda(Sinv, H, G, stage, a, carry)
    return carry_stage_plain(Sinv, H, G, stage, a, carry)


def tri_residual(Cb, Db, Bb, x, r, xprev=None, xnext=None):
    if build.on_cuda(x, "banded_tri_residual"):
        return tri_residual_cuda(Cb, Db, Bb, x, r, xprev, xnext)
    return tri_residual_plain(Cb, Db, Bb, x, r, xprev, xnext)


def carry_update(T, v, a):
    if build.on_cuda(a, "banded_carry_update"):
        return carry_update_cuda(T, v, a)
    return carry_update_plain(T, v, a)
