"""Block-tridiagonal (RCM-banded) direct preconditioner of the iterative
Newton path.

Counterpart of vasp_tpu.fem.banded. Under an RCM ordering the
Ruiz-equilibrated FSI Jacobian is banded; cutting the ordered dofs into
nb blocks of c = bandwidth makes it exactly block-tridiagonal, and the
block-Thomas LU

    S_1 = D_1,   S_k = D_k - C_k S_{k-1}^{-1} B_{k-1}

is a direct factorization. The factors are stored as explicit inverses
(Sinv, H = Sinv C, G = Sinv B), so the solve is two scans of
matrix-vector products:

    w_k = Sinv_k r_k - H_k w_{k-1}      (forward)
    x_k = w_k - G_k x_{k+1}             (backward)

Layouts (``banded_layout`` picks one from the device's free memory):
"full" stores Sinv, H and G, all float32 or all bf16; "hybrid" a float32
Sinv with bf16 H/G, formed after the scan once D is freed, without a
probe; "bf16" and "f32" store only Sinv (in that type) beside bf16 copies
of C and B, and the apply folds H w = Sinv (C w) and G x = Sinv (B x) in
(``make_banded_apply_lowmem``, K12). vasp_tpu's functions map onto these:
factorize_banded_lowmem and factorize_banded_sinv32 are ``schur_scan``
with bf16 and float32 storage, factorize_banded_f64_lowmem is
``schur_scan_f64``.

Host (numpy, once per mesh): the ordering and block size
(``build_banded_pattern``), the identity slots of bc and padding rows
(``identity_diag_slots``) and the assembly plan
(``build_banded_assembly_plan``). Device: the assembly (K8) and the
applies (K6, K12) are the hand-written kernels of kernels/banded.py; the
Schur scan (K9) runs torch.matmul and torch.linalg.inv (cuBLAS/cuSOLVER
on the card), with one Newton polish per block inverse, and the probe
(K10) is the K6 scans plus batched torch.matmul. The escalation tier's
scan (K11, ``schur_scan_f64``) runs the same recursion in native float64.

Not ported: the spectral ordering, clip/qclip and their VASP_BANDED_*
environment knobs, the blocked Schur inversion ``_inv_blocked`` and the
f32-seeded float64 inverse ``_inv64`` (TPU workarounds: a matrix-unit
inverse, and a float64 inverse on a chip without a float64 LU).
"""
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from vasp_tpu_torch import native
from vasp_tpu_torch.kernels import banded as kb
from vasp_tpu_torch.kernels import build


@dataclass
class BandedPattern:
    """Static ordering data (depends on mesh/dofmap only)."""

    perm: np.ndarray  # (ndof,) permuted position q holds original dof perm[q]
    iperm: np.ndarray  # (ndof,) original dof i sits at permuted position
    c: int  # block size == RCM bandwidth (padded)
    nb: int  # number of blocks
    ndof: int

    @property
    def npad(self):
        return self.nb * self.c

    @property
    def factor_bytes(self):
        """Bytes of one f32 (nb, c, c) block storage (C, D, B, Sinv, H or
        G)."""
        return 4 * self.nb * self.c * self.c


def build_banded_pattern(block_dofs, ndof, lane_multiple=8, timings=None):
    """Order the dof graph by RCM and size the blocks to its bandwidth.

    block_dofs: list of (K, nloc) global dof arrays (one per assembler
    block); the graph is the union of their pairwise couplings. timings:
    optional dict that receives the RCM's seconds under "rcm"."""
    import time

    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows, cols = [], []
    for dofs in block_dofs:
        dofs = np.asarray(dofs)
        K, nloc = dofs.shape
        rows.append(np.repeat(dofs, nloc, axis=1).reshape(-1))
        cols.append(np.tile(dofs, (1, nloc)).reshape(-1))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    adj = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                        shape=(ndof, ndof)).tocsr()
    adj = adj + adj.T
    tic = time.perf_counter()
    perm = native.rcm_order(adj.indptr, adj.indices, ndof)
    if perm is None:
        perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    if timings is not None:
        timings["rcm"] = time.perf_counter() - tic
    perm = np.asarray(perm, np.int64)
    iperm = np.empty(ndof, np.int64)
    iperm[perm] = np.arange(ndof)
    # bandwidth of the permuted graph
    c = max(1, int(np.abs(iperm[rows] - iperm[cols]).max()))
    c += (-c) % lane_multiple  # keep the lane dimension tidy
    nb = max(1, -(-ndof // c))
    return BandedPattern(perm=perm, iperm=iperm, c=c, nb=nb, ndof=ndof)


def identity_diag_slots(pattern: BandedPattern, bc_mask_np):
    """Flat indices (into the D storage) of the diagonal slots that get
    +1: bc dofs and padding rows."""
    c = pattern.c
    q = pattern.iperm[np.nonzero(np.asarray(bc_mask_np))[0]]
    q = np.concatenate([q, np.arange(pattern.ndof, pattern.npad)])
    return (q // c) * c * c + (q % c) * c + (q % c)


def build_banded_assembly_plan(block_dofs, pattern: BandedPattern,
                               bc_mask_np):
    """Host-precomputed scatter targets of the banded assembly.

    Per block and per target matrix t in (C, D, B): src gathers the
    in-band, non-bc entries out of the flattened (K, 64, 64) element
    matrices, dst is their flat slot in that matrix's (nb c c,) storage,
    both sorted by dst (stable), and (udst, starts) split the sorted run
    into one segment per unique slot. int32 numpy arrays: nb c^2 must stay
    below 2^31 (checked)."""
    c, nb = pattern.c, pattern.nb
    size = nb * c * c
    if size + 1 >= 2 ** 31:
        raise ValueError(f"banded storage of {size} entries exceeds int32 "
                         f"indexing")
    iperm = pattern.iperm.astype(np.int64)
    mask = np.asarray(bc_mask_np, bool)
    plans = []
    for dofs in block_dofs:
        dofs = np.asarray(dofs)
        pi = iperm[dofs]  # (K, nloc)
        ok = ~mask[dofs]
        k = pi // c
        row = pi % c
        o = pi[:, None, :] - (k[:, :, None] - 1) * c
        t = o // c  # 0 = C, 1 = D, 2 = B
        oc = o % c
        flat = (k[:, :, None] * c + row[:, :, None]) * c + oc
        valid = ok[:, None, :] & ok[:, :, None]
        per_t = []
        tt = t.reshape(-1)
        vv = valid.reshape(-1)
        ff = flat.reshape(-1)
        for tsel in (0, 1, 2):
            src = np.nonzero(vv & (tt == tsel))[0]
            dst = ff[src]
            order = np.argsort(dst, kind="stable")
            src, dst = src[order], dst[order]
            udst, starts = np.unique(dst, return_index=True)
            per_t.append(dict(src=src.astype(np.int32),
                              dst=dst.astype(np.int32),
                              udst=udst.astype(np.int32),
                              starts=starts.astype(np.int32)))
        plans.append(per_t)
    return plans


def plans_to_device(plans, device):
    return [[{k: torch.as_tensor(v, device=device) for k, v in p.items()}
             for p in per_t] for per_t in plans]


def assemble_banded_planned(jacs, plans, pattern: BandedPattern, diag_flat):
    """(C, D, B) f32 (nb, c, c) from the scaled element matrices by the
    plan (K8), identity on bc and padding rows of D."""
    return kb.assemble(jacs, plans, pattern.nb, pattern.c, diag_flat)


def schur_scan(Cm, D, Bm, factor_dtype=torch.float32):
    """Sinv (nb, c, c) of the block-Thomas recursion (K9) in float32:
    S_k = D_k - C_k G_{k-1}, Sinv_k = S_k^{-1} with one Newton polish
    X <- X (2I - S X), G_k = Sinv_k B_k; each block's polished inverse is
    stored in factor_dtype (float32, or bf16 rounded to nearest even,
    while the recursion carries the exact float32 G_k)."""
    G0 = torch.zeros(D.shape[1:], dtype=torch.float32, device=D.device)
    return schur_scan_carry(Cm, D, Bm, G0, factor_dtype)[0]


def schur_scan_carry(Cm, D, Bm, G0, factor_dtype=torch.float32):
    """schur_scan from an incoming carry G0 (the G of the block before
    D[0]; zero for the first): (Sinv, the last G_k), the sharded path's
    phase of one rank (parallel/banded_shard.py)."""
    nb, c, _ = D.shape
    eye2 = 2.0 * torch.eye(c, dtype=torch.float32, device=D.device)
    Sinv = torch.empty(D.shape, dtype=factor_dtype, device=D.device)
    Gprev = G0
    for k in range(nb):
        S = D[k] - Cm[k] @ Gprev
        Si = torch.linalg.inv(S)
        Si = Si @ (eye2 - S @ Si)
        Gprev = Si @ Bm[k]
        Sinv[k] = Si
    return Sinv, Gprev


# bytes of the float32 products Sinv_k X_k that sinv_times forms at once
_CHUNK_BYTES = 2 ** 29


def sinv_times(Sinv, X, dtype):
    """(Sinv_k X_k) for every block, float32 products (a bf16 Sinv widened
    exactly) stored in `dtype`, formed a chunk of blocks at a time into
    preallocated storage: no full-size float32 temporary exists."""
    nb, c, _ = X.shape
    out = torch.empty(X.shape, dtype=dtype, device=X.device)
    step = max(1, _CHUNK_BYTES // (4 * c * c))
    for k in range(0, nb, step):
        out[k:k + step] = torch.matmul(Sinv[k:k + step].float(),
                                       X[k:k + step])
    return out


def hg_factors(Sinv, Cm, Bm):
    """H = Sinv C and G = Sinv B, stored in Sinv's dtype."""
    return sinv_times(Sinv, Cm, Sinv.dtype), sinv_times(Sinv, Bm, Sinv.dtype)


def probe_rel(Cm, D, Bm, Sinv, H, G):
    """Solve quality of the stored factors against the banded operator:
    ||T M b - b|| / ||b|| for the +-1 probe b, T the block-tridiagonal
    matvec of (C, D, B), M the two-scan solve (K10)."""
    nb, c, _ = D.shape
    b = torch.where(torch.arange(nb * c, device=D.device) % 2 == 0, 1.0,
                    -1.0).to(torch.float32).view(nb, c)
    x = kb.solve_blocks(Sinv, H, G, b)
    y = kb.bgemv(D, x)
    y[1:] += kb.bgemv(Cm[1:], x[:-1])
    y[:-1] += kb.bgemv(Bm[:-1], x[1:])
    return float(torch.linalg.norm(y - b) / torch.linalg.norm(b))


def factorize_banded(Cm, D, Bm, factor_dtype=torch.float32):
    """(Sinv, H, G, probe rel) — vasp_tpu's factorize_banded with the LU
    inverse (inv_levels=0): the factors stored in factor_dtype (float32 or
    bf16), the probe taken on the stored factors."""
    Sinv = schur_scan(Cm, D, Bm, factor_dtype)
    H, G = hg_factors(Sinv, Cm, Bm)
    return Sinv, H, G, probe_rel(Cm, D, Bm, Sinv, H, G)


def schur_scan_f64(Cm, D, Bm):
    """Sinv (nb, c, c) f32 of the block-Thomas recursion in float64 (K11):
    S_k = D_k - C_k G_{k-1}, Sinv_k = S_k^{-1} and G_k = Sinv_k B_k all in
    float64 (native on the card: cuBLAS DGEMM and the cuSOLVER LU
    inverse, where vasp_tpu polishes an f32-seeded inverse), Sinv stored
    in float32. Counted in build.LAUNCHES on the card, as the hand-written
    kernels are."""
    G0 = torch.zeros(D.shape[1:], dtype=torch.float64, device=D.device)
    return schur_scan_f64_carry(Cm, D, Bm, G0)[0]


def schur_scan_f64_carry(Cm, D, Bm, G0, factor_dtype=torch.float32):
    """schur_scan_f64 from an incoming float64 carry G0, Sinv stored in
    factor_dtype: (Sinv, the last float64 G_k)."""
    Sinv = torch.empty(D.shape, dtype=factor_dtype, device=D.device)
    Gprev = G0
    for k in range(D.shape[0]):
        S = D[k].double() - Cm[k].double() @ Gprev
        Si = torch.linalg.inv(S)
        Gprev = Si @ Bm[k].double()
        Sinv[k] = Si
    if D.is_cuda:
        build.LAUNCHES["banded_factorize_f64"] += 1
    return Sinv, Gprev


def factorize_banded_f64(Cm, D, Bm):
    """(Sinv, H, G) f32 — vasp_tpu's factorize_banded_f64 (K11), the
    escalation tier for Schur blocks too ill-conditioned for the float32
    recursion: the float64 scan, then H = Sinv C and G = Sinv B from the
    stored float32 Sinv as in hg_factors, whatever storage the layout
    takes otherwise. No probe: vasp_tpu takes none on this tier."""
    Sinv = schur_scan_f64(Cm, D, Bm)
    return (Sinv, *hg_factors(Sinv, Cm, Bm))


def make_banded_apply(pattern: BandedPattern, device):
    """Returns apply(Sinv, H, G, r) -> M r (same dtype as r), the K6
    kernels on a CUDA r."""
    perm = torch.as_tensor(pattern.perm, device=device)

    def apply(Sinv, H, G, r):
        return kb.apply(Sinv, H, G, perm, r)

    return apply


def make_banded_apply_lowmem(pattern: BandedPattern, device):
    """Returns apply(Sinv, C, B, r) -> M r (same dtype as r), the apply
    with H = Sinv C and G = Sinv B folded in; the K12 kernels on a CUDA
    r."""
    perm = torch.as_tensor(pattern.perm, device=device)

    def apply(Sinv, Cm, Bm, r):
        return kb.apply_lowmem(Sinv, Cm, Bm, perm, r)

    return apply


class BandedLayout(NamedTuple):
    """What banded_layout chose: the layout ("full", "hybrid", "bf16" or
    "f32"), the full layout's and the chosen layout's peak bytes, the float64
    factor tier's (K11) peak under the chosen layout, and whether that tier
    fits."""

    layout: str
    full_bytes: int
    bytes: int
    f64_bytes: int
    f64_fits: bool


# the peak of each layout's rebuild in float32 (nb, c, c) arrays, F each:
# full, C/D/B with Sinv/H/G (6 F, 4.5 F in bf16: all six live at the
# probe); hybrid, C/D/B with the f32 Sinv (4 F; D, C and B are freed as the
# bf16 H and G are formed); the Sinv-only layouts, C/D/B with Sinv (4 F
# with f32 Sinv, 3.5 F with bf16), D then freed and C/B cast to bf16
_PEAK_F = {("full", "f32"): 6.0, ("full", "bf16"): 4.5, ("hybrid", None): 4.0,
           ("f32", None): 4.0, ("bf16", None): 3.5}
# the float64 tier's peak under each layout: its scan stores a float32
# Sinv whatever the layout's storage, and under the full layout hg_factors
# then forms float32 H/G (6 F); the other layouts hold C/D/B with it (4 F)
_F64_PEAK_F = {"full": 6.0, "hybrid": 4.0, "f32": 4.0, "bf16": 4.0}
# the low-memory layout each banded_factor_dtype falls back to (vasp_tpu's
# lowmem mapping, vasp_tpu/fem/timestepper.py:431-434)
_FALLBACK = {None: "hybrid", "hybrid": "hybrid", "bf16": "bf16",
             "f32": "f32"}


def element_jacobian_bytes(block_sizes, itemsize=4):
    """Bytes of one set of element Jacobians: block_sizes lists each
    block's (K, n) (K cells of n local dofs)."""
    return sum(itemsize * K * n * n for K, n in block_sizes)


def banded_layout(pattern: BandedPattern, block_sizes, free_bytes,
                  banded_factor_dtype=None):
    """The factor layout that fits `free_bytes` of device memory
    (vasp_tpu's 7 GiB lowmem switch and 11 GiB escalation gate, sized by
    the device instead): the full layout (all float32, all bf16 for
    banded_factor_dtype="bf16") where it fits, else the low-memory layout
    of vasp_tpu's mapping (None and "hybrid": "hybrid", f32 Sinv with bf16
    H/G; "bf16"/"f32": Sinv-only in that type). Each peak counts the
    layout's rebuild arrays, two float32 element Jacobian sets (the Newton
    loop's and the rebuild's, which the equilibration copies), sixteen
    c x c float32 temporaries of the scan and its inverses and two of
    sinv_times' chunks (measured peaks on an H100 at c = 4,488, nb = 42 sit
    1.0-1.7 GiB under these); the float64 tier's counts the float32
    factors it stores under the layout and its six c x c float64
    temporaries. Raises, naming the bytes, where neither the full layout
    nor the fallback fits."""
    F = pattern.factor_bytes
    c2 = pattern.c * pattern.c
    chunk = min(max(1, _CHUNK_BYTES // (4 * c2)), pattern.nb) * 4 * c2
    base = 2 * element_jacobian_bytes(block_sizes) + 16 * 4 * c2 + 2 * chunk
    f64_temps = 6 * 8 * c2
    full_dt = "bf16" if banded_factor_dtype == "bf16" else "f32"
    full = int(_PEAK_F["full", full_dt] * F) + base
    layout = _FALLBACK[banded_factor_dtype]
    need = int(_PEAK_F[layout, None] * F) + base
    if full <= free_bytes:
        layout, need = "full", full
    elif need > free_bytes:
        raise MemoryError(
            f"the banded preconditioner at c={pattern.c}, nb={pattern.nb} "
            f"needs {full / 2**30:.2f} GiB in the full layout, "
            f"{need / 2**30:.2f} GiB in the {layout} layout; "
            f"{free_bytes / 2**30:.2f} GiB of device memory are free")
    f64 = int(_F64_PEAK_F[layout] * F) + base + f64_temps
    return BandedLayout(layout, full, need, f64, f64 <= free_bytes)


def device_free_bytes(device):
    """Free memory of the device: torch.cuda.mem_get_info's on a card, the
    host's available memory on the CPU (MemAvailable, which counts the
    page cache the kernel can reclaim; the free pages where the kernel
    does not report it)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
