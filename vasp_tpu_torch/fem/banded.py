"""Block-tridiagonal (RCM-banded) direct preconditioner of the iterative
Newton path.

Counterpart of vasp_tpu.fem.banded, plain f32 layout. Under an RCM ordering
the Ruiz-equilibrated FSI Jacobian is banded; cutting the ordered dofs into
nb blocks of c = bandwidth makes it exactly block-tridiagonal, and the
block-Thomas LU

    S_1 = D_1,   S_k = D_k - C_k S_{k-1}^{-1} B_{k-1}

is a direct factorization. The factors are stored as explicit inverses
(Sinv, H = Sinv C, G = Sinv B, all f32), so the solve is two scans of
matrix-vector products:

    w_k = Sinv_k r_k - H_k w_{k-1}      (forward)
    x_k = w_k - G_k x_{k+1}             (backward)

Host (numpy, once per mesh): the ordering and block size
(``build_banded_pattern``), the identity slots of bc and padding rows
(``identity_diag_slots``) and the assembly plan
(``build_banded_assembly_plan``). Device: the assembly (K8) and the apply
(K6) are the hand-written kernels of kernels/banded.py; the Schur scan
(K9) runs torch.matmul and torch.linalg.inv (cuBLAS/cuSOLVER on the card),
with one Newton polish per block inverse, and the probe (K10) is the K6
scans plus batched torch.matmul. The escalation tier's scan (K11,
``factorize_banded_f64``) runs the same recursion in native float64.

Not ported: the spectral ordering, clip/qclip and their VASP_BANDED_*
environment knobs, the blocked Schur inversion ``_inv_blocked`` and the
f32-seeded float64 inverse ``_inv64`` (TPU workarounds: a matrix-unit
inverse, and a float64 inverse on a chip without a float64 LU), and the
lowmem layouts (ROADMAP.md queue 1, item 9).
"""
from dataclasses import dataclass

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


def schur_scan(Cm, D, Bm):
    """Sinv (nb, c, c) f32 of the block-Thomas recursion (K9):
    S_k = D_k - C_k G_{k-1}, Sinv_k = S_k^{-1} with one Newton polish
    X <- X (2I - S X), G_k = Sinv_k B_k."""
    nb, c, _ = D.shape
    eye2 = 2.0 * torch.eye(c, dtype=torch.float32, device=D.device)
    Sinv = torch.empty_like(D)
    Gprev = torch.zeros((c, c), dtype=torch.float32, device=D.device)
    for k in range(nb):
        S = D[k] - Cm[k] @ Gprev
        Si = torch.linalg.inv(S)
        Si = Si @ (eye2 - S @ Si)
        Gprev = Si @ Bm[k]
        Sinv[k] = Si
    return Sinv


def hg_factors(Sinv, Cm, Bm):
    """H = Sinv C and G = Sinv B as batched products."""
    return torch.matmul(Sinv, Cm), torch.matmul(Sinv, Bm)


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


def factorize_banded(Cm, D, Bm):
    """(Sinv, H, G, probe rel) — vasp_tpu's factorize_banded with f32
    factor storage and the LU inverse (inv_levels=0)."""
    Sinv = schur_scan(Cm, D, Bm)
    H, G = hg_factors(Sinv, Cm, Bm)
    return Sinv, H, G, probe_rel(Cm, D, Bm, Sinv, H, G)


def schur_scan_f64(Cm, D, Bm):
    """Sinv (nb, c, c) f32 of the block-Thomas recursion in float64 (K11):
    S_k = D_k - C_k G_{k-1}, Sinv_k = S_k^{-1} and G_k = Sinv_k B_k all in
    float64 (native on the card: cuBLAS DGEMM and the cuSOLVER LU
    inverse, where vasp_tpu polishes an f32-seeded inverse), Sinv stored
    in float32. Counted in build.LAUNCHES on the card, as the hand-written
    kernels are."""
    nb, c, _ = D.shape
    Sinv = torch.empty_like(D)
    Gprev = torch.zeros((c, c), dtype=torch.float64, device=D.device)
    for k in range(nb):
        S = D[k].double() - Cm[k].double() @ Gprev
        Si = torch.linalg.inv(S)
        Gprev = Si @ Bm[k].double()
        Sinv[k] = Si
    if D.is_cuda:
        build.LAUNCHES["banded_factorize_f64"] += 1
    return Sinv


def factorize_banded_f64(Cm, D, Bm):
    """(Sinv, H, G) f32 — vasp_tpu's factorize_banded_f64 (K11), the
    escalation tier for Schur blocks too ill-conditioned for the float32
    recursion: the float64 scan, then H = Sinv C and G = Sinv B from the
    stored float32 Sinv as in hg_factors. No probe: vasp_tpu takes none on
    this tier."""
    Sinv = schur_scan_f64(Cm, D, Bm)
    return (Sinv, *hg_factors(Sinv, Cm, Bm))


def make_banded_apply(pattern: BandedPattern, device):
    """Returns apply(Sinv, H, G, r) -> M r (same dtype as r), the K6
    kernels on a CUDA r."""
    perm = torch.as_tensor(pattern.perm, device=device)

    def apply(Sinv, H, G, r):
        return kb.apply(Sinv, H, G, perm, r)

    return apply
