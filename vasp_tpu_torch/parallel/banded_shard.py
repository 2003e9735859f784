"""Dof-sharded Newton-Krylov with the sharded banded preconditioner (K21),
one process per rank on torch.distributed.

Counterpart of vasp_tpu/parallel/banded_shard.py (the reference scales by
MPI domain decomposition, `mpirun -np N turtleFSI`). Every dof-indexed
vector lives in the RCM-permuted order of the banded pattern, cut into n
contiguous spans of nb_loc blocks of c = the bandwidth; every element's
dofs then fall inside [its owner's span start, + span + c), so a rank needs
only a right halo of c dofs. Elements belong to the rank that owns their
smallest permuted dof (``partition_blocks``, host numpy copied from
vasp_tpu); each rank assembles into its extended vector [span | halo |
dump slot] and ships the halo contributions right (parallel/comm.py).

One rank, per Newton step (``ShardedBandedStepper._newton``): the element
residuals (K1/K2, float32 ones under residual_dtype="f32", the Taylor
delta K13 in its endgame) and Jacobians (K3) of its elements, the Robin
facet terms (K14) with them, and right-preconditioned GMRES (K5) with
summed reductions over the element matvec (K4). Per rebuild
(``_rebuild``): float32 Jacobians, Ruiz scales with halo-max combines (K7,
``sharded_ruiz``), the banded assembly of its nb_loc + 1 block rows on a
rank-local plan (K8, ``sharded_assemble_banded``) whose halo row goes to
the right neighbour (``merge_halo_blockrow``), the Schur scan phase by
phase, rank p after rank p - 1 with the float32 (or, on the float64
factor tier, float64: K11) carry G (K21b, ``sharded_factorize``), H and
G, for the chain the transfer products (K21c,
``sharded_transfer_products``) and the probe. The apply is K21a
(kernels/banded.py carry_stage, carry_update) between the exchanges:
``make_sharded_chain_apply`` (the default) or ``make_sharded_banded_apply``
(algo="thomas"). Factors stay on their rank: memory / n, no scaling of a
Thomas scan's time.

algo="spike" is vasp_tpu's SPIKE (K21f): each rank factorizes its own
blocks with no carry (``local_thomas``), the spikes' corners and a reduced
interface recursion (``sharded_factorize_spike``) replace the phase chain, and the
apply (``make_sharded_spike_apply``) runs K21a's stages as local solves,
carry_update for the reduced sweeps and corrections, and ``spike_refine``
passes of iterative refinement on the residual K21f-a (kernels/banded.py
tri_residual).

vasp_tpu's semantics are kept, its quirks included (hybrid residuals only
for residual_dtype="f32", so "f32f" and "mixed" run raw float64 residuals
here; no re-anchoring of the delta endgame; the Newton loop's own stall
rule and full-step-first search), and its host ladder. vasp_tpu's
VASP_SHARD_ALGO / VASP_SPIKE_REFINE environment variables are the
constructor's ``algo`` and ``spike_refine`` (the config keys
``shard_algo`` and ``spike_refine``).
"""
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from vasp_tpu_torch.fem import banded as banded_mod
from vasp_tpu_torch.fem.assembly import Assembler, CellBlock, FacetBlock
from vasp_tpu_torch.fem.krylov import gmres
from vasp_tpu_torch.fem.timestepper import StepOptions, _backtrack_update
from vasp_tpu_torch.kernels import banded as kb
from vasp_tpu_torch.kernels import scaling as ks
from vasp_tpu_torch.parallel.comm import Collectives

ALGOS = ("chain", "thomas", "spike")


def check_algo(algo):
    """Raise for a shard_algo other than ALGOS."""
    if algo not in ALGOS:
        raise ValueError(f"shard_algo={algo!r}: expected one of {ALGOS}")


# ---------------------------------------------------------------- setup
@dataclass
class ShardPlan:
    """Static partition data (host-precomputed)."""

    c: int          # block size == RCM bandwidth (padded)
    nb_loc: int     # blocks per rank
    span: int       # dofs per rank == nb_loc * c
    n: int          # ranks
    ndof: int
    npad: int       # n * span
    perm: np.ndarray    # (ndof,) permuted position q holds original dof
    iperm: np.ndarray   # (ndof,) original dof -> permuted position


def build_shard_plan(block_dofs, ndof, n_devices):
    pat = banded_mod.build_banded_pattern(block_dofs, ndof)
    c = pat.c
    nb = max(pat.nb, n_devices)
    nb += (-nb) % n_devices
    nb_loc = nb // n_devices
    span = nb_loc * c
    return ShardPlan(c=c, nb_loc=nb_loc, span=span, n=n_devices, ndof=ndof,
                     npad=n_devices * span, perm=pat.perm, iperm=pat.iperm)


def partition_blocks(system, plan: ShardPlan):
    """Assign elements to ranks and build per-rank LOCAL dof tables.

    Returns (skeleton, arrays) where each array has leading axis n (one row
    per rank, padded to a common K_loc) and dof tables index the rank's
    extended vector [0, span + c] (slot span + c is the dump slot for
    padded elements and bc-free scatter)."""
    n, span, c = plan.n, plan.span, plan.c
    dump = span + c
    skeleton, arrays = [], []
    for b in system.assembler.blocks:
        dofs = b.dofs.cpu().numpy()
        pi = plan.iperm[dofs]  # (K, nloc) permuted dof ids
        owner = pi.min(axis=1) // span
        owner = np.clip(owner, 0, n - 1)
        ext = pi - owner[:, None] * span  # local extended index
        if ext.min() < 0 or ext.max() >= span + c:
            raise ValueError("an element spans more than one halo: the "
                             "bandwidth is violated")
        K_loc = max(1, int(np.bincount(owner, minlength=n).max()))
        is_cell = isinstance(b, CellBlock)
        has_mask = is_cell and b.rowmask is not None
        if is_cell:
            data = dict(
                dofs=np.full((n, K_loc, dofs.shape[1]), dump, np.int32),
                Jinv=np.tile(np.eye(3), (n, K_loc, 1, 1)),
                detJ=np.zeros((n, K_loc)),
                vol=np.ones((n, K_loc)),
            )
            if has_mask:
                # padded elements keep 1.0: they scatter to the dump slot
                data["rowmask"] = np.ones(
                    (n, K_loc, dofs.shape[1]), np.float32)
        else:
            data = dict(
                dofs=np.full((n, K_loc, dofs.shape[1]), dump, np.int32),
                area2=np.zeros((n, K_loc)),
            )
        for dev in range(n):
            sel = np.nonzero(owner == dev)[0]
            k = len(sel)
            data["dofs"][dev, :k] = ext[sel]
            if is_cell:
                data["Jinv"][dev, :k] = b.Jinv.cpu().numpy()[sel]
                data["detJ"][dev, :k] = b.detJ.cpu().numpy()[sel]
                data["vol"][dev, :k] = b.vol.cpu().numpy()[sel]
                if has_mask:
                    data["rowmask"][dev, :k] = b.rowmask.cpu().numpy()[sel]
            else:
                data["area2"][dev, :k] = b.area2.cpu().numpy()[sel]
        skeleton.append(("cell" if is_cell else "facet", b.name, b.kernel))
        arrays.append(data)
    return skeleton, arrays


def rank_blocks(skeleton, arrays, rank, device):
    """The rank's row of partition_blocks as CellBlock / FacetBlock objects
    on `device` (dofs int64, the rest float64)."""
    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    blocks = []
    for (kind, name, kernel), data in zip(skeleton, arrays):
        dofs = torch.as_tensor(data["dofs"][rank], dtype=torch.int64,
                               device=device)
        if kind == "cell":
            rowmask = data.get("rowmask")
            blocks.append(CellBlock(
                name=name, kernel=kernel, dofs=dofs,
                Jinv=f64(data["Jinv"][rank]), detJ=f64(data["detJ"][rank]),
                vol=f64(data["vol"][rank]),
                rowmask=None if rowmask is None else f64(rowmask[rank])))
        else:
            blocks.append(FacetBlock(name=name, kernel=kernel, dofs=dofs,
                                     area2=f64(data["area2"][rank])))
    return blocks


def rank_assembly_plan(block_dofs, plan: ShardPlan, mask_ext):
    """K8's plan for the rank's nb_loc + 1 block rows (the last one the
    halo row) from its local extended dof tables: vasp_tpu's local
    scatter targets (banded_shard.py:322-343), the bc dofs of the extended
    mask and the dump slot left out."""
    size = plan.span + plan.c + 1
    ident = np.arange(size, dtype=np.int64)
    pattern = banded_mod.BandedPattern(perm=ident, iperm=ident, c=plan.c,
                                       nb=plan.nb_loc + 1, ndof=size)
    skip = np.asarray(mask_ext, bool).copy()
    skip[-1] = True  # the dump slot
    return banded_mod.build_banded_assembly_plan(block_dofs, pattern, skip)


# ------------------------------------------------------------- rank ops
def sharded_ruiz(blocks, jacs, mask_loc, mask_ext, comm, sweeps):
    """Ruiz equilibration with halo-max combines (fem/scaling.py
    semantics, dof-sharded; K7's sweep on the rank's elements)."""
    span = mask_loc.shape[0]
    size = span + comm.c + 1
    dty, dev = jacs[0].dtype, jacs[0].device
    dr = torch.ones(span, dtype=dty, device=dev)
    dc = torch.ones(span, dtype=dty, device=dev)
    floor = torch.tensor(1e-30, dtype=dty, device=dev)
    for _ in range(sweeps):
        dr_ext = comm.ext_gather(dr)
        dc_ext = comm.ext_gather(dc)
        rmax = torch.zeros(size, dtype=dty, device=dev)
        cmax = torch.zeros(size, dtype=dty, device=dev)
        for b, A in zip(blocks, jacs):
            ks.ruiz_sweep(A, b.dofs, dr_ext, dc_ext, mask_ext, rmax, cmax)
        rmax = comm.halo_max(rmax)
        cmax = comm.halo_max(cmax)
        dr = dr / torch.sqrt(torch.maximum(rmax, floor))
        dc = dc / torch.sqrt(torch.maximum(cmax, floor))
        dr = torch.where(mask_loc, 1.0, dr)
        dc = torch.where(mask_loc, 1.0, dc)
    return dr, dc


def sharded_assemble_banded(blocks, jacs, dr_ext, dc_ext, plans, plan,
                            diag_loc):
    """(C, D, B) float32 (nb_loc + 1, c, c) of the rank: its scaled element
    Jacobians (K7's scale) scattered by its plan (K8), +1 on the identity
    slots of its bc and padding rows. The last block row is the halo row
    (merge_halo_blockrow)."""
    jf = [ks.ruiz_scale(A, b.dofs, dr_ext, dc_ext)
          for b, A in zip(blocks, jacs)]
    return kb.assemble(jf, plans, plan.nb_loc + 1, plan.c, diag_loc)


def merge_halo_blockrow(Cm, D, Bm, comm):
    """The halo block row of each rank added into its right neighbour's
    block 0 (its B is structurally empty: its columns would leave the
    extended range); (C, D, B) of nb_loc rows."""
    recv = comm.shift_right(torch.stack([D[-1], Cm[-1]]))
    D, Cm, Bm = D[:-1], Cm[:-1], Bm[:-1]
    D[0] += recv[0]
    Cm[0] += recv[1]
    return Cm, D, Bm


def sharded_factorize(Cm, D, Bm, comm, factor_dtype=torch.float32,
                      f64=False):
    """K21b: the phase-sequential block-Thomas factorization: rank p runs
    the Schur scan of its nb_loc blocks (K9; K11's float64 recursion with
    f64) from the carry G of rank p - 1 and hands its last G to p + 1;
    then H = Sinv C, G = Sinv B (the factors stay on their rank, H_0
    coupling to the left neighbour)."""
    c = D.shape[1]
    gdt = torch.float64 if f64 else torch.float32
    G = torch.zeros((c, c), dtype=gdt, device=D.device)
    Sinv = Glast = None
    for p in range(comm.n):
        if comm.rank == p:
            if f64:
                Sinv, Glast = banded_mod.schur_scan_f64_carry(
                    Cm, D, Bm, G, factor_dtype)
            else:
                Sinv, Glast = banded_mod.schur_scan_carry(
                    Cm, D, Bm, G, factor_dtype)
        if p < comm.n - 1:
            G = comm.ppermute(Glast if comm.rank == p else G, p, p + 1)
    H, Gm = banded_mod.hg_factors(Sinv, Cm, Bm)
    return Sinv, H, Gm


def sharded_transfer_products(H, G):
    """K21c: the rank's carry-transfer operators, Tf = prod_{k=m-1..0}
    (-H_k) (the forward chain: dw_{m-1} = Tf w_in) and Tb = prod_{k=0..m-1}
    (-G_k) (the backward chain: dx_0 = Tb x_in), float32 products."""
    c = H.shape[1]
    Tf = torch.eye(c, dtype=torch.float32, device=H.device)
    for k in range(H.shape[0]):
        Tf = -(H[k].float() @ Tf)
    Tb = torch.eye(c, dtype=torch.float32, device=G.device)
    for k in range(G.shape[0] - 1, -1, -1):
        Tb = -(G[k].float() @ Tb)
    return Tf, Tb


def make_sharded_chain_apply(plan: ShardPlan, comm):
    """apply(F, r_loc) -> M r, the default apply: each triangular solve as a
    zero-carry local scan, an (n - 1)-phase chain of c-vector carry
    updates through Tf / Tb, and the local scan again with the true carry
    (the sequential recurrence, its carry arriving through the chain).

    vasp_tpu's SPMD program runs every scan on every rank; here each rank
    runs only the scans whose result it uses. Rank 0 has no incoming
    forward carry (its true-carry forward scan is its zero-carry one) and
    sends no backward one (no zero-carry backward scan); the last rank
    sends no forward carry (no zero-carry forward scan) and has no
    incoming backward one (its true-carry backward scan is its zero-carry
    one). So the end ranks run one scan each way, as in a Thomas apply,
    the interior ranks two; the results are vasp_tpu's, scan for scan."""
    c, n, m = plan.c, plan.n, plan.nb_loc
    rank = comm.rank
    first, last = rank == 0, rank == n - 1

    def apply(F, r_loc):
        Sinv, H, G = F["Sinv"], F["H"], F["G"]
        rb = r_loc.to(torch.float32).reshape(m, c)
        t = kb.carry_stage(Sinv, H, G, "times", rb)
        wz = (kb.carry_stage(Sinv, H, G, "forward", t) if first or not last
              else None)
        win = carry = torch.zeros(c, dtype=torch.float32, device=rb.device)
        for p in range(n - 1):
            out = (kb.carry_update(F["Tf"], carry, wz[-1]) if rank == p
                   else torch.zeros_like(carry))
            carry = comm.ppermute(out, p, p + 1)
            if rank == p + 1:
                win = carry
        w = wz if first else kb.carry_stage(Sinv, H, G, "forward", t, win)
        xz = (kb.carry_stage(Sinv, H, G, "backward", w) if last or not first
              else None)
        xin = carry = torch.zeros_like(win)
        for p in range(n - 1, 0, -1):
            out = (kb.carry_update(F["Tb"], carry, xz[0]) if rank == p
                   else torch.zeros_like(carry))
            carry = comm.ppermute(out, p, p - 1)
            if rank == p - 1:
                xin = carry
        x = xz if last else kb.carry_stage(Sinv, H, G, "backward", w, xin)
        return x.reshape(-1).to(r_loc.dtype)

    return apply


def make_sharded_banded_apply(plan: ShardPlan, comm):
    """apply(F, r_loc) -> M r: the phase-sequential forward and backward
    scans (algo="thomas"), the (c,) carries handed rank to rank."""
    c, n, m = plan.c, plan.n, plan.nb_loc
    rank = comm.rank

    def apply(F, r_loc):
        Sinv, H, G = F["Sinv"], F["H"], F["G"]
        rb = r_loc.to(torch.float32).reshape(m, c)
        t = kb.carry_stage(Sinv, H, G, "times", rb)
        w0 = torch.zeros(c, dtype=torch.float32, device=rb.device)
        w = None
        for p in range(n):
            if rank == p:
                w = kb.carry_stage(Sinv, H, G, "forward", t,
                                   w0 if p > 0 else None)
            if p < n - 1:
                w0 = comm.ppermute(w[-1] if rank == p else w0, p, p + 1)
        x0 = torch.zeros_like(w0)
        x = None
        for p in range(n - 1, -1, -1):
            if rank == p:
                x = kb.carry_stage(Sinv, H, G, "backward", w,
                                   x0 if p < n - 1 else None)
            if p > 0:
                x0 = comm.ppermute(x[0] if rank == p else x0, p, p - 1)
        return x.reshape(-1).to(r_loc.dtype)

    return apply


# ---------------------------------------------------------------- SPIKE
# K21f, vasp_tpu's third algorithm (banded_shard.py:438-466): every rank
# factorizes its own nb_loc-block system with C_0 left out, no carry (the
# point of SPIKE: no rank waits on another's scan); the couplings C_0 (to
# rank p - 1) and B_{m-1} (to rank p + 1) give the spikes W = T^-1 e_0 C_0
# and V = T^-1 e_{m-1} B_{m-1}, whose corner blocks make a reduced system
# of n - 1 interfaces, solved by a c-sized recursion rank after rank. The
# apply: a local solve, the reduced sweeps, the corrected local solve, then
# `refine` passes of iterative refinement (vasp_tpu: the partitions' local
# inverses are not backward stable on the FSI tube, :575-585).


def local_thomas(Cm, D, Bm, factor_dtype=torch.float32, f64=False):
    """The rank's own block-Thomas factors (Sinv, H, G) with C_0 left out
    (H_0 = 0) and no incoming carry (vasp_tpu _local_thomas, :469): the
    float32 Schur scan (K9's), or the float64 one on the factor tier
    (K11's), H and G formed from the float32 Sinv and all three stored in
    factor_dtype."""
    c = D.shape[1]
    if f64:
        G0 = torch.zeros((c, c), dtype=torch.float64, device=D.device)
        Sinv = banded_mod.schur_scan_f64_carry(Cm, D, Bm, G0)[0]
    else:
        G0 = torch.zeros((c, c), dtype=torch.float32, device=D.device)
        Sinv = banded_mod.schur_scan_carry(Cm, D, Bm, G0)[0]
    H = banded_mod.sinv_times(Sinv, Cm, factor_dtype)
    H[0] = 0.0
    G = banded_mod.sinv_times(Sinv, Bm, factor_dtype)
    return Sinv.to(factor_dtype), H, G


def local_solve(Sinv, H, G, rb, full=True):
    """T_p^-1 rb on the rank's blocks: K21a's three stages with no carry
    (vasp_tpu _local_solve_vec, :517). full=False runs the first two and
    returns the forward result, whose last block is the solve's (the
    backward scan starts from it)."""
    t = kb.carry_stage(Sinv, H, G, "times", rb)
    w = kb.carry_stage(Sinv, H, G, "forward", t)
    return kb.carry_stage(Sinv, H, G, "backward", w) if full else w


def spike_corners(Sinv, H, G, C0, Blast):
    """(Vt, Vb, Wt, Wb): the first and last blocks of the spikes V = T^-1
    e_{m-1} B_{m-1} and W = T^-1 e_0 C_0 (vasp_tpu _local_solve_mat, :539,
    float32 torch.matmul scans, once a rebuild). A step whose input is
    zero is skipped: V's forward scan is zero up to block m - 1, and past
    block 0 the right-hand side of W is."""
    m = Sinv.shape[0]
    Vb = Sinv[m - 1].float() @ Blast
    Vt = Vb
    for k in range(m - 2, -1, -1):
        Vt = -(G[k].float() @ Vt)
    w = [Sinv[0].float() @ C0]
    for k in range(1, m):
        w.append(-(H[k].float() @ w[-1]))
    Wb = Wt = w[m - 1]
    for k in range(m - 2, -1, -1):
        Wt = w[k] - G[k].float() @ Wt
    return Vt, Vb, Wt, Wb


def spike_reduced(Vt, Vb, Wt, Wb, comm, f64=False):
    """The reduced interface factors of vasp_tpu's _sharded_factorize_spike
    (:598-636), rank j owning interface j: P_j = Vb_j + Wb_j M_{j-1} Vt_j,
    K_j = (I - Wt_{j+1} P_j)^-1 (the LU inverse and one polish in float32,
    the float64 inverse on the factor tier), the carry M_j = P_j K_j handed
    to rank j + 1; the last rank keeps vasp_tpu's inert entries (P = 0,
    K = I). Returns (P, K, Q = Wt_{j+1}, Vtn = Vt_{j+1})."""
    c, dev = Vt.shape[0], Vt.device
    n, rank = comm.n, comm.rank
    Q = comm.shift_left(Wt)
    Vtn = comm.shift_left(Vt)
    eye = torch.eye(c, dtype=torch.float32, device=dev)
    P, K = torch.zeros_like(eye), eye
    M = torch.zeros_like(eye)
    for j in range(n - 1):
        if rank == j:
            P = Vb if j == 0 else Vb + Wb @ (M @ Vt)
            A = eye - Q @ P
            if f64:
                K = torch.linalg.inv(A.double()).float()
            else:
                K = torch.linalg.inv(A)
                K = K @ (2.0 * eye - A @ K)
        if j < n - 2:
            M = comm.ppermute(P @ K if rank == j else M, j, j + 1)
    return P, K, Q, Vtn


def sharded_factorize_spike(Cm, D, Bm, comm, factor_dtype=torch.float32,
                            f64=False, refine=0, timed=None):
    """K21f's factorization (vasp_tpu _sharded_factorize_spike, :564): the
    local factors, the spikes' corners, the reduced factors, each part in
    `timed(phase)` (a context manager: factorize, spikes, reduced) where
    given. Returns the factor dict of make_sharded_spike_apply: Sinv, H, G
    and the c x c blocks with the sign their carry_update takes (nC0 =
    -C_0, nBlast = -B_{m-1}, nWb = -Wb, nQ = -Q, nP = -P, K, Vtn); with
    refine > 0 the operator blocks Cb, Db, Bb (float32) for the refinement
    residual."""
    timed = timed or (lambda phase: nullcontext())
    with timed("factorize"):
        Sinv, H, G = local_thomas(Cm, D, Bm, factor_dtype, f64)
    C0, Blast = Cm[0].float(), Bm[D.shape[0] - 1].float()
    with timed("spikes"):
        Vt, Vb, Wt, Wb = spike_corners(Sinv, H, G, C0, Blast)
    with timed("reduced"):
        P, K, Q, Vtn = spike_reduced(Vt, Vb, Wt, Wb, comm, f64)
    F = dict(Sinv=Sinv, H=H, G=G, nC0=-C0, nBlast=-Blast, nWb=-Wb, nQ=-Q,
             nP=-P, K=K, Vtn=Vtn)
    if refine > 0:
        F.update(Cb=Cm, Db=D, Bb=Bm)
    return F


def make_sharded_spike_apply(plan: ShardPlan, comm, refine=0):
    """apply(F, r_loc) -> M r, vasp_tpu's make_sharded_spike_apply (:758):
    the local solve, the reduced forward and backward sweeps over the
    interfaces (n - 1 phases each, rank j owning interface j), the
    corrected local solve, then `refine` passes, each the neighbours'
    boundary rows exchanged, the residual r - T x (K21f-a), a solve and an
    add. The sweeps and corrections are K21a's carry_update on the stored
    blocks (K21f-b).

    Each rank runs only the work whose result it uses (vasp_tpu's SPMD
    program runs every branch): of the first local solve, rank 0 needs
    only the bottom block (no backward scan) and a single rank none; the
    last rank owns no interface; the corrections by a zero interface
    value (rank 0's C_0 term, the last rank's B_{m-1} term, the last
    interface's incoming backward value) are left out."""
    c, n, m = plan.c, plan.n, plan.nb_loc
    rank = comm.rank
    first, last = rank == 0, rank == n - 1

    def solve_once(F, rb):
        Sinv, H, G = F["Sinv"], F["H"], F["G"]
        zero = rb.new_zeros(c)
        gb = gt = zero
        if not (first and last):
            g = local_solve(Sinv, H, G, rb, full=not first)
            gb, gt = g[m - 1], g[0]
        gtn = comm.shift_left(gt)
        # the forward sweep: u = gb_j - Wb_j wa_{j-1}, s = K_j (gt_{j+1} -
        # Q_j u), wa_j = u - P_j s, wb_j = s
        wa = wb = carry = zero
        for j in range(n - 1):
            if rank == j:
                u = gb if j == 0 else kb.carry_update(F["nWb"], carry, gb)
                s = kb.carry_update(F["K"], kb.carry_update(F["nQ"], u, gtn),
                                    zero)
                wa, wb = kb.carry_update(F["nP"], s, u), s
            if j < n - 2:
                carry = comm.ppermute(wa if rank == j else carry, j, j + 1)
        # the backward sweep: z = Vt_{j+1} xb_{j+1}; xa_j = wa_j + P_j K_j
        # z, xb_j = wb_j - K_j z (z = 0 on the last interface)
        xa, xb, carry = wa, wb, zero
        for j in range(n - 2, -1, -1):
            if rank == j and j < n - 2:
                z = kb.carry_update(F["Vtn"], carry, zero)
                mkz = kb.carry_update(F["K"], -z, zero)
                xa, xb = kb.carry_update(F["nP"], mkz, wa), wb + mkz
            if j > 0:
                carry = comm.ppermute(xb if rank == j else carry, j, j - 1)
        # the correction: r_p - e_0 C_0 xa_{p-1} - e_{m-1} B_{m-1} xb_p
        a_prev = comm.shift_right(xa)
        rb2 = rb.clone()
        if not first:
            rb2[0] = kb.carry_update(F["nC0"], a_prev, rb2[0].contiguous())
        if not last:
            rb2[m - 1] = kb.carry_update(F["nBlast"], xb,
                                         rb2[m - 1].contiguous())
        return local_solve(Sinv, H, G, rb2)

    def apply(F, r_loc):
        rb = r_loc.to(torch.float32).reshape(m, c)
        x = solve_once(F, rb)
        for _ in range(refine):
            xprev = comm.shift_right(x[m - 1])
            xnext = comm.shift_left(x[0])
            y = kb.tri_residual(F["Cb"], F["Db"], F["Bb"], x, rb,
                                None if first else xprev,
                                None if last else xnext)
            x = x + solve_once(F, y)
        return x.reshape(-1).to(r_loc.dtype)

    return apply


def sharded_probe_rel(Cm, D, Bm, F, apply, comm):
    """Solve quality of the sharded factors, ||T M b - b|| / ||b|| for the
    +-1 probe b (fem/banded.py probe_rel, dof-sharded: the neighbours'
    boundary blocks of M b exchanged)."""
    m, c, _ = D.shape
    span = m * c
    b = torch.where(torch.arange(span, device=D.device) % 2 == 0, 1.0,
                    -1.0).to(torch.float32)
    x = apply(F, b).to(torch.float32).reshape(m, c)
    xprev = comm.shift_right(x[m - 1])
    xnext = comm.shift_left(x[0])
    xm = torch.cat([xprev[None], x, xnext[None]])
    y = kb.bgemv(D, x) + kb.bgemv(Cm, xm[:m]) + kb.bgemv(Bm, xm[2:])
    r = (y - b.reshape(m, c)).reshape(-1)
    num = comm.red(torch.dot(r, r))
    den = comm.red(torch.dot(b, b))
    return float(torch.sqrt(num / den))


# ------------------------------------------------------------- stepper
class ShardedBandedStepper:
    """The multi-rank IterativeStepper of vasp_tpu: dof-sharded state,
    halo-exchange assembly, the sharded banded preconditioner, Krylov in
    the options' dtype; one rank per process of `group` (the default
    group when None), each calling every method with the same arguments.

    step(U0, bc_values, load, tstep) takes and returns full (ndof,) states
    in the original order, replicated on every rank. The factorization
    runs every ``recompute_tstep`` steps; ``step`` climbs vasp_tpu's
    sharded ladder (the certification of a coarse f32 exit, the
    stall-triggered rebuild, the fine retry, the probe-flagged float64
    factor tier, the float64 direction tier). ``timings`` holds wall
    seconds per phase (the rebuild's rebuild_jacobians, ruiz, assemble,
    factorize, transfer (chain), spikes and reduced (spike), probe;
    residual, jacobians and gmres, matvec and precond within it), each
    ended by a device synchronize on a card, and the all-reduces' seconds
    and bytes (exchange, exchange_bytes: parallel/comm.py);
    ``history`` one record per step (Newton iterations, GMRES inner
    iterations and cycles, rebuilds, the tiers taken)."""

    def __init__(self, system, bc_set, options: StepOptions, group=None,
                 recompute_tstep=20, algo="chain", spike_refine=2):
        check_algo(algo)
        self.opt = options
        self.algo = algo
        # the SPIKE apply's refinement passes (vasp_tpu's VASP_SPIKE_REFINE,
        # default 2; the config key spike_refine)
        self.spike_refine = int(spike_refine) if algo == "spike" else 0
        self.device = system.device
        asm = system.assembler
        self.ndof = asm.ndof
        self.timings = defaultdict(float)
        self.comm = Collectives(group=group, timings=self.timings)
        n, rank = self.comm.n, self.comm.rank
        plan = build_shard_plan([b.dofs.cpu().numpy() for b in asm.blocks],
                                self.ndof, n)
        self.plan = plan
        self.comm.span, self.comm.c = plan.span, plan.c
        self.recompute_tstep = int(recompute_tstep)
        self._last_rebuild = -(10 ** 9)
        self._factors = None
        # the precision ladder: the rebuild's probe, the float64 factor
        # tier latched after a probe-flagged stall
        self._last_rel = 0.0
        self._f64_factors = False
        self._rel_max = 1.0
        self.rebuilds = self.gmres_inner = self.gmres_cycles = 0
        self.history = []

        dev = self.device
        c, span = plan.c, plan.span
        skeleton, arrays = partition_blocks(system, plan)
        self.blocks = rank_blocks(skeleton, arrays, rank, dev)
        self.asm = Assembler(span + c + 1, self.blocks)
        mask_np = np.asarray(bc_set.mask)
        self._mask_orig = bc_set.mask_on(dev)
        mask_perm = np.ones(plan.npad, bool)  # padding rows: identity
        mask_perm[plan.iperm] = mask_np
        lo = rank * span
        mask_ext = np.zeros(span + c + 1, bool)
        mask_ext[:span] = mask_perm[lo:lo + span]
        if rank < n - 1:
            mask_ext[span:span + c] = mask_perm[lo + span:lo + span + c]
        self.mask_loc = torch.as_tensor(mask_ext[:span], device=dev)
        self.mask_ext = torch.as_tensor(mask_ext, device=dev)
        # identity diagonal slots of the rank's bc and padding rows
        q = np.nonzero(mask_ext[:span])[0]
        self._diag = torch.as_tensor((q // c) * c * c + (q % c) * (c + 1),
                                     device=dev)
        tic = time.perf_counter()
        self._plans = banded_mod.plans_to_device(rank_assembly_plan(
            [a["dofs"][rank] for a in arrays], plan, mask_ext), dev)
        self.setup = dict(plan=time.perf_counter() - tic)
        # the rank's dofs in the original order (the span's first `own`
        # positions; the rest is padding) and the inverse permutation
        own = max(0, min(span, plan.ndof - lo))
        self._loc_src = torch.as_tensor(plan.perm[lo:lo + own], device=dev)
        self._iperm = torch.as_tensor(plan.iperm, device=dev)
        self._hybrid0 = options.residual_dtype == "f32"
        if algo == "spike":
            self._apply = make_sharded_spike_apply(plan, self.comm,
                                                   self.spike_refine)
        else:
            self._apply = (make_sharded_chain_apply if algo == "chain"
                           else make_sharded_banded_apply)(plan, self.comm)
        print(f"sharded banded preconditioner ({algo}): {n} ranks of "
              f"{plan.nb_loc} blocks at c={c} (span {span} dofs, "
              f"{plan.npad - plan.ndof} padding)", flush=True)

    @contextmanager
    def _timed(self, phase):
        tic = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[phase] += time.perf_counter() - tic

    # ---------------- vectors ----------------
    def to_loc(self, x):
        """A full (ndof,) vector -> the rank's (span,) part of its permuted,
        zero-padded form."""
        out = torch.zeros(self.plan.span, dtype=x.dtype, device=x.device)
        out[:self._loc_src.shape[0]] = x[self._loc_src]
        return out

    def from_loc(self, x_loc):
        """The ranks' (span,) parts -> the full (ndof,) vector on every
        rank."""
        return self.comm.gather_spans(x_loc)[self._iperm]

    # ---------------- rebuild ----------------
    def _rebuild(self, U, U0, tstep, f64=None):
        """Factors of the banded preconditioner at (U, U0): (dr, dc, F,
        probe) into self._factors and self._last_rel."""
        if f64 is None:
            f64 = self._f64_factors
        self._factors = None
        comm, opt, asm = self.comm, self.opt, self.asm
        with self._timed("rebuild_jacobians"):
            U_ext = comm.ext_gather(self.to_loc(U))
            U0_ext = comm.ext_gather(self.to_loc(U0))
            jacs = asm.element_jacobians(U_ext, U0_ext, dtype=torch.float32)
        with self._timed("ruiz"):
            dr, dc = sharded_ruiz(self.blocks, jacs, self.mask_loc,
                                  self.mask_ext, comm, opt.ruiz_sweeps)
        with self._timed("assemble"):
            Cm, D, Bm = sharded_assemble_banded(
                self.blocks, jacs, comm.ext_gather(dr), comm.ext_gather(dc),
                self._plans, self.plan, self._diag)
            del jacs
            Cm, D, Bm = merge_halo_blockrow(Cm, D, Bm, comm)
        fdt = (torch.bfloat16 if opt.banded_factor_dtype == "bf16"
               else torch.float32)
        if self.algo == "spike":
            F = sharded_factorize_spike(Cm, D, Bm, comm, fdt, f64,
                                        self.spike_refine, self._timed)
        else:
            with self._timed("factorize"):
                Sinv, H, G = sharded_factorize(Cm, D, Bm, comm, fdt, f64)
            F = dict(Sinv=Sinv, H=H, G=G)
        if self.algo == "chain":
            with self._timed("transfer"):
                F["Tf"], F["Tb"] = sharded_transfer_products(H, G)
        with self._timed("probe"):
            rel = sharded_probe_rel(Cm, D, Bm, F, self._apply, comm)
        del Cm, D, Bm
        self._factors = (dr.to(torch.float64), dc.to(torch.float64), F)
        self._last_rel = rel
        self._last_rebuild = tstep
        self.rebuilds += 1

    # ---------------- Newton ----------------
    def _newton(self, U0, Ustart, bcv, load, fine_start, exact=False):
        """vasp_tpu's sharded Newton program on this rank: (U, stats), U
        the best state (full, replicated), stats = iterations, residual
        (the best), r0, stalled, fine. exact=True is the float64 direction
        tier (float64 Jacobians and GMRES at min(gmres_tol, 1e-5) with 5x
        the cycles, raw float64 residuals)."""
        opt, comm, asm = self.opt, self.comm, self.asm
        f32, f64 = torch.float32, torch.float64
        hybrid = self._hybrid0 and not exact
        use_delta = hybrid and opt.delta_endgame
        use_ew = opt.forcing == "ew" and not exact
        wdt = f32 if (opt.krylov_dtype == "f32" and not exact) else f64
        jdt = f32 if (opt.jac_dtype == "f32" and not exact) else f64
        gtol_fix = min(opt.gmres_tol, 1e-5) if exact else opt.gmres_tol
        gcyc = max(1, opt.gmres_maxiter // opt.gmres_restart) * (
            5 if exact else 1)
        endgame = opt.endgame_factor * opt.atol
        mask = self.mask_loc
        U0_loc, Us_loc, bcv_loc, load_loc = (
            self.to_loc(v) for v in (U0, Ustart, bcv, load))
        U1 = torch.where(mask, bcv_loc, Us_loc)
        U0_ext = comm.ext_gather(U0_loc)
        dr, dc, F = self._factors
        drw, dcw = dr.to(wdt), dc.to(wdt)

        def norm(R):
            return float(torch.sqrt(comm.red(torch.dot(R, R))))

        def residual(U, dtype=None):
            with self._timed("residual"):
                R = comm.halo_add(asm.residual(comm.ext_gather(U), U0_ext,
                                               dtype)) + load_loc
                return torch.where(mask, 0.0, R)

        def residual_fine(U, anc):
            # the Taylor-delta endgame around the call's exact anchor
            anchored, A, RA = anc
            if not (use_delta and anchored):
                return residual(U)
            with self._timed("delta"):
                d = asm.residual_delta(comm.ext_gather(U),
                                       comm.ext_gather(A), U0_ext)
                return torch.where(mask, 0.0, RA + comm.halo_add(d))

        def residual_sel(U, fine, anc):
            if not hybrid:
                return residual(U)
            return residual_fine(U, anc) if fine else residual(U, f32)

        def precond(r):
            with self._timed("precond"):
                return self._apply(F, r)

        def newton_update(U, R, eta):
            with self._timed("jacobians"):
                jacs = asm.element_jacobians(comm.ext_gather(U), U0_ext,
                                             dtype=jdt)

            def matvec(x):
                with self._timed("matvec"):
                    t = dcw * torch.where(mask, 0.0, x)
                    y = comm.halo_add(asm.matvec(jacs, comm.ext_gather(t)))
                    return torch.where(mask, x, drw * y)

            with self._timed("gmres"):
                y, info = gmres(matvec, (dr * R).to(wdt), M=precond,
                                restart=opt.gmres_restart, cycles=gcyc,
                                tol=eta if use_ew else gtol_fix,
                                reduce_fn=comm.red)
            self.gmres_inner += info[2]
            self.gmres_cycles += info[1]
            return dc * y.to(f64)

        if hybrid:
            R0 = residual(U1) if fine_start else residual(U1, f32)
            r0 = norm(R0)
            if not fine_start and r0 < endgame:
                R0 = residual(U1)
                r0 = norm(R0)
            fine = fine_start or r0 < endgame
        else:
            R0 = residual(U1)
            r0 = norm(R0)
            fine = True
        r0_safe = r0 if r0 > 0 else 1.0
        anchored = fine if use_delta else False
        U, R, rn, it, stall = U1, R0, r0, 0, 0
        Ub, rb, A, RA, eta = U1, r0, U1, R0, opt.gmres_tol
        while (it < opt.max_it and rn > opt.atol and rn / r0_safe > opt.rtol
               and stall < 2):
            anc = (anchored, A, RA)
            dx = newton_update(U, R, eta)
            fine = fine or rn < endgame
            Ufull = U - opt.lmbda * dx
            Rfull = residual_sel(Ufull, fine, anc)
            rfull = norm(Rfull)
            if np.isfinite(rfull) and rfull < rn:
                Un, Rn, rnew = Ufull, Rfull, rfull
            else:
                Un, rnew = _backtrack_update(
                    U, dx, lambda Ut: norm(residual_sel(Ut, fine, anc)),
                    opt.lmbda)
                Rn = residual_sel(Un, fine, anc)
            rn_prev = rn
            U, R, rn = Un, Rn, rnew
            if use_delta and fine and not anchored:
                A, RA, anchored = U, R, True
            stall = stall + 1 if rn > 0.9 * rn_prev else 0
            if rn < rb:
                Ub, rb = U, rn
            eta = float(np.clip(
                max(opt.ew_gamma * (rn / max(rn_prev, 1e-300)) ** 2,
                    0.1 * opt.atol / max(rn, 1e-300)),
                opt.gmres_tol, opt.ew_max))
            it += 1
        return self.from_loc(Ub), dict(iterations=it, residual=rb, r0=r0,
                                       stalled=stall >= 2, fine=fine)

    # ---------------- public ----------------
    def step(self, U0, bc_values, load, tstep):
        """One timestep with vasp_tpu's sharded precision ladder: coarse
        f32 -> certification / stall rebuild / fine retry -> probe-flagged
        float64 factor rebuild -> float64 directions."""
        opt = self.opt
        inner0, cycles0, rebuilds0 = (self.gmres_inner, self.gmres_cycles,
                                      self.rebuilds)
        tiers = []
        fresh = False
        if (self._factors is None
                or tstep - self._last_rebuild >= self.recompute_tstep):
            self._rebuild(torch.where(self._mask_orig, bc_values, U0), U0,
                          tstep)
            fresh = True

        def again(tier, Ustart, stats, fine_start, exact=False):
            tiers.append(tier)
            U, st = self._newton(U0, Ustart, bc_values, load, fine_start,
                                 exact)
            st["iterations"] += stats["iterations"]
            return U, st

        def conv(stats):
            res = stats["residual"]
            return res <= opt.atol or res <= opt.rtol * max(r0, 1e-300)

        U, stats = self._newton(U0, U0, bc_values, load, False)
        r0 = stats["r0"]
        f32 = opt.residual_dtype == "f32"
        if conv(stats) and f32 and not stats["fine"]:
            # a coarse (f32) exit claims convergence: certify it with
            # exact residuals
            U, stats = again("certify", U, stats, True)
        if not conv(stats) and not fresh:
            self._rebuild(U, U0, tstep)
            U, stats = again("stall_rebuild", U, stats, stats["fine"])
        if not conv(stats) and f32 and not stats["fine"]:
            # coarse-phase stall at the f32 noise floor: retry with exact
            # residuals from the current state
            U, stats = again("fine_retry", U, stats, True)
        if (not conv(stats) and not self._f64_factors
                and self._last_rel > self._rel_max):
            print("Newton[sharded]: stall under probe-flagged factors "
                  f"(solve quality {self._last_rel:.1e}) - escalating to "
                  "f64 factorization", flush=True)
            self._f64_factors = True
            self._rebuild(U, U0, tstep, f64=True)
            U, stats = again("f64_factors", U, stats, True)
        if not conv(stats) and stats["fine"]:
            print("Newton[sharded]: stall persists with exact residuals "
                  f"({stats['residual']:.3e}) - escalating to f64 "
                  "directions", flush=True)
            U, stats = again("exact", U, stats, True, exact=True)
        self.history.append(dict(
            tstep=tstep, iterations=stats["iterations"],
            gmres_inner=self.gmres_inner - inner0,
            gmres_cycles=self.gmres_cycles - cycles0,
            rebuilds=self.rebuilds - rebuilds0, tiers=tiers))
        return U, stats
