"""Restricted additive Schwarz (RAS) preconditioner with exact subdomain
solves: precond="ras" of the Newton-Krylov path.

Counterpart of vasp_tpu.fem.ras. At a rebuild the host partitions the dofs
into S compact spatial subdomains (recursive coordinate bisection of the
dof coordinates), grows each by ``overlap`` layers of the dof graph, and
slices padded dense (S, m, m) local blocks out of the Ruiz-scaled CSR;
the blocks are inverted in float64 on the system's device and stored in
the Jacobian dtype. Each Krylov iteration applies them (K18,
kernels/ras.py): gather, batched local products, the restricted scatter
that writes each dof from the one subdomain that owns it.

Host code copied from vasp_tpu (RASPattern, spatial_partition,
build_pattern, build_pattern_auto, extract_local_blocks), on the numpy
overlap path: the port's native library has no expand_overlap (ROADMAP.md
queue 1, item 16). vasp_tpu inverts on the host, a workaround for a chip
without a float64 LU; here torch.linalg.inv runs on the card
(cuSOLVER), like the factorizations of fem/banded.py.
"""
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from vasp_tpu_torch import native
from vasp_tpu_torch.kernels import ras as kr


@dataclass
class RASPattern:
    """Static subdomain structure (depends on mesh/dofmap only)."""

    idx: np.ndarray  # (S, m) padded dof ids per subdomain
    own: np.ndarray  # (S, m) bool: this subdomain owns the dof
    pad_dof: int  # dummy dof id used for padding (== ndof)

    @property
    def n_subdomains(self):
        return self.idx.shape[0]

    @property
    def local_size(self):
        return self.idx.shape[1]


def spatial_partition(coords: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: split the longest axis at the
    (weighted) median until n_parts compact blobs remain (compact blobs
    keep the overlap growth proportional to the blob surface, where
    RCM-contiguous chunks are slabs of a tube)."""
    labels = np.zeros(len(coords), np.int64)

    def rec(ids, k, base):
        if k == 1:
            labels[ids] = base
            return
        k_left = k // 2
        c = coords[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, ax], kind="stable")
        cut = int(round(len(ids) * k_left / k))
        rec(ids[order[:cut]], k_left, base)
        rec(ids[order[cut:]], k - k_left, base + k_left)

    rec(np.arange(len(coords)), int(n_parts), 0)
    return labels


def build_pattern(adj: sp.csr_matrix, ndof: int, n_subdomains: int,
                  overlap: int = 2, coords=None) -> RASPattern:
    """Partition the dof graph into subdomains + overlap layers.

    adj: symmetric dof adjacency (the Jacobian's sparsity works).
    coords: optional (ndof, 3) dof coordinates -> compact spatial blobs
    (recursive bisection); without them, contiguous RCM chunks. Raises
    unless every dof is owned by exactly one subdomain (K18 stores each
    dof from its owner alone)."""
    adj = adj.tocsr()
    if coords is not None:
        labels = spatial_partition(np.asarray(coords), n_subdomains)
        parts = [np.nonzero(labels == s)[0] for s in range(n_subdomains)]
        parts = [p for p in parts if len(p)]
    else:
        perm = native.rcm_order(adj.indptr, adj.indices, ndof)
        if perm is None:
            perm = reverse_cuthill_mckee(adj, symmetric_mode=False)
        parts = np.array_split(np.asarray(perm), n_subdomains)
    owner = np.empty(ndof, np.int64)
    for s, p in enumerate(parts):
        owner[p] = s

    ext_sets = []
    for p in parts:
        ext = np.zeros(ndof, bool)
        ext[p] = True
        for _ in range(overlap):
            nbr = np.unique(adj[ext].indices)
            ext[nbr] = True
        ext_sets.append(np.nonzero(ext)[0])

    m = max(len(e) for e in ext_sets)
    S = len(parts)
    idx = np.full((S, m), ndof, np.int64)  # pad with dummy dof
    own = np.zeros((S, m), bool)
    for s, e in enumerate(ext_sets):
        idx[s, : len(e)] = e
        own[s, : len(e)] = owner[e] == s
    owners = np.bincount(idx[own], minlength=ndof)
    if owners.shape[0] != ndof or not np.all(owners == 1):
        raise ValueError("RAS pattern: every dof needs exactly one owning "
                         "subdomain")
    return RASPattern(idx=idx, own=own, pad_dof=ndof)


def build_pattern_auto(adj: sp.csr_matrix, ndof: int, n_subdomains: int,
                       overlap: int = 2, coords=None,
                       max_local: int = 2048,
                       max_elems: float = 6.0e8) -> RASPattern:
    """build_pattern with a memory/cost budget: if the built pattern's
    local size exceeds max_local or its S m^2 entries max_elems, retry
    with less overlap, then with more (smaller) subdomains (12 tries)."""
    n_sub = int(n_subdomains)
    ov = int(overlap)
    for _ in range(12):
        pat = build_pattern(adj, ndof, n_sub, overlap=ov, coords=coords)
        S, m = pat.idx.shape
        if m <= max_local and S * m * m <= max_elems:
            return pat
        if ov > 1:
            ov -= 1
        else:
            n_sub = min(max(2, ndof // 8), int(n_sub * 2))
        print(f"RAS pattern too large (S={S}, m={m}); retrying with "
              f"n_subdomains={n_sub}, overlap={ov}")
    return pat


def extract_local_blocks(A_scaled: sp.csr_matrix, pattern: RASPattern,
                         bc_mask: np.ndarray) -> np.ndarray:
    """Slice padded dense local matrices (S, m, m) float64 from the scaled
    CSR (bc rows/cols already identity, as to_csr makes them); padded
    slots and (near-)empty rows get identity rows."""
    S, m = pattern.idx.shape
    A_ext = sp.bmat(
        [[A_scaled, None], [None, sp.identity(1, format="csr")]],
        format="csr",
    )
    out = np.empty((S, m, m), np.float64)
    for s in range(S):
        ids = pattern.idx[s]
        B = A_ext[np.ix_(ids, ids)].toarray()
        # padding repeats the dummy index -> identical rows; rewrite every
        # padded slot as a clean identity row/col
        n_real = int(np.sum(ids != pattern.pad_dof))
        if n_real < m:
            B[n_real:, :] = 0.0
            B[:, n_real:] = 0.0
            B[range(n_real, m), range(n_real, m)] = 1.0
        # a saddle-point row can lose all its in-subdomain couplings (a
        # pressure dof whose velocity partners fall outside the overlap):
        # identity (those dofs are never owned)
        empty = np.abs(B).max(axis=1) < 1e-12
        if empty.any():
            B[empty] = 0.0
            B[empty, empty] = 1.0
        out[s] = B
    return out


def invert_blocks(local_blocks, dtype, device):
    """The local inverses (S, m, m) in `dtype` on `device`: each block
    inverted by torch.linalg.inv in float64 on the device (the blocks can
    be conditioned ~1e6 and beyond, where a float32 inversion fails), one
    block at a time, so that only one float64 block is on the device."""
    S, m, _ = local_blocks.shape
    out = torch.empty((S, m, m), dtype=dtype, device=device)
    for s in range(S):
        out[s] = torch.linalg.inv(torch.as_tensor(local_blocks[s],
                                                  device=device))
    return out


def make_apply(pattern: RASPattern, device):
    """apply(pinv, r) -> y (r's dtype and length), the K18 kernel on a CUDA
    r."""
    idx = torch.as_tensor(pattern.idx, device=device)
    own = torch.as_tensor(pattern.own, device=device)

    def apply(pinv, r):
        return kr.apply(pinv, idx, own, r)

    return apply
