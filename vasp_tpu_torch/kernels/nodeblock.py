"""K17: the node-block preconditioner of make_step_fn, extract, invert and
apply.

Plain torch versions (``extract_plain``, ``invert_plain``,
``apply_plain``), the CUDA launches (csrc/nodeblock.cu) and the dispatch
fem/scaling.py calls (``extract``, ``invert``, ``apply``): a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Replaces vasp_tpu/fem/scaling.py build_node_block (:80-118) and
apply_node_block (:121-131) with vasp_tpu/fem/smallmat.py inv6 (:42): the
6x6 (d, v) diagonal node blocks of the scaled element Jacobians summed per
P2 node, constrained rows set to identity rows and constrained columns
zeroed off them, + 1e-8 I, inverted in closed form in float64; the apply
multiplies each node's [r_d, r_v] by its inverse and copies the pressure
entries through. Float64 throughout. Counters: ``node_block_extract``,
``node_block_invert``, ``node_block_apply``.
"""
import numpy as np
import torch

from vasp_tpu_torch.fem.smallmat import inv6
from vasp_tpu_torch.kernels import build as kb

# the local (row or column) index of each (node, slot) of the 6x6 blocks:
# slots 0-2 the node's d components, 3-5 its v components
_LOCAL = np.array([[3 * k + s if s < 3 else 30 + 3 * k + s - 3
                    for s in range(6)] for k in range(10)])


def extract_plain(A, dofs, nb):
    """nb (n_p2, 6, 6) += the cells' diagonal node blocks (in place)."""
    loc = torch.as_tensor(_LOCAL, device=A.device)
    blocks = A[:, loc[:, :, None], loc[:, None, :]]  # (K, 10, 6, 6)
    # the global P2 node of each local node, from its d-x dof
    nodes = dofs[:, 0:30:3] // 3
    nb.index_add_(0, nodes.reshape(-1), blocks.reshape(-1, 6, 6))
    return nb


def extract_cuda(A, dofs, nb):
    dev = A.device
    K, n = dofs.shape
    kb.require(A, "A", torch.float64, (K, n, n), dev)
    kb.require(dofs, "dofs", torch.int64, (K, n), dev)
    kb.require(nb, "nb", torch.float64, nb.shape, dev)
    kb.check(kb.library().vt_node_block_extract(
        kb.ptr(A), kb.ptr(dofs), K, n, kb.ptr(nb), kb.stream_handle(dev)),
        "node_block_extract")
    kb.LAUNCHES["node_block_extract"] += 1
    return nb


def extract(A, dofs, nb):
    """nb += the node blocks of a cell block (60 or more local dofs)."""
    if dofs.shape[1] < 60:
        raise ValueError(f"K17 extracts node blocks of cell blocks (60 or "
                         f"more local dofs), got {dofs.shape[1]}")
    if kb.on_cuda(A, "node_block_extract"):
        return extract_cuda(A, dofs, nb)
    return extract_plain(A, dofs, nb)


def _mask6(mask, n_p2):
    d = mask[: 3 * n_p2].reshape(n_p2, 3)
    v = mask[3 * n_p2: 6 * n_p2].reshape(n_p2, 3)
    return torch.cat([d, v], dim=1)


def invert_plain(nb, mask):
    """The masked, regularized blocks' inverses (n_p2, 6, 6)."""
    n_p2 = nb.shape[0]
    m6 = _mask6(mask, n_p2)
    eye = torch.eye(6, dtype=nb.dtype, device=nb.device)
    nb = torch.where(m6[:, :, None], eye[None], nb)
    nb = torch.where(m6[:, None, :] & ~m6[:, :, None], 0.0, nb)
    return inv6(nb + 1e-8 * eye[None])


def invert_cuda(nb, mask):
    dev = nb.device
    n_p2 = nb.shape[0]
    kb.require(nb, "nb", torch.float64, (n_p2, 6, 6), dev)
    kb.require(mask, "mask", torch.bool, mask.shape[:1], dev)
    if mask.shape[0] < 6 * n_p2:
        raise ValueError(f"mask of {mask.shape[0]} dofs for {n_p2} P2 nodes")
    pinv = torch.empty_like(nb)
    kb.check(kb.library().vt_node_block_invert(
        kb.ptr(nb), kb.ptr(mask), n_p2, kb.ptr(pinv), kb.stream_handle(dev)),
        "node_block_invert")
    kb.LAUNCHES["node_block_invert"] += 1
    return pinv


def invert(nb, mask):
    if kb.on_cuda(nb, "node_block_invert"):
        return invert_cuda(nb, mask)
    return invert_plain(nb, mask)


def apply_plain(pinv, r, n_p2, off_p):
    rb = torch.cat([r[: 3 * n_p2].reshape(n_p2, 3),
                    r[3 * n_p2: 6 * n_p2].reshape(n_p2, 3)], dim=1)
    yb = torch.sum(pinv * rb[:, None, :], dim=2)
    return torch.cat([yb[:, :3].reshape(-1), yb[:, 3:].reshape(-1),
                      r[off_p:]])


def apply_cuda(pinv, r, n_p2, off_p):
    dev = r.device
    if off_p != 6 * n_p2:
        raise ValueError(f"K17 takes the DVP layout off_p = 6 n_p2, got "
                         f"off_p={off_p}, n_p2={n_p2}")
    kb.require(pinv, "pinv", torch.float64, (n_p2, 6, 6), dev)
    kb.require(r, "r", torch.float64, r.shape[:1], dev)
    y = torch.empty_like(r)
    kb.check(kb.library().vt_node_block_apply(
        kb.ptr(pinv), kb.ptr(r), n_p2, off_p, r.shape[0], kb.ptr(y),
        kb.stream_handle(dev)), "node_block_apply")
    kb.LAUNCHES["node_block_apply"] += 1
    return y


def apply(pinv, r, n_p2, off_p):
    if kb.on_cuda(r, "node_block_apply"):
        return apply_cuda(pinv, r, n_p2, off_p)
    return apply_plain(pinv, r, n_p2, off_p)
