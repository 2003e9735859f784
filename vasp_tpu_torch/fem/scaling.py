"""Ruiz equilibration and node-block preconditioning from element
matrices.

Counterpart of vasp_tpu.fem.scaling (ruiz_scales, scale_element_jacobians,
build_node_block, apply_node_block). The raw monolithic FSI Jacobian spans
~12 decades; the iterative path solves the equilibrated system
(Dr A Dc) y = Dr R, dx = Dc y. The row and column maxima of each sweep and
the element rescale are the K7 kernels of kernels/scaling.py on CUDA
tensors; the dr/dc update between sweeps is elementwise torch. The 6x6
(d, v) node-block preconditioner of make_step_fn (fem/timestepper.py) is
K17 (kernels/nodeblock.py): extract, closed-form float64 inverse, apply.
The reduce hooks (``reduce_max``, ``reduce_fn``) are None on one device;
the sharded path passes its cross-rank reductions there.
"""
import torch

from vasp_tpu_torch.kernels import nodeblock as knb
from vasp_tpu_torch.kernels import scaling as ks


def ruiz_scales(blocks, jacs, bc_mask, ndof, sweeps=5, reduce_max=None):
    """Iterative row/col max-norm equilibration from element matrices, in
    the element matrices' dtype. bc_mask: bool (ndof,) tensor on their
    device; reduce_max: an optional cross-rank elementwise max of the row
    and column maxima. Returns (dr, dc) with dr=dc=1 at constrained
    dofs."""
    dty, dev = jacs[0].dtype, jacs[0].device
    dr = torch.ones(ndof, dtype=dty, device=dev)
    dc = torch.ones(ndof, dtype=dty, device=dev)
    floor = torch.tensor(1e-30, dtype=dty, device=dev)
    for _ in range(sweeps):
        rmax = torch.zeros(ndof, dtype=dty, device=dev)
        cmax = torch.zeros(ndof, dtype=dty, device=dev)
        for b, A in zip(blocks, jacs):
            ks.ruiz_sweep(A, b.dofs, dr, dc, bc_mask, rmax, cmax)
        if reduce_max is not None:
            rmax = reduce_max(rmax)
            cmax = reduce_max(cmax)
        dr = dr / torch.sqrt(torch.maximum(rmax, floor))
        dc = dc / torch.sqrt(torch.maximum(cmax, floor))
        dr = torch.where(bc_mask, 1.0, dr)
        dc = torch.where(bc_mask, 1.0, dc)
    return dr, dc


def scale_element_jacobians(blocks, jacs, dr, dc):
    """Pre-scale element matrices: A_e <- dr[rows] A_e dc[cols]."""
    return [ks.ruiz_scale(A, b.dofs, dr, dc) for b, A in zip(blocks, jacs)]


def build_node_block(blocks, jacs_scaled, bc_mask, n_p2, off_p, ndof,
                     reduce_fn=None):
    """The inverses (n_p2, 6, 6) float64 of the 6x6 (d, v) node blocks of
    the scaled operator: summed over the cell blocks (facet blocks, under
    60 local dofs, are skipped), constrained rows and columns identity,
    + 1e-8 I, inverted in closed form (K17). reduce_fn: an optional
    cross-rank sum of the summed blocks. off_p and ndof are vasp_tpu's
    signature (the layout is the DVP one, off_p = 6 n_p2)."""
    dev = jacs_scaled[0].device
    nb = torch.zeros((n_p2, 6, 6), dtype=torch.float64, device=dev)
    for b, A in zip(blocks, jacs_scaled):
        if b.dofs.shape[1] < 60:
            continue
        knb.extract(A.to(torch.float64), b.dofs, nb)
    if reduce_fn is not None:
        nb = reduce_fn(nb)
    return knb.invert(nb, bc_mask)


def apply_node_block(pinv, r, n_p2, off_p):
    """y = blkdiag(pinv) r on the (d, v) part, identity on pressure (K17)."""
    return knb.apply(pinv, r, n_p2, off_p)
