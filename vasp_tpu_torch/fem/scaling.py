"""Ruiz equilibration from element matrices.

Counterpart of vasp_tpu.fem.scaling (ruiz_scales, scale_element_jacobians).
The raw monolithic FSI Jacobian spans ~12 decades; the iterative path
solves the equilibrated system (Dr A Dc) y = Dr R, dx = Dc y. The row and
column maxima of each sweep and the element rescale are the K7 kernels of
kernels/scaling.py on CUDA tensors; the dr/dc update between sweeps is
elementwise torch. The node-block preconditioner of vasp_tpu (K17) belongs
to the sharded path and is not ported here (ROADMAP.md queue 1, item 13).
"""
import torch

from vasp_tpu_torch.kernels import scaling as ks


def ruiz_scales(blocks, jacs, bc_mask, ndof, sweeps=5):
    """Iterative row/col max-norm equilibration from element matrices, in
    the element matrices' dtype. bc_mask: bool (ndof,) tensor on their
    device. Returns (dr, dc) with dr=dc=1 at constrained dofs."""
    dty, dev = jacs[0].dtype, jacs[0].device
    dr = torch.ones(ndof, dtype=dty, device=dev)
    dc = torch.ones(ndof, dtype=dty, device=dev)
    floor = torch.tensor(1e-30, dtype=dty, device=dev)
    for _ in range(sweeps):
        rmax = torch.zeros(ndof, dtype=dty, device=dev)
        cmax = torch.zeros(ndof, dtype=dty, device=dev)
        for b, A in zip(blocks, jacs):
            ks.ruiz_sweep(A, b.dofs, dr, dc, bc_mask, rmax, cmax)
        dr = dr / torch.sqrt(torch.maximum(rmax, floor))
        dc = dc / torch.sqrt(torch.maximum(cmax, floor))
        dr = torch.where(bc_mask, 1.0, dr)
        dc = torch.where(bc_mask, 1.0, dc)
    return dr, dc


def scale_element_jacobians(blocks, jacs, dr, dc):
    """Pre-scale element matrices: A_e <- dr[rows] A_e dc[cols]."""
    return [ks.ruiz_scale(A, b.dofs, dr, dc) for b, A in zip(blocks, jacs)]
