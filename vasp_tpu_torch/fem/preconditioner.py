"""Element-block additive Schwarz with float32 inverses.

Counterpart of vasp_tpu.fem.preconditioner (build_schwarz, apply_schwarz),
which no module of either package calls; it shares NewtonSolver's K22
(kernels/schwarz.py): the build pass on the element Jacobians (bc rows
identity, bc columns zeroed off them, eps * max(|a_ii|, 1) on the diagonal,
here eps = 1e-8) and the gather-GEMV-scatter apply. The inverses are taken
in float32 and stored back in the Jacobians' dtype; the multiplicity is
returned unclamped and the apply is unscaled, so that a caller reduces the
multiplicity across ranks first and divides outside.
"""
import torch

from vasp_tpu_torch.kernels import schwarz as ks


def build_schwarz(blocks, jacs, bc_mask, ndof, eps=1e-8):
    """(pinv list, raw multiplicity (ndof,) float64); bc_mask a bool (ndof,)
    tensor on the Jacobians' device."""
    dev = jacs[0].device
    mult = torch.zeros(ndof, dtype=torch.float64, device=dev)
    pinv = []
    for b, A in zip(blocks, jacs):
        Amod = ks.build(A.to(torch.float64), b.dofs, bc_mask, eps, mult)
        pinv.append(torch.linalg.inv(Amod.to(torch.float32)).to(A.dtype)
                    .contiguous())
    return pinv, mult


def apply_schwarz(blocks, pinv, r):
    """The unscaled additive-Schwarz apply (divide by the multiplicity
    outside)."""
    return ks.apply([P.to(torch.float64) for P in pinv],
                    [b.dofs for b in blocks], r)
