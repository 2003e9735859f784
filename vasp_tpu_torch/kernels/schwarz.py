"""K22: the element-block additive Schwarz preconditioner's build pass and
apply (NewtonSolver's Krylov branch, fem/preconditioner.py).

Plain torch versions (``build_plain``, ``apply_plain``), the CUDA launches
(csrc/schwarz.cu) and the dispatch (``build``, ``apply``): a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Replaces vasp_tpu/fem/solver.py NewtonSolver._build_schwarz (:153-175)
and _precond (:177-184), and vasp_tpu/fem/preconditioner.py
build_schwarz / apply_schwarz (:16-47): per element the Jacobian with its
constrained rows set to identity rows, its constrained columns zeroed off
those rows and eps * max(|a_ii|, 1) added to the diagonal; the dofs'
multiplicities; the apply gathers r at each element's dofs, multiplies by
the element's inverse, scatter-adds, and divides the sum by the
multiplicity where one is given. Float64 only (NewtonSolver's Jacobians);
the inverses between build and apply are torch.linalg.inv's. Counters:
``schwarz_build`` / ``schwarz_apply`` at 64 local dofs, ``_36`` at the
Robin facet blocks' 36, ``schwarz_divide`` for the division.
"""
import torch

from vasp_tpu_torch.kernels import build as kb
from vasp_tpu_torch.kernels.matvec import NLOCS, launch_name


def build_plain(A, dofs, mask, eps, mult):
    """The modified element matrices (K, n, n); adds each element's dofs to
    mult (ndof,) in place."""
    n = A.shape[-1]
    bcm = mask[dofs]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Amod = torch.where(bcm[:, :, None], eye[None], A)
    Amod = torch.where(bcm[:, None, :] & ~bcm[:, :, None], 0.0, Amod)
    diag = torch.diagonal(Amod, dim1=1, dim2=2)
    Amod = Amod + torch.diag_embed(eps * torch.clamp(diag.abs(), min=1.0))
    mult.index_add_(0, dofs.reshape(-1),
                    torch.ones(dofs.numel(), dtype=mult.dtype,
                               device=mult.device))
    return Amod


def build_cuda(A, dofs, mask, eps, mult):
    dev = A.device
    K, n = dofs.shape
    if n not in NLOCS:
        raise ValueError(f"K22 takes {NLOCS} local dofs, got {n}")
    kb.require(A, "A", torch.float64, (K, n, n), dev)
    kb.require(dofs, "dofs", torch.int64, (K, n), dev)
    kb.require(mask, "mask", torch.bool, mult.shape, dev)
    kb.require(mult, "mult", torch.float64, mask.shape, dev)
    out = torch.empty_like(A)
    name = launch_name("schwarz_build", n)
    kb.check(kb.library().vt_schwarz_build(
        *map(kb.ptr, (A, dofs, mask)), float(eps), kb.ptr(out),
        kb.ptr(mult), K, n, kb.stream_handle(dev)), name)
    kb.LAUNCHES[name] += 1
    return out


def build(A, dofs, mask, eps, mult):
    """The modified element matrices, mult accumulated: plain on CPU
    tensors, the CUDA kernel on CUDA tensors."""
    if kb.on_cuda(A, "schwarz_build"):
        return build_cuda(A, dofs, mask, eps, mult)
    return build_plain(A, dofs, mask, eps, mult)


def divide_plain(y, mult):
    return y / mult


def divide_cuda(y, mult):
    """y / mult in place, by K22's divide kernel."""
    dev = y.device
    kb.require(y, "y", torch.float64, y.shape[:1], dev)
    kb.require(mult, "mult", torch.float64, y.shape, dev)
    kb.check(kb.library().vt_schwarz_divide(
        kb.ptr(y), kb.ptr(mult), y.shape[0], kb.stream_handle(dev)),
        "schwarz_divide")
    kb.LAUNCHES["schwarz_divide"] += 1
    return y


def apply_plain(pinv, dofs_list, r, mult=None):
    """y = sum over blocks of the scattered P_e r_e, divided by mult where
    given."""
    y = torch.zeros_like(r)
    for P, dofs in zip(pinv, dofs_list):
        ye = torch.matmul(P, r[dofs][..., None])[..., 0]
        y.index_add_(0, dofs.reshape(-1), ye.reshape(-1))
    return y if mult is None else divide_plain(y, mult)


def apply_cuda(pinv, dofs_list, r, mult=None):
    dev, lib = r.device, kb.library()
    kb.require(r, "r", torch.float64, r.shape[:1], dev)
    y = torch.zeros_like(r)
    for P, dofs in zip(pinv, dofs_list):
        K, n = dofs.shape
        if n not in NLOCS:
            raise ValueError(f"K22 takes {NLOCS} local dofs, got {n}")
        kb.require(P, "pinv", torch.float64, (K, n, n), dev)
        kb.require(dofs, "dofs", torch.int64, (K, n), dev)
        name = launch_name("schwarz_apply", n)
        kb.check(lib.vt_schwarz_apply(*map(kb.ptr, (P, dofs, r, y)), K, n,
                                      kb.stream_handle(dev)), name)
        kb.LAUNCHES[name] += 1
    return y if mult is None else divide_cuda(y, mult)


def apply(pinv, dofs_list, r, mult=None):
    """The Schwarz apply: plain on CPU tensors, the CUDA kernels on CUDA
    tensors."""
    if kb.on_cuda(r, "schwarz_apply"):
        return apply_cuda(pinv, dofs_list, r, mult)
    return apply_plain(pinv, dofs_list, r, mult)
