"""K4: the element matvec y[dofs_e] += A_e x[dofs_e], for the cell blocks
(64 local dofs) and the Robin facet blocks (36).

The plain torch version (``elem_matvec_plain``), the CUDA launch
(``elem_matvec_cuda``, csrc/matvec.cu) and the dispatch fem/assembly.py
calls (``elem_matvec``): a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.

Replaces vasp_tpu/fem/assembly.py Assembler._elem_gemv / matvec: x_e is
cast to A's dtype, the row products are summed in A's dtype and
accumulated into y in y's dtype. Costs and design: see the head of
csrc/matvec.cu.
"""
import torch

from vasp_tpu_torch.kernels import build

_FLOATS = (torch.float32, torch.float64)
# the local sizes the kernel is instantiated for
NLOCS = (64, 36)


def launch_name(kernel, n):
    """The launch counter of a kernel's instance at local size n: the
    kernel's name at 64, suffixed with n at the facet blocks' 36."""
    return kernel if n == 64 else f"{kernel}_{n}"


def elem_matvec_plain(A, dofs, x, y):
    """y += scatter of A_e x_e over the block's cells (in place)."""
    xe = x[dofs].to(A.dtype)
    ye = torch.sum(A * xe[:, None, :], dim=2)
    y.index_add_(0, dofs.reshape(-1), ye.reshape(-1).to(y.dtype))
    return y


def elem_matvec_cuda(A, dofs, x, y):
    """y += scatter of A_e x_e, by the K4 kernel."""
    lib = build.library()
    dev = x.device
    K, n = dofs.shape
    if A.dtype not in _FLOATS or x.dtype not in _FLOATS:
        raise ValueError(f"K4 takes float32/float64 A and x, got {A.dtype} "
                         f"and {x.dtype}")
    if n not in NLOCS:
        raise ValueError(f"K4 takes {NLOCS} local dofs, got {n}")
    build.require(A, "A", A.dtype, (K, n, n), dev)
    build.require(dofs, "dofs", torch.int64, (K, n), dev)
    build.require(x, "x", x.dtype, x.shape[:1], dev)
    build.require(y, "y", x.dtype, x.shape, dev)
    build.check(lib.vt_elem_matvec(
        build.ptr(A), int(A.dtype == torch.float64), build.ptr(dofs),
        build.ptr(x), build.ptr(y), int(x.dtype == torch.float64), K, n,
        build.stream_handle(dev)), "elem_matvec")
    build.LAUNCHES[launch_name("elem_matvec", n)] += 1
    return y


def elem_matvec(A, dofs, x, y):
    """y += scatter of A_e x_e: plain on CPU tensors, the CUDA kernel on
    CUDA tensors."""
    if build.on_cuda(x, "elem_matvec"):
        return elem_matvec_cuda(A, dofs, x, y)
    return elem_matvec_plain(A, dofs, x, y)
