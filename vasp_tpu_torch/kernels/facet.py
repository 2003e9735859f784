"""K14: the Robin facet residual + scatter and its facet Jacobians.

Each operation has three parts here, as in kernels/element.py: the plain
torch version (``residual_plain`` / ``jacobian_plain``, on
fem/forms.py's RobinKernel.facet), the CUDA launch (``residual_cuda`` /
``jacobian_cuda``, the kernels of csrc/facet_kernels.cu), and the dispatch
the assembler calls (``block_residual`` / ``block_jacobian``): a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Replaces vasp_tpu/fem/forms.py make_robin_kernel through
vasp_tpu/fem/assembly.py FacetBlock.residual_local and jacobian_local.
Costs and design: see the head of csrc/facet_kernels.cu.

The residual's facet work runs in float64 (``dtype=None``) or float32
(``dtype=torch.float32``: U and area2 rounded to float32, float32 tables
and arithmetic, the result scattered into a float64 R), as vasp_tpu's
FacetBlock.residual_local with dtype=float32. Jacobians come in float64 or
float32; the float32 ones are the float64 ones rounded once, the designed
difference from vasp_tpu's float32 jacfwd that kernels/element.py states
for K3. The term is linear, so its Jacobians do not depend on U.

The facet part of K13 (vasp_tpu's residual_delta and residual_delta2 on a
facet block): the Robin term is linear in u, so jax.experimental.jet's
series of it along du = U - A is y1 = kernel(du) with y2 = y3 = 0, and its
delta is the float32 residual of du. ``delta_plain`` is residual_plain on
U - A in float32 (or float64, to measure the series); ``delta_cuda`` is
the K14 float32 residual launched on U - A, counted as K13's
(robin_delta, robin_delta2). The facet term has no previous state, so
both forms are the same.
"""
import torch

from vasp_tpu_torch.kernels import build
from vasp_tpu_torch.kernels.element import _residual_f32

NLOC = 36


# ------------------------------------------------------------ plain ----
def residual_plain(block, U, R, dtype=None):
    """R += scatter of the block's facet residuals (in place), their facet
    work in float64 (dtype None) or float32."""
    args = (U[block.dofs], block.area2)
    if _residual_f32(dtype):
        args = [a.to(dtype) for a in args]
    r = block.kernel(*args)
    R.index_add_(0, block.dofs.reshape(-1), r.reshape(-1).to(R.dtype))
    return R


def jacobian_plain(block, U):
    """(K,36,36) float64 facet Jacobians by torch.func.vmap(jacfwd),
    contiguous as the kernel's."""
    jac = torch.func.vmap(torch.func.jacfwd(block.kernel.facet))
    return jac(U[block.dofs], block.area2).contiguous()


# ------------------------------------------------------------- cuda ----
def _prepare(block, dev):
    """Validate the block's tensors; return (lib, K, nq, stream)."""
    lib = build.library()
    K = block.dofs.shape[0]
    build.require(block.dofs, "dofs", torch.int64, (K, NLOC), dev)
    build.require(block.area2, "area2", torch.float64, (K,), dev)
    nq = len(block.kernel.tables_np[0])
    return lib, K, nq, build.stream_handle(dev)


def _tables(block, like, nq):
    """The rule's (wq, N2t) in `like`'s dtype on its device, checked."""
    wq, N2t = block.kernel.tables(like)
    build.require(wq, "wq", like.dtype, (nq,), like.device)
    build.require(N2t, "N2t", like.dtype, (nq, 6), like.device)
    return wq, N2t


def residual_cuda(block, U, R, dtype=None, name=None):
    """R += the block's facet residuals, by the K14 residual kernel: its
    float64 instance, or its float32 one for dtype=torch.float32; the
    launch counted under `name` (by default the instance's own)."""
    f32 = _residual_f32(dtype)
    dev = U.device
    lib, K, nq, stream = _prepare(block, dev)
    build.require(U, "U", torch.float64, U.shape[:1], dev)
    build.require(R, "R", torch.float64, U.shape, dev)
    wq, N2t = _tables(block, U.new_empty(
        (), dtype=torch.float32 if f32 else torch.float64), nq)
    name = name or "robin_residual" + ("_f32" if f32 else "")
    build.check(lib.vt_robin_residual(
        *map(build.ptr, (U, block.dofs, block.area2, wq, N2t)), nq,
        build.ptr(R), int(f32), K, block.kernel.k_s, block.kernel.c_s,
        stream), name)
    build.LAUNCHES[name] += 1
    return R


def delta_cuda(block, U, A, R, name="robin_delta"):
    """R += the block's K13 delta, by the K14 float32 residual kernel on
    U - A (which the kernel rounds to float32: vasp_tpu's du), counted
    under `name` (robin_delta, or robin_delta2 in the two-argument form)."""
    return residual_cuda(block, U - A, R, torch.float32, name)


def jacobian_cuda(block, device, dtype=torch.float64):
    """(K,36,36) facet Jacobians in `dtype` (float64 or float32) on
    `device`, by the K14 Jacobian kernel."""
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"K14 writes float64 or float32, not {dtype}")
    lib, K, nq, stream = _prepare(block, device)
    A = torch.empty((K, NLOC, NLOC), dtype=dtype, device=device)
    wq, N2t = _tables(block, block.area2, nq)
    f32 = dtype == torch.float32
    name = "robin_jacobian" + ("_f32" if f32 else "")
    build.check(lib.vt_robin_jacobian(
        *map(build.ptr, (block.area2, wq, N2t)), nq, build.ptr(A), int(f32),
        K, block.kernel.k_s, block.kernel.c_s, stream), name)
    build.LAUNCHES[name] += 1
    return A


# --------------------------------------------------------- dispatch ----
def block_residual(block, U, U0, R, dtype=None):
    """R += the block's facet residuals (U0 unused: the term has no time
    history), their facet work in float64 (dtype None) or float32: plain
    on CPU tensors, the CUDA kernel on CUDA tensors."""
    if build.on_cuda(U, "facet"):
        return residual_cuda(block, U, R, dtype)
    return residual_plain(block, U, R, dtype)


def block_jacobian(block, U, U0, dtype=torch.float64):
    """(K,36,36) facet Jacobians in `dtype`: plain on CPU tensors, the CUDA
    kernel on CUDA tensors."""
    if build.on_cuda(U, "facet"):
        return jacobian_cuda(block, U.device, dtype)
    return jacobian_plain(block, U).to(dtype)


def delta_plain(block, U, A, R, dtype=torch.float32):
    """R += the block's delta, the facet residual of U - A with its facet
    work in `dtype` (float32, or float64 to measure the series)."""
    return residual_plain(block, U - A, R,
                          None if dtype == torch.float64 else dtype)


def block_delta(block, U, A, U0, R, U0new=None):
    """R += the block's K13 delta along U - A (U0 and U0new unused: the
    term has no time history): plain on CPU tensors, the CUDA route on
    CUDA tensors."""
    if build.on_cuda(U, "facet"):
        return delta_cuda(block, U, A, R,
                          "robin_delta2" if U0new is not None
                          else "robin_delta")
    return delta_plain(block, U, A, R)
