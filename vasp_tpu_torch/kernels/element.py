"""K1, K2, K3: element residual + scatter and element Jacobians.

Each operation has three parts here: the plain torch version
(``residual_plain`` / ``jacobian_plain``, on fem/forms.py's per-cell
kernels), the CUDA launch (``residual_cuda`` / ``jacobian_cuda``, the
kernels of csrc/element_kernels.cu), and the dispatch the assembler calls
(``block_residual`` / ``block_jacobian``): a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. There is no fallback
from one to the other.

Replaces vasp_tpu/fem/assembly.py CellBlock.residual_local + the plain
scatter of Assembler.residual (K1 fluid, K2 solid) and
CellBlock.jacobian_local (K3). Costs and design: see the head of
csrc/element_kernels.cu.

The residual's element work runs in float64 (``dtype=None``) or in
float32 (``dtype=torch.float32``), as vasp_tpu's CellBlock.residual_local
with dtype=float32: U, U0, Jinv, detJ and vol rounded to float32, the
tables too, float32 arithmetic, and the result scattered into a float64 R.

Jacobians come in float64 or float32 (``dtype``). vasp_tpu computes its
float32 Jacobians by jax.jacfwd in float32 arithmetic on float32 inputs;
the port computes them in float64 and rounds once on the write (the
kernel's output type, and ``jacobian_plain(...).to(float32)``). This is a
designed difference: the port's float32 Jacobians are the correctly
rounded float64 ones, vasp_tpu's carry float32 rounding from every step.
"""
import numpy as np
import torch

from vasp_tpu_torch.kernels import build

# the Laplace lifting's sub-types: 1 volume, 2 volume_change, every other
# (constant, small_constant, biharmonic's bc1 and bc2) 0, the constant
# coefficient, as in fem/forms.py
_LIFT_SUB = {"volume": 1, "volume_change": 2}
# the fluid's mesh lifting: C entry point code, counter tag; the
# biharmonic lifting's element part is the Laplace one
_LIFTS = {"laplace": (0, ""), "biharmonic": (0, ""), "elastic": (1, "_elastic"),
          "no_extrapolation": (2, "_nolift")}

# device index -> the quadrature degree whose tables sit in its constant memory
_uploaded_tables = {}


def _residual_f32(dtype):
    """True for float32 element work, False for float64 (dtype None)."""
    if dtype is not None and dtype != torch.float32:
        raise ValueError(f"the element residual works in float64 (dtype "
                         f"None) or float32, not {dtype}")
    return dtype is not None


# ------------------------------------------------------------ plain ----
def residual_plain(block, U, U0, R, dtype=None):
    """R += scatter of the block's masked element residuals (in place),
    their element work in float64 (dtype None) or float32."""
    dofs = block.dofs
    args = (U[dofs], U0[dofs], block.Jinv, block.detJ, block.vol)
    if _residual_f32(dtype):
        args = [a.to(dtype) for a in args]
    r = block.kernel(*args)
    if block.rowmask is not None:
        r = r * block.rowmask.to(r.dtype)
    R.index_add_(0, dofs.reshape(-1), r.reshape(-1).to(R.dtype))
    return R


def jacobian_plain(block, U, U0, chunk=256):
    """(K,64,64) element Jacobians by torch.func.vmap(jacfwd) over chunks
    of `chunk` cells (bounds the tangent intermediates), rows masked."""
    jac = torch.func.vmap(torch.func.jacfwd(block.kernel.cell))
    K = block.dofs.shape[0]
    out = []
    for s in range(0, K, chunk):
        dofs = block.dofs[s:s + chunk]
        out.append(jac(U[dofs], U0[dofs], block.Jinv[s:s + chunk],
                       block.detJ[s:s + chunk], block.vol[s:s + chunk]))
    A = torch.cat(out) if out else U.new_zeros((0, 64, 64))
    if block.rowmask is not None:
        A = A * block.rowmask[:, :, None]
    return A


# ------------------------------------------------------------- cuda ----
# the solid materials of the CUDA kernels: C entry point code, counter tag
_MATERIALS = {"StVenantKirchoff": (0, ""), "LinearElastic": (0, ""),
              "MooneyRivlin": (1, "_mr")}


def cuda_params(kernel):
    """The kernel's scalar parameters in the C entry point's order: the
    fluid's with its lifting mode, sub-type code and p_stab (0 skips the
    stabilization), the solid's with its material code, constants and
    gravity (0 when none is given). Every configuration of fem/forms.py is
    covered; an unknown lifting or material raises as the plain version
    does."""
    if kernel.kind == "fluid":
        if kernel.lift not in _LIFTS:
            raise ValueError(f"unknown extrapolation: {kernel.lift}")
        return (kernel.rho_f, kernel.mu_f, kernel.dt, kernel.theta,
                kernel.lift_coeff, _LIFT_SUB.get(kernel.lift_sub, 0),
                _LIFTS[kernel.lift][0], kernel.p_stab)
    model = kernel.props.get("material_model", "StVenantKirchoff")
    if model not in _MATERIALS:
        raise KeyError(f"unknown material_model {model!r}; known: "
                       f"{list(_MATERIALS)}")
    mr = _MATERIALS[model][0] == 1
    # SVK has no C01, C10, C11; the kernel does not read them
    consts = tuple(float(kernel.props[k]) if mr else 0.0
                   for k in ("C01", "C10", "C11"))
    return (kernel.rho_s, float(kernel.props["mu_s"]),
            float(kernel.props["lambda_s"]), kernel.dt, kernel.theta,
            _MATERIALS[model][0], *consts,
            *(float(g) for g in kernel.gravity))


def counter_name(block, op, f32):
    """The launch counter of the block's kernel: fluid_/solid_ + op, the
    fluid's lifting tag or the solid's material tag, then _f32 for the
    float32 instance."""
    kern = block.kernel
    if kern.kind == "fluid":
        tag = _LIFTS[kern.lift][1]
    else:
        tag = _MATERIALS[kern.props.get("material_model",
                                        "StVenantKirchoff")][1]
    return f"{kern.kind}_{op}{tag}" + ("_f32" if f32 else "")


def _prepare(block, U, U0):
    """Validate the block's tensors, upload the quadrature tables if the
    device holds another degree's, and return (lib, nq, stream)."""
    lib = build.library()
    dev, f64 = U.device, torch.float64
    K = block.dofs.shape[0]
    build.require(U, "U", f64, U.shape[:1], dev)
    build.require(U0, "U0", f64, U.shape, dev)
    build.require(block.dofs, "dofs", torch.int64, (K, 64), dev)
    build.require(block.Jinv, "Jinv", f64, (K, 3, 3), dev)
    build.require(block.detJ, "detJ", f64, (K,), dev)
    build.require(block.vol, "vol", f64, (K,), dev)
    if block.rowmask is not None:
        build.require(block.rowmask, "rowmask", f64, (K, 64), dev)
    kern = block.kernel
    wq, N1, N2, dN2 = (np.ascontiguousarray(a, np.float64)
                       for a in kern.tables_np)
    nq = len(wq)
    dev_index = dev.index if dev.index is not None else torch.cuda.current_device()
    if _uploaded_tables.get(dev_index) != kern.quad_degree:
        if nq > lib.vt_element_nq_max():
            raise NotImplementedError(
                f"quadrature_degree={kern.quad_degree} has {nq} points; the "
                f"CUDA element kernels hold at most {lib.vt_element_nq_max()}")
        with torch.cuda.device(dev):
            build.check(lib.vt_set_element_tables(
                wq.ctypes.data, N1.ctypes.data, N2.ctypes.data,
                dN2.ctypes.data, nq), "vt_set_element_tables")
        _uploaded_tables[dev_index] = kern.quad_degree
    return lib, nq, build.stream_handle(dev)


def residual_cuda(block, U, U0, R, dtype=None):
    """R += the block's masked element residuals, by the K1/K2 kernel: its
    float64 instance, or its float32 one for dtype=torch.float32."""
    f32 = _residual_f32(dtype)
    lib, nq, stream = _prepare(block, U, U0)
    if f32 and nq > lib.vt_element_nq_max_f32():
        raise NotImplementedError(
            f"quadrature_degree={block.kernel.quad_degree} has {nq} points; "
            f"the float32 element residual holds at most "
            f"{lib.vt_element_nq_max_f32()} (degree 7)")
    build.require(R, "R", torch.float64, U.shape, U.device)
    kind = block.kernel.kind
    fn = lib.vt_fluid_residual if kind == "fluid" else lib.vt_solid_residual
    args = [build.ptr(t) for t in (U, U0, block.dofs, block.Jinv, block.detJ,
                                   block.vol, block.rowmask, R)]
    params = cuda_params(block.kernel)
    name = counter_name(block, "residual", f32)
    build.check(fn(*args, int(f32), block.dofs.shape[0], nq, *params,
                   stream), name)
    build.LAUNCHES[name] += 1
    return R


def jacobian_cuda(block, U, U0, dtype=torch.float64):
    """(K,64,64) masked element Jacobians in `dtype` (float64 or float32),
    by the K3 kernel."""
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"K3 writes float64 or float32, not {dtype}")
    lib, nq, stream = _prepare(block, U, U0)
    K = block.dofs.shape[0]
    A = torch.empty((K, 64, 64), dtype=dtype, device=U.device)
    kind = block.kernel.kind
    f32 = dtype == torch.float32
    fn = lib.vt_fluid_jacobian if kind == "fluid" else lib.vt_solid_jacobian
    args = [build.ptr(t) for t in (U, U0, block.dofs, block.Jinv, block.detJ,
                                   block.vol, block.rowmask, A)]
    params = cuda_params(block.kernel)
    name = counter_name(block, "jacobian", f32)
    build.check(fn(*args, int(f32), K, nq, *params, stream), name)
    build.LAUNCHES[name] += 1
    return A


# --------------------------------------------------------- dispatch ----
def block_residual(block, U, U0, R, dtype=None):
    """R += the block's masked element residuals, their element work in
    float64 (dtype None) or float32: plain on CPU tensors, the CUDA kernel
    on CUDA tensors."""
    if build.on_cuda(U, "element"):
        return residual_cuda(block, U, U0, R, dtype)
    return residual_plain(block, U, U0, R, dtype)


def block_jacobian(block, U, U0, dtype=torch.float64):
    """(K,64,64) masked element Jacobians in `dtype`: plain on CPU
    tensors, the CUDA kernel on CUDA tensors."""
    if build.on_cuda(U, "element"):
        return jacobian_cuda(block, U, U0, dtype)
    return jacobian_plain(block, U, U0).to(dtype)
