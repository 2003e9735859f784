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

The quadrature tables reach the kernels by two routes (``table_route``):
the constant bank, where a rule fits it (K1/K2 up to 125 points in
float64, 64 in float32; K13 up to 64), uploaded once per degree and
device; or device memory, the packed tables of ``table_pack``, for every
rule past that and for K3 at every degree. No degree is refused.

K3 linearises the forms at the quadrature points (csrc/element_forms.cuh):
per point the derivative of the point flux by the point state, by forward
mode over the same flux function the residual runs, contracted with the
basis (``jacobian_launch`` gives its block's chunk of points and shared
memory).

Jacobians come in float64 or float32 (``dtype``). vasp_tpu computes its
float32 Jacobians by jax.jacfwd in float32 arithmetic on float32 inputs;
the port computes them in float64 and rounds once on the write (the
kernel's output type, and ``jacobian_plain(...).to(float32)``). This is a
designed difference: the port's float32 Jacobians are the correctly
rounded float64 ones, vasp_tpu's carry float32 rounding from every step.

K13, the order-3 Taylor delta of the endgame and of the anchor chain
(vasp_tpu/fem/assembly.py Assembler.residual_delta and residual_delta2 on
the cell blocks), has the same three parts: ``delta_plain`` /
``delta2_plain`` (``taylor_terms``: three nested torch.func.jvp of the
per-cell kernel along the same tangents, whose k-th is jax.experimental.jet's
k-th output term y_k), ``delta_cuda`` / ``delta2_cuda`` (csrc/delta_kernels.cu)
and ``block_delta``. Its value is vasp_tpu's: y1 + y2 + y3 in float32 on
float32-rounded A, U0 and geometry with du = U - A (and du0) rounded, the
row mask applied, accumulated in float64. jet's terms are derivatives, so
this counts the second- and third-order terms of R(U) - R(A) ~ y1 + y2/2 +
y3/6 twice and six times over (ROADMAP.md queue 3); the port computes what
vasp_tpu computes.
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

# (source, device index) -> the quadrature degree whose tables sit in that
# source's constant memory on that device ("element": element_kernels.cu,
# "delta": delta_kernels.cu)
_uploaded_tables = {}
# (degree, device index, "f64" or "f32") -> the packed tables in device
# memory (table_pack)
_device_tables = {}

# the constant bank's capacity in quadrature points
# (csrc/element_forms.cuh VT_NQ_MAX, VT_NQ_MAX_F32): the float64 tables of
# K1/K2, the float32 ones of K1/K2 f32 and K13. A rule of more points is
# read from device memory, as K3 reads every rule.
NQ_CONSTANT = {"f64": 125, "f32": 64}
# K3's block of threads, and the point quantities its tangents run over
# (csrc/element_kernels.cu, element_forms.cuh n_states)
JAC_THREADS = 256
_JAC_STATES = {"fluid": 25, "solid": 15}


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


def _jvp3(f, primals, tangents):
    """(y1, y2, y3): the first three derivatives of t -> f(primals + t
    tangents) at t = 0, by three nested torch.func.jvp along the same
    tangents (the k-th nesting differentiates the (k-1)-th term once more)."""
    def g1(*p):
        return torch.func.jvp(f, p, tangents)

    def g2(*p):
        return torch.func.jvp(g1, p, tangents)

    (((_, y1), (_, y2)), ((_, _), (_, y3))) = torch.func.jvp(g2, primals,
                                                            tangents)
    return y1, y2, y3


def taylor_terms(block, U, A, U0, U0new=None, dtype=torch.float32,
                 chunk=2048):
    """(y1, y2, y3), each (K,64) in `dtype`, rows masked: the derivatives
    jax.experimental.jet returns for the block's kernel at (A, U0) with the
    series [du, 0, 0] on the state, du = U - A, and with U0new given also
    [du0, 0, 0] on the previous state, du0 = U0new - U0. Every input is
    rounded to `dtype` (float32 as in vasp_tpu; float64 to measure the
    series itself), du and du0 after their float64 differences. Cells go
    in chunks of `chunk` (bounds the nested tangents' intermediates)."""
    cell = block.kernel.cell
    dofs = block.dofs
    args = [A[dofs], (U - A)[dofs], U0[dofs]]
    if U0new is not None:
        args.append((U0new - U0)[dofs])
    args = [a.to(dtype) for a in args] + [
        block.Jinv.to(dtype), block.detJ.to(dtype), block.vol.to(dtype)]

    if U0new is None:
        def one(a, du, u0, J, dJ, v):
            return _jvp3(lambda x: cell(x, u0, J, dJ, v), (a,), (du,))
    else:
        def one(a, du, u0, du0, J, dJ, v):
            return _jvp3(lambda x, x0: cell(x, x0, J, dJ, v), (a, u0),
                         (du, du0))

    # the kernel's cached tables are made here, outside the transforms: a
    # tensor made under torch.func.jvp belongs to that jvp's level and
    # would escape it through the cache
    block.kernel.tables(args[0])
    terms = torch.func.vmap(one)
    K = dofs.shape[0]
    parts = [terms(*(t[s:s + chunk] for t in args))
             for s in range(0, K, chunk)]
    ys = [torch.cat([p[k] for p in parts]) if parts
          else A.new_zeros((0, 64), dtype=dtype) for k in range(3)]
    if block.rowmask is not None:
        ys = [y * block.rowmask.to(dtype) for y in ys]
    return tuple(ys)


def delta_plain(block, U, A, U0, R, dtype=torch.float32, U0new=None):
    """R += the block's delta y1 + y2 + y3 (taylor_terms, in `dtype`),
    vasp_tpu's residual_delta on this block; with U0new its residual_delta2
    (the previous state moving from U0 to U0new too)."""
    y1, y2, y3 = taylor_terms(block, U, A, U0, U0new, dtype=dtype)
    R.index_add_(0, block.dofs.reshape(-1),
                 (y1 + y2 + y3).reshape(-1).to(R.dtype))
    return R


def delta2_plain(block, U, A, U0new, U0old, R, dtype=torch.float32):
    """R += the block's two-argument delta, in residual_delta2's argument
    order."""
    return delta_plain(block, U, A, U0old, R, dtype, U0new)


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


def table_pack(tables_np, dtype=np.float64):
    """The packed quadrature tables [wq | N1 | N2 | dN2] of a kernel's
    tables_np (nq * 45 entries, csrc/element_forms.cuh GlobalTab), in
    float64 or rounded once to float32."""
    return np.concatenate([np.asarray(a, np.float64).reshape(-1)
                           for a in tables_np]).astype(dtype)


def table_route(nq, precision):
    """Where the CUDA residuals read a rule of nq points in `precision`
    ("f64": K1/K2; "f32": K1/K2 f32 and K13): "constant", the constant
    bank, or "memory", device memory."""
    return "constant" if nq <= NQ_CONSTANT[precision] else "memory"


def jacobian_launch(kind, nq):
    """(points a chunk, dynamic shared memory bytes) of K3's block on a rule
    of nq points: as many points as the block has threads for one tangent
    each (at most nq), and the buffers csrc/element_kernels.cu lays out
    for them (u, u0, Jinv; per point the basis, N1 and w detJ, the two
    states and D_q in rows of 26, the previous state's terms; at least the
    64 x 64 staging of A_e), in doubles."""
    qc = min(JAC_THREADS // _JAC_STATES[kind], nq)
    return qc, 8 * (144 + max(qc * (40 + 8 + 2 * 26 + 20 + 25 * 26),
                              64 * 64))


def _device_index(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device()


def device_tables(kern, dev, precision):
    """The kernel's packed tables on `dev`, float64 ("f64") or float32
    ("f32"), made once per degree and device."""
    key = (kern.quad_degree, _device_index(dev), precision)
    if key not in _device_tables:
        dtype = np.float64 if precision == "f64" else np.float32
        _device_tables[key] = torch.as_tensor(
            table_pack(kern.tables_np, dtype), device=dev)
    return _device_tables[key]


def _prepare(block, U, U0):
    """Validate the block's tensors; (lib, nq, stream)."""
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
    return lib, len(block.kernel.tables_np[0]), build.stream_handle(dev)


def _tables(block, dev, precision, source="element"):
    """The tables argument of a residual launch (K1/K2, K13): None, the
    constant bank, where the rule fits it (uploaded into the source's bank
    first if the device holds another degree's there; source "element",
    element_kernels.cu, or "delta", delta_kernels.cu), else the packed
    tables in device memory."""
    kern = block.kernel
    if table_route(len(kern.tables_np[0]), precision) == "memory":
        return device_tables(kern, dev, precision)
    key = (source, _device_index(dev))
    if _uploaded_tables.get(key) != kern.quad_degree:
        lib = build.library()
        wq, N1, N2, dN2 = (np.ascontiguousarray(a, np.float64)
                           for a in kern.tables_np)
        upload = (lib.vt_set_element_tables if source == "element"
                  else lib.vt_set_delta_tables)
        with torch.cuda.device(dev):
            build.check(upload(wq.ctypes.data, N1.ctypes.data, N2.ctypes.data,
                               dN2.ctypes.data, len(wq)), f"{source} tables")
        _uploaded_tables[key] = kern.quad_degree
    return None


def residual_cuda(block, U, U0, R, dtype=None):
    """R += the block's masked element residuals, by the K1/K2 kernel: its
    float64 instance, or its float32 one for dtype=torch.float32."""
    f32 = _residual_f32(dtype)
    lib, nq, stream = _prepare(block, U, U0)
    build.require(R, "R", torch.float64, U.shape, U.device)
    tables = _tables(block, U.device, "f32" if f32 else "f64")
    kind = block.kernel.kind
    fn = lib.vt_fluid_residual if kind == "fluid" else lib.vt_solid_residual
    args = [build.ptr(t) for t in (U, U0, block.dofs, block.Jinv, block.detJ,
                                   block.vol, block.rowmask, tables, R)]
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
    tables = device_tables(block.kernel, U.device, "f64")
    args = [build.ptr(t) for t in (U, U0, block.dofs, block.Jinv, block.detJ,
                                   block.vol, block.rowmask, tables, A)]
    params = cuda_params(block.kernel)
    name = counter_name(block, "jacobian", f32)
    qc, smem = jacobian_launch(kind, nq)
    build.check(fn(*args, int(f32), K, nq, qc, smem, *params, stream), name)
    build.LAUNCHES[name] += 1
    return A


def _delta_launch(block, U, A, U0, U0new, R):
    """R += the block's K13 delta (delta2 where U0new is given)."""
    lib, nq, stream = _prepare(block, U, U0)
    dev = U.device
    build.require(A, "A", torch.float64, U.shape, dev)
    build.require(R, "R", torch.float64, U.shape, dev)
    delta2 = U0new is not None
    if delta2:
        build.require(U0new, "U0new", torch.float64, U.shape, dev)
    tables = _tables(block, dev, "f32", "delta")
    kind = block.kernel.kind
    fn = lib.vt_fluid_delta if kind == "fluid" else lib.vt_solid_delta
    args = [build.ptr(t) for t in (U, A, U0, U0new, block.dofs, block.Jinv,
                                   block.detJ, block.vol, block.rowmask,
                                   tables, R)]
    name = counter_name(block, "delta2" if delta2 else "delta", False)
    build.check(fn(*args, int(delta2), block.dofs.shape[0], nq,
                   *cuda_params(block.kernel), stream), name)
    build.LAUNCHES[name] += 1
    return R


def delta_cuda(block, U, A, U0, R):
    """R += the block's delta, by the K13 kernel (float32 series)."""
    return _delta_launch(block, U, A, U0, None, R)


def delta2_cuda(block, U, A, U0new, U0old, R):
    """R += the block's two-argument delta, by the K13 kernel's delta2
    instance."""
    return _delta_launch(block, U, A, U0old, U0new, R)


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


def block_delta(block, U, A, U0, R, U0new=None):
    """R += the block's K13 delta along U - A at the previous state U0 (and,
    with U0new, along U0new - U0 on it: the two-argument form): plain on
    CPU tensors, the CUDA kernel on CUDA tensors."""
    if not build.on_cuda(U, "element"):
        return delta_plain(block, U, A, U0, R, U0new=U0new)
    if U0new is None:
        return delta_cuda(block, U, A, U0, R)
    return delta2_cuda(block, U, A, U0new, U0, R)
