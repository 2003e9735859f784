"""K16: the biharmonic lifting correction beta L M^-1 L d - beta gamma L d
on the fluid d rows of a mixed vector.

The plain torch version (``correction_plain``, with ``_L_apply``: gather
each fluid cell's 10 P2 nodes, multiply by its 10x10 stiffness Ke,
index_add_ back), the CUDA launch (``correction_cuda``, csrc/lifting.cu)
and the dispatch the solvers call (``correction_apply``): a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Replaces vasp_tpu/fem/biharmonic.py _L_apply / correction_apply. The
correction is linear in U, so it serves the residual (on the float64 U)
and the Krylov matvec (on the Krylov vector, float32 under
krylov_dtype="f32"). Its arithmetic runs in U's dtype: Ke, minv, beta and
beta_gamma are rounded to it, as vasp_tpu's ``.astype(dvec.dtype)`` casts
do. The mask order is vasp_tpu's: wfree masks w = M^-1 L d, dmask masks
the result (solid-owned d rows carry no lifting). ``lift`` is the dict of
fem/biharmonic.build_biharmonic. Costs and design: see the head of
csrc/lifting.cu.
"""
import torch

from vasp_tpu_torch.kernels import build

_FLOATS = (torch.float32, torch.float64)


# ------------------------------------------------------------ plain ----
def _L_apply(lift, dvec):
    """y = L d, d as (n_p2, 3)."""
    p2dofs = lift["p2dofs"]
    de = dvec[p2dofs]  # (K,10,3)
    ye = torch.einsum("kab,kbi->kai", lift["Ke"].to(dvec.dtype), de)
    y = torch.zeros_like(dvec)
    return y.index_add_(0, p2dofs.reshape(-1), ye.reshape(-1, 3))


def correction_plain(lift, U):
    """The correction over the full mixed vector: zero outside the d
    rows, in U's dtype."""
    n_d = 3 * lift["minv"].shape[0]
    d = U[:n_d].reshape(-1, 3)
    Ld = _L_apply(lift, d)
    w = Ld * lift["minv"].to(d.dtype)[:, None]
    w = torch.where(lift["wfree"][:, None], w, torch.zeros((), dtype=d.dtype,
                                                            device=d.device))
    # total d-block = beta L M^-1 L; the element kernels carry beta*gamma*L
    rd = lift["beta"] * _L_apply(lift, w) - lift["beta_gamma"] * Ld
    # kinematic-row mask: no lifting contribution on solid-owned d-rows
    rd = rd * lift["dmask"].to(d.dtype)[:, None]
    out = torch.zeros_like(U)
    out[:n_d] = rd.reshape(-1)
    return out


# ------------------------------------------------------------- cuda ----
def counter_name(U):
    return "lift_correction" + ("_f32" if U.dtype == torch.float32 else "")


def correction_cuda(lift, U):
    """The correction by the K16 kernel, in U's dtype (float64 or
    float32)."""
    lib = build.library()
    dev = U.device
    if U.dtype not in _FLOATS:
        raise ValueError(f"K16 takes a float32 or float64 vector, got "
                         f"{U.dtype}")
    K = lift["p2dofs"].shape[0]
    n_p2 = lift["minv"].shape[0]
    build.require(U, "U", U.dtype, U.shape[:1], dev)
    if U.shape[0] < 3 * n_p2:
        raise ValueError(f"U has {U.shape[0]} entries, fewer than the "
                         f"{3 * n_p2} d rows of the lifting tables")
    build.require(lift["Ke"], "Ke", torch.float64, (K, 10, 10), dev)
    build.require(lift["p2dofs"], "p2dofs", torch.int32, (K, 10), dev)
    build.require(lift["minv"], "minv", torch.float64, (n_p2,), dev)
    build.require(lift["wfree"], "wfree", torch.bool, (n_p2,), dev)
    build.require(lift["dmask"], "dmask", torch.float64, (n_p2,), dev)
    out = torch.empty_like(U)
    Ld = torch.empty(3 * n_p2, dtype=U.dtype, device=dev)
    name = counter_name(U)
    build.check(lib.vt_lift_correction(
        build.ptr(U), build.ptr(lift["Ke"]), build.ptr(lift["p2dofs"]),
        build.ptr(lift["minv"]), build.ptr(lift["wfree"]),
        build.ptr(lift["dmask"]), float(lift["beta"]),
        float(lift["beta_gamma"]), build.ptr(Ld), build.ptr(out),
        int(U.dtype == torch.float32), K, n_p2, U.shape[0],
        build.stream_handle(dev)), name)
    build.LAUNCHES[name] += 1
    return out


# --------------------------------------------------------- dispatch ----
def correction_apply(lift, U):
    """The correction in U's dtype: plain on CPU tensors, the CUDA kernel
    on CUDA tensors."""
    if build.on_cuda(U, "lift_correction"):
        return correction_cuda(lift, U)
    return correction_plain(lift, U)
