"""K7: one Ruiz sweep (row/column maxima) and the element rescale.

Plain torch versions (``ruiz_sweep_plain``, ``ruiz_scale_plain``), CUDA
launches (csrc/ruiz.cu) and the dispatch fem/scaling.py calls: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises. The
kernels take float32 element matrices, which the banded preconditioner
equilibrates, of the cell blocks (64 local dofs) and the Robin facet
blocks (36); the sweep also float64 ones, which the RAS preconditioner
equilibrates (counted apart, suffixed _f64).

Replaces the sweep body of vasp_tpu/fem/scaling.py ruiz_scales and
scale_element_jacobians. Costs and design: see the head of csrc/ruiz.cu.
"""
import torch

from vasp_tpu_torch.kernels import build
from vasp_tpu_torch.kernels.matvec import NLOCS, launch_name


# ------------------------------------------------------------ plain ----
def ruiz_sweep_plain(A, dofs, dr, dc, mask, rmax, cmax):
    """rmax/cmax (in place) max= the row/column maxima of |dr_i A_ij dc_j|
    over the block's cells, bc rows and columns left out."""
    As = torch.abs(dr[dofs][:, :, None] * A * dc[dofs][:, None, :])
    bcm = mask[dofs]
    As = torch.where(bcm[:, :, None] | bcm[:, None, :], 0.0, As)
    flat = dofs.reshape(-1)
    rmax.scatter_reduce_(0, flat, As.amax(dim=2).reshape(-1), "amax")
    cmax.scatter_reduce_(0, flat, As.amax(dim=1).reshape(-1), "amax")


def ruiz_scale_plain(A, dofs, dr, dc):
    """dr[rows] A_e dc[cols] for every cell of the block."""
    return dr[dofs][:, :, None] * A * dc[dofs][:, None, :]


# ------------------------------------------------------------- cuda ----
def _check(A, dofs, dr, dc, dtypes=(torch.float32,)):
    dev, dt = A.device, A.dtype
    K, n = dofs.shape
    if n not in NLOCS:
        raise ValueError(f"K7 takes {NLOCS} local dofs, got {n}")
    if dt not in dtypes:
        raise ValueError(f"K7 takes {dtypes} element matrices, got {dt}")
    build.require(A, "A", dt, (K, n, n), dev)
    build.require(dofs, "dofs", torch.int64, (K, n), dev)
    build.require(dr, "dr", dt, dr.shape[:1], dev)
    build.require(dc, "dc", dt, dr.shape, dev)
    return build.library(), K, n, build.stream_handle(dev)


def ruiz_sweep_cuda(A, dofs, dr, dc, mask, rmax, cmax):
    lib, K, n, stream = _check(A, dofs, dr, dc,
                               (torch.float32, torch.float64))
    f64 = A.dtype == torch.float64
    build.require(mask, "mask", torch.bool, dr.shape, A.device)
    build.require(rmax, "rmax", A.dtype, dr.shape, A.device)
    build.require(cmax, "cmax", A.dtype, dr.shape, A.device)
    name = launch_name("ruiz_sweep", n) + ("_f64" if f64 else "")
    build.check(lib.vt_ruiz_sweep(*map(build.ptr, (A, dofs, dr, dc, mask,
                                                   rmax, cmax)), K, n,
                                  int(f64), stream), name)
    build.LAUNCHES[name] += 1


def ruiz_scale_cuda(A, dofs, dr, dc):
    lib, K, n, stream = _check(A, dofs, dr, dc)
    out = torch.empty_like(A)
    build.check(lib.vt_ruiz_scale(*map(build.ptr, (A, dofs, dr, dc, out)), K,
                                  n, stream), "ruiz_scale")
    build.LAUNCHES[launch_name("ruiz_scale", n)] += 1
    return out


# --------------------------------------------------------- dispatch ----
def ruiz_sweep(A, dofs, dr, dc, mask, rmax, cmax):
    if build.on_cuda(A, "ruiz_sweep"):
        return ruiz_sweep_cuda(A, dofs, dr, dc, mask, rmax, cmax)
    return ruiz_sweep_plain(A, dofs, dr, dc, mask, rmax, cmax)


def ruiz_scale(A, dofs, dr, dc):
    if build.on_cuda(A, "ruiz_scale"):
        return ruiz_scale_cuda(A, dofs, dr, dc)
    return ruiz_scale_plain(A, dofs, dr, dc)
