"""K20: the device code of postprocessing, float64.

- K20a ``wss_load``: the wall-shear-stress load of the fluid boundary per
  timestep (fields/hemodynamics.py);
- K20b ``stress_strain``: Cauchy stress, Green-Lagrange strain and their
  largest eigenvalues at the solid's cell vertices per timestep, one
  instance per material (fields/stress_strain.py), and ``max_eig``, the
  eigenvalue alone (spectral/hi_pass_viz.py);
- K20c ``spectral_power``: the node mean of the scaled, one-sided |X|^2 of
  an rfft spectrum (spectral/core.py).

Each has a plain torch version (``*_plain``), its CUDA launch (``*_cuda``,
csrc/postproc.cu) and the dispatch the callers use: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.

Replaces vasp_tpu/postprocessing/fields/hemodynamics.py
FluidBoundaryTables.wss_series (one_step), fields/stress_strain.py
one_step_full (cellvert, get_eig) and spectral/core.py get_psd /
get_spectrogram after the rfft. Costs and design: see the head of
csrc/postproc.cu.
"""
import torch

from vasp_tpu_torch.fem.kinematics import E_, S_, get_eig
from vasp_tpu_torch.fem.smallmat import det3
from vasp_tpu_torch.kernels import build
from vasp_tpu_torch.kernels.element import _MATERIALS

_F64, _I64 = torch.float64, torch.int64


# ------------------------------------------------------------ plain ----
def wss_load_plain(u, dofs, G2, normals, wq, N1f, area2, fb, nb, mu):
    """u (T, n_p2, 3) -> (T, nb, 3): per timestep the P1 load of the
    tangential traction on the fluid boundary, vasp_tpu's one_step."""
    ue = u[:, dofs]  # (T,K,10,3)
    grad = torch.einsum("tkai,kqaj->tkqij", ue, G2)
    sig = mu * (grad + grad.transpose(-1, -2))
    t = torch.einsum("tkqij,kj->tkqi", sig, normals)
    tn = torch.einsum("tkqi,ki->tkq", t, normals)
    tau = t - tn[..., None] * normals[:, None, :]
    b = torch.einsum("q,qa,tkqi,k->tkai", wq, N1f, tau, area2)
    out = u.new_zeros((u.shape[0], nb, 3))
    return out.index_add_(1, fb.reshape(-1), b.reshape(u.shape[0], -1, 3))


def stress_strain_plain(d, dofs, G, segments):
    """d (T, n_p2, 3) -> (sig, eps (T,K,4,3,3), mps, mpe (T,K,4)): per
    solid (cell, vertex) sigma = F S F^T / J, E, and their largest
    eigenvalues; segments lists (k0, K_seg, props), one per material.

    The displacement gradient is a sum over the 10 nodes, in node order, of
    elementwise products, so each entry rounds the same way however many
    steps T the batch holds: a batched einsum goes to a matrix product
    whose blocking, and so its rounding, follows T (and the threads it
    gets), which moved a streamed series' outputs by up to 4e-11 of their
    scale against one pass over the whole series (the Cardano eigenvalues
    amplify a rounding change of the tensors)."""
    dk = d[:, dofs]  # (T,K,10,3)
    gd = dk[:, :, 0, None, :, None] * G[None, :, :, 0, None, :]
    for a in range(1, 10):
        gd = gd + dk[:, :, a, None, :, None] * G[None, :, :, a, None, :]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    sigs = []
    for k0, n, props in segments:
        g = gd[:, k0:k0 + n]
        F = eye + g
        sigs.append(F @ S_(g, props) @ F.transpose(-1, -2)
                    / det3(F)[..., None, None])
    sig = torch.cat(sigs, dim=1)
    eps = E_(gd)
    return sig, eps, get_eig(sig), get_eig(eps)


def spectral_power_plain(X, scale, even):
    """X (n, B, F) complex -> (F, B): the node mean of |X|^2 scale with the
    one-sided correction (x2 except DC and, for an even FFT length, the
    Nyquist bin), vasp_tpu's get_psd / get_spectrogram after the rfft."""
    p = X.abs() ** 2 * scale
    p[..., 1:] *= 2.0
    if even:
        p[..., -1] *= 0.5
    return p.mean(dim=0).T.contiguous()


# ------------------------------------------------------------- cuda ----
def _check_all(dev, **tensors):
    for name, (t, dtype, shape) in tensors.items():
        build.require(t, name, dtype, shape, dev)


def wss_load_cuda(u, dofs, G2, normals, wq, N1f, area2, fb, nb, mu):
    lib = build.library()
    dev = u.device
    T, n_p2 = u.shape[:2]
    K, nq = dofs.shape[0], wq.shape[0]
    _check_all(dev, u=(u, _F64, (T, n_p2, 3)), dofs=(dofs, _I64, (K, 10)),
               G2=(G2, _F64, (K, nq, 10, 3)), normals=(normals, _F64, (K, 3)),
               wq=(wq, _F64, (nq,)), N1f=(N1f, _F64, (nq, 3)),
               area2=(area2, _F64, (K,)), fb=(fb, _I64, (K, 3)))
    out = torch.zeros((T, nb, 3), dtype=_F64, device=dev)
    build.check(lib.vt_wss_load(
        *map(build.ptr, (u, dofs, G2, normals, wq, N1f, area2, fb, out)),
        K, nq, T, n_p2, nb, float(mu), build.stream_handle(dev)), "wss_load")
    build.LAUNCHES["wss_load"] += 1
    return out


def stress_strain_cuda(d, dofs, G, segments):
    lib = build.library()
    dev = d.device
    T, n_p2 = d.shape[:2]
    K = dofs.shape[0]
    _check_all(dev, d=(d, _F64, (T, n_p2, 3)), dofs=(dofs, _I64, (K, 10)),
               G=(G, _F64, (K, 4, 10, 3)))
    sig = torch.empty((T, K, 4, 3, 3), dtype=_F64, device=dev)
    eps = torch.empty_like(sig)
    mps = torch.empty((T, K, 4), dtype=_F64, device=dev)
    mpe = torch.empty_like(mps)
    for k0, n, props in segments:
        mat, tag = _MATERIALS[props.get("material_model",
                                        "StVenantKirchoff")]
        name = "stress_strain" + (tag or "_svk")
        consts = [float(props.get(c) or 0.0) for c in
                  ("mu_s", "lambda_s", "C01", "C10", "C11")]
        build.check(lib.vt_stress_strain(
            build.ptr(d), build.ptr(dofs), build.ptr(G), mat, *consts,
            *map(build.ptr, (sig, eps, mps, mpe)), k0, n, K, T, n_p2,
            build.stream_handle(dev)), name)
        build.LAUNCHES[name] += 1
    return sig, eps, mps, mpe


def max_eig_cuda(A):
    lib = build.library()
    dev = A.device
    build.require(A, "A", _F64, (*A.shape[:-2], 3, 3), dev)
    out = torch.empty(A.shape[:-2], dtype=_F64, device=dev)
    build.check(lib.vt_max_eig(build.ptr(A), build.ptr(out), out.numel(),
                               build.stream_handle(dev)), "max_eig")
    build.LAUNCHES["max_eig"] += 1
    return out


def spectral_power_cuda(X, scale, even):
    lib = build.library()
    dev = X.device
    n, B, F = X.shape
    build.require(X, "X", torch.complex128, (n, B, F), dev)
    out = torch.empty((F, B), dtype=_F64, device=dev)
    build.check(lib.vt_spectral_power(
        build.ptr(X), build.ptr(out), n, B, F, float(scale), int(even),
        build.stream_handle(dev)), "spectral_power")
    build.LAUNCHES["spectral_power"] += 1
    return out


# --------------------------------------------------------- dispatch ----
def wss_load(u, dofs, G2, normals, wq, N1f, area2, fb, nb, mu):
    """(T, nb, 3) WSS loads of the velocity series u (T, n_p2, 3): plain
    on CPU tensors, K20a on CUDA tensors."""
    args = (u, dofs, G2, normals, wq, N1f, area2, fb, nb, mu)
    if build.on_cuda(u, "wss_load"):
        return wss_load_cuda(*args)
    return wss_load_plain(*args)


def stress_strain(d, dofs, G, segments):
    """(sig, eps, mps, mpe) of the displacement series d (T, n_p2, 3):
    plain on CPU tensors, K20b (an instance per segment's material) on
    CUDA tensors."""
    if build.on_cuda(d, "stress_strain"):
        return stress_strain_cuda(d, dofs, G, segments)
    return stress_strain_plain(d, dofs, G, segments)


def max_eig(A):
    """Largest eigenvalue of symmetric (..., 3, 3) float64 tensors: plain
    (kinematics.get_eig) on CPU tensors, K20b's eigenvalue on CUDA ones."""
    if build.on_cuda(A, "max_eig"):
        return max_eig_cuda(A.contiguous())
    return get_eig(A)


def spectral_power(X, scale, even):
    """(F, B) node-mean one-sided power of the rfft spectrum X (n, B, F):
    plain on CPU tensors, K20c on CUDA tensors."""
    if build.on_cuda(X, "spectral_power"):
        return spectral_power_cuda(X, scale, even)
    return spectral_power_plain(X, scale, even)
