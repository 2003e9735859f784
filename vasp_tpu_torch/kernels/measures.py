"""K19 (on-path part): DG0 speed projection, the P2 boundary flux and the
DG0 projection of det(I + grad d).

Plain torch versions, CUDA launches (csrc/measures.cu) and the dispatch
fem/measures.py calls: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.

Replaces vasp_tpu/fem/measures.py dg0_project_speed,
BoundaryMeasure.integrate_p2_dot_n and dg0_project_jacobian. Costs and
design: see the head of csrc/measures.cu.
"""
import torch

from vasp_tpu_torch.fem.smallmat import det3
from vasp_tpu_torch.kernels import build


# ------------------------------------------------------------ plain ----
def dg0_project_speed_plain(v, cell_dofs, N2, wq):
    """v (n2,3), cell_dofs (Nc,10), N2 (nq,10), wq (nq,) -> (Nc,)."""
    vq = torch.einsum("qa,kai->kqi", N2, v[cell_dofs])
    speed = torch.linalg.norm(vq, dim=2)
    return torch.einsum("q,kq->k", wq, speed) / wq.sum()


def integrate_p2_dot_n_plain(field, dofs, normals, area2, N2t, wq):
    """field (n2,3), dofs (K,6), normals (K,3), area2 (K,), N2t (nq,6),
    wq (nq,) -> () sum over facets of int (u . n) ds."""
    uq = torch.einsum("qa,kai->kqi", N2t, field[dofs])
    un = torch.einsum("kqi,ki->kq", uq, normals)
    return torch.einsum("q,kq,k->", wq, un, area2)


def dg0_project_jacobian_plain(d, cell_dofs, Jinv, dN2, wq):
    """d (n2,3), cell_dofs (Nc,10), Jinv (Nc,3,3), dN2 (nq,10,3), wq (nq,)
    -> (Nc,): the weighted cell average of det(I + grad d)."""
    G2 = torch.einsum("qaj,kjl->kqal", dN2, Jinv)
    gd = torch.einsum("kai,kqaj->kqij", d[cell_dofs], G2)  # (Nc,nq,3,3)
    F = torch.eye(3, dtype=d.dtype, device=d.device) + gd
    return torch.einsum("q,kq->k", wq, det3(F)) / wq.sum()


# ------------------------------------------------------------- cuda ----
def _check_all(dev, **tensors):
    for name, (t, dtype, shape) in tensors.items():
        build.require(t, name, dtype, shape, dev)


def dg0_project_speed_cuda(v, cell_dofs, N2, wq):
    lib = build.library()
    dev, f64 = v.device, torch.float64
    Nc, nq = cell_dofs.shape[0], wq.shape[0]
    _check_all(dev, v=(v, f64, (v.shape[0], 3)),
               cell_dofs=(cell_dofs, torch.int64, (Nc, 10)),
               N2=(N2, f64, (nq, 10)), wq=(wq, f64, (nq,)))
    out = torch.empty(Nc, dtype=f64, device=dev)
    build.check(lib.vt_dg0_project_speed(
        build.ptr(v), build.ptr(cell_dofs), build.ptr(N2), build.ptr(wq), nq,
        float(wq.sum()), build.ptr(out), Nc, build.stream_handle(dev)),
        "dg0_project_speed")
    build.LAUNCHES["dg0_project_speed"] += 1
    return out


def integrate_p2_dot_n_cuda(field, dofs, normals, area2, N2t, wq):
    lib = build.library()
    dev, f64 = field.device, torch.float64
    K, nq = dofs.shape[0], wq.shape[0]
    _check_all(dev, field=(field, f64, (field.shape[0], 3)),
               dofs=(dofs, torch.int64, (K, 6)),
               normals=(normals, f64, (K, 3)), area2=(area2, f64, (K,)),
               N2t=(N2t, f64, (nq, 6)), wq=(wq, f64, (nq,)))
    out = torch.zeros(1, dtype=f64, device=dev)
    build.check(lib.vt_integrate_p2_dot_n(
        build.ptr(field), build.ptr(dofs), build.ptr(normals),
        build.ptr(area2), build.ptr(N2t), build.ptr(wq), nq, K,
        build.ptr(out), build.stream_handle(dev)), "integrate_p2_dot_n")
    build.LAUNCHES["integrate_p2_dot_n"] += 1
    return out[0]


def dg0_project_jacobian_cuda(d, cell_dofs, Jinv, dN2, wq):
    lib = build.library()
    dev, f64 = d.device, torch.float64
    Nc, nq = cell_dofs.shape[0], wq.shape[0]
    _check_all(dev, d=(d, f64, (d.shape[0], 3)),
               cell_dofs=(cell_dofs, torch.int64, (Nc, 10)),
               Jinv=(Jinv, f64, (Nc, 3, 3)), dN2=(dN2, f64, (nq, 10, 3)),
               wq=(wq, f64, (nq,)))
    out = torch.empty(Nc, dtype=f64, device=dev)
    build.check(lib.vt_dg0_project_jacobian(
        build.ptr(d), build.ptr(cell_dofs), build.ptr(Jinv), build.ptr(dN2),
        build.ptr(wq), nq, build.ptr(out), Nc, build.stream_handle(dev)),
        "dg0_project_jacobian")
    build.LAUNCHES["dg0_project_jacobian"] += 1
    return out


# --------------------------------------------------------- dispatch ----
def dg0_project_speed(v, cell_dofs, N2, wq):
    if build.on_cuda(v, "measure"):
        return dg0_project_speed_cuda(v, cell_dofs, N2, wq)
    return dg0_project_speed_plain(v, cell_dofs, N2, wq)


def integrate_p2_dot_n(field, dofs, normals, area2, N2t, wq):
    if build.on_cuda(field, "measure"):
        return integrate_p2_dot_n_cuda(field, dofs, normals, area2, N2t, wq)
    return integrate_p2_dot_n_plain(field, dofs, normals, area2, N2t, wq)


def dg0_project_jacobian(d, cell_dofs, Jinv, dN2, wq):
    if build.on_cuda(d, "measure"):
        return dg0_project_jacobian_cuda(d, cell_dofs, Jinv, dN2, wq)
    return dg0_project_jacobian_plain(d, cell_dofs, Jinv, dN2, wq)
