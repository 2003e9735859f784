"""The CUDA kernels against their plain torch versions on the card, on the
tiny tube (the same checks chip_smoke.py makes at full size).

Marked `cuda`: they need a CUDA device and nvcc, and skip without them.
The module imports no jax and builds its own mesh, so on a GPU machine
without jax it runs apart from conftest.py:
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest"""
import numpy as np
import pytest
import torch

from vasp_tpu_torch.fem.measures import BoundaryMeasure
from vasp_tpu_torch.fem.quadrature import tet_quadrature
from vasp_tpu_torch.fem.shape import p2_tet
from vasp_tpu_torch.kernels import build, element
from vasp_tpu_torch.kernels import measures as km
from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
from vasp_tpu_torch.run.system import FSISystem

pytestmark = pytest.mark.cuda
RTOL = 1e-12  # f64 on both sides; the atomics' order varies


@pytest.fixture(scope="module")
def system():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tube = fsi_tube_mesh(n_theta=12, n_r_fluid=2, n_r_solid=1, n_z=8)
    build.library()  # builds with nvcc; raises where the toolkit is missing
    cfg = dict(dt=1e-3, theta=0.501, rho_f=1.025e3, mu_f=3.5e-3, rho_s=1e3,
               mu_s=3.45e5, lambda_s=3.1e6, quadrature_degree=6,
               device="cuda")
    sysm = FSISystem(tube, cfg)
    rng = np.random.default_rng(30)
    sp = sysm.space
    scale = np.concatenate([np.full(3 * sp.n_p2, 1e-6),
                            np.full(3 * sp.n_p2, 1e-2),
                            np.full(sp.n_p1, 1e2)])
    U = torch.as_tensor(rng.normal(size=sp.ndof) * scale, device="cuda")
    U0 = torch.as_tensor(rng.normal(size=sp.ndof) * scale, device="cuda")
    return sysm, U, U0


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("i", [0, 1], ids=["fluid", "solid"])
def test_residual_kernel(system, i):
    sysm, U, U0 = system
    b = sysm.assembler.blocks[i]
    n0 = build.LAUNCHES[f"{b.kernel.kind}_residual"]
    Rk = element.block_residual(b, U, U0, torch.zeros_like(U))
    Rp = element.residual_plain(b, U, U0, torch.zeros_like(U))
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"{b.kernel.kind}_residual"] == n0 + 1
    assert _rel(Rk, Rp) <= RTOL


@pytest.mark.parametrize("i", [0, 1], ids=["fluid", "solid"])
def test_jacobian_kernel(system, i):
    sysm, U, U0 = system
    b = sysm.assembler.blocks[i]
    Ak = element.block_jacobian(b, U, U0)
    Ap = element.jacobian_plain(b, U, U0)
    K = Ak.shape[0]
    per_block = (Ak - Ap).reshape(K, -1).norm(dim=1) / \
        Ap.reshape(K, -1).norm(dim=1)
    assert float(per_block.max()) <= RTOL


def test_measure_kernels(system):
    sysm, U, _ = system
    sp = sysm.space
    v = sp.split(U)[1].contiguous()
    pts, wq = tet_quadrature(2)
    args = (torch.as_tensor(sp.cell_dofs_p2.astype(np.int64), device="cuda"),
            torch.as_tensor(p2_tet(pts)[0], device="cuda"),
            torch.as_tensor(wq, device="cuda"))
    assert _rel(km.dg0_project_speed(v, *args),
                km.dg0_project_speed_plain(v, *args)) <= RTOL
    tabs = BoundaryMeasure(sp, 2).device_tables("cuda")
    fk = km.integrate_p2_dot_n(v, *tabs)
    fp = km.integrate_p2_dot_n_plain(v, *tabs)
    assert abs(float(fk - fp)) <= RTOL * abs(float(fp))
