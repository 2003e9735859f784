"""The CUDA kernels against their plain torch versions on the card, on the
tiny tube (the same checks chip_smoke.py makes at full size). Tolerances,
each with its reason:
- float64 outputs: 1e-12 relative (the atomics' order varies, nothing
  else);
- float32 element residuals (K1/K2 f32): as accurate as the plain
  version, ||R_kernel - R_plain|| <= 2 ||R_plain - R_f64|| + 1e-14
  ||R_f64||; both are float32 element work summed in float64, in other
  orders;
- float32 Jacobians: 2e-7 per block (both sides round the same float64
  value, equal to 1e-12, once: at most one float32 ulp apart);
- float32 element products (K4): 1e-5 relative (64-term float32 row sums
  in another order than torch's);
- K7 and K8: exact (max is exact, the products are the same two float32
  multiplies, and the banded sums run in plan order on both sides), at
  both local sizes (the cells' 64, the Robin facets' 36);
- K14 (Robin facet term): float64 residual and Jacobian 1e-12, the float32
  residual by the K1/K2 rule, the float32 Jacobian 2e-7 per block (both
  round the same float64 value once); K19c 1e-12;
- K6: no fixed bound. Its float32 c-term dot products run in another
  order than torch's, and the scans carry the difference through 2 nb - 1
  steps, amplified by the factors' norms. The kernel must be as accurate
  as the plain version: its distance to the same scans in float64 at most
  twice the plain version's (plus 1e-6).

Marked `cuda`: they need a CUDA device and nvcc, and skip without them.
The module imports no jax and builds its own mesh, so on a GPU machine
without jax it runs apart from conftest.py:
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest"""
import numpy as np
import pytest
import torch

from vasp_tpu_torch.fem import banded as fb
from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.fem.measures import BoundaryMeasure
from vasp_tpu_torch.fem.scaling import ruiz_scales
from vasp_tpu_torch.fem.quadrature import tet_quadrature
from vasp_tpu_torch.fem.shape import p2_tet
from vasp_tpu_torch.kernels import banded as kb
from vasp_tpu_torch.fem.measures import cell_tables, dg0_project_jacobian
from vasp_tpu_torch.kernels import build, element, facet
from vasp_tpu_torch.kernels import matvec as km4
from vasp_tpu_torch.kernels import scaling as ks
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
def test_residual_kernel_f32(system, i):
    sysm, U, U0 = system
    b = sysm.assembler.blocks[i]
    name = f"{b.kernel.kind}_residual_f32"
    n0 = build.LAUNCHES[name]
    f32 = torch.float32
    Rk = element.block_residual(b, U, U0, torch.zeros_like(U), f32)
    Rp = element.residual_plain(b, U, U0, torch.zeros_like(U), f32)
    R64 = element.residual_plain(b, U, U0, torch.zeros_like(U))
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 1
    assert Rk.dtype == torch.float64
    assert float((Rk - Rp).norm()) <= 2 * float((Rp - R64).norm()) \
        + 1e-14 * float(R64.norm())


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


@pytest.mark.parametrize("i", [0, 1], ids=["fluid", "solid"])
def test_jacobian_kernel_f32(system, i):
    sysm, U, U0 = system
    b = sysm.assembler.blocks[i]
    Ak = element.block_jacobian(b, U, U0, torch.float32)
    Ap = element.jacobian_plain(b, U, U0).to(torch.float32)
    assert Ak.dtype == torch.float32
    K = Ak.shape[0]
    per_block = (Ak - Ap).double().reshape(K, -1).norm(dim=1) / \
        Ap.double().reshape(K, -1).norm(dim=1)
    assert float(per_block.max()) <= 2e-7


@pytest.mark.parametrize("a_dt,x_dt,tol", [
    (torch.float32, torch.float64, 1e-5), (torch.float32, torch.float32, 1e-5),
    (torch.float64, torch.float64, 1e-12), (torch.float64, torch.float32, 1e-5),
], ids=["f32_f64", "f32_f32", "f64_f64", "f64_f32"])
def test_matvec_kernel(system, a_dt, x_dt, tol):
    sysm, U, U0 = system
    x = torch.as_tensor(np.random.default_rng(3).normal(size=U.shape[0]),
                        device="cuda").to(x_dt)
    for b in sysm.assembler.blocks:
        A = element.jacobian_plain(b, U, U0).to(a_dt)
        yk = km4.elem_matvec(A, b.dofs, x, torch.zeros_like(x))
        yp = km4.elem_matvec_plain(A, b.dofs, x, torch.zeros_like(x))
        assert yk.dtype == x_dt
        assert _rel(yk.double(), yp.double()) <= tol


@pytest.fixture(scope="module")
def banded_inputs(system):
    """f32 Jacobians, bc mask, scaled Jacobians, pattern and plan of the
    tiny tube with the cylinder's wall and inlet constraints."""
    sysm, _, _ = system
    sp = sysm.space
    Z = torch.zeros(sp.ndof, dtype=torch.float64, device="cuda")
    bcs = [DirichletBC(sp.field_dofs("d", sp.p2_dofs_on_facets(m)), 0.0)
           for m in (2, 3, 11)]
    bcs += [DirichletBC(sp.field_dofs("v", sp.p2_dofs_on_facets(m)), 0.0)
            for m in (2, 11)]
    bc = sysm.make_bcset(bcs)
    mask = bc.mask_on("cuda")
    asm = sysm.assembler
    jacs = asm.element_jacobians(Z, Z, dtype=torch.float32)
    dr, dc = ruiz_scales(asm.blocks, jacs, mask, asm.ndof, sweeps=4)
    jf = [ks.ruiz_scale_plain(A, b.dofs, dr, dc)
          for b, A in zip(asm.blocks, jacs)]
    block_dofs = [b.dofs.cpu().numpy() for b in asm.blocks]
    pat = fb.build_banded_pattern(block_dofs, asm.ndof)
    plans = fb.build_banded_assembly_plan(block_dofs, pat, bc.mask)
    diag = torch.as_tensor(fb.identity_diag_slots(pat, bc.mask))
    return sysm, jacs, mask, dr, dc, jf, pat, plans, diag


def test_ruiz_kernels(banded_inputs):
    sysm, jacs, mask, dr, dc, *_ = banded_inputs
    n = sysm.assembler.ndof
    for b, A in zip(sysm.assembler.blocks, jacs):
        out = [torch.zeros(n, dtype=torch.float32, device="cuda")
               for _ in range(4)]
        ks.ruiz_sweep_cuda(A, b.dofs, dr, dc, mask, out[0], out[1])
        ks.ruiz_sweep_plain(A, b.dofs, dr, dc, mask, out[2], out[3])
        assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])
        assert torch.equal(ks.ruiz_scale_cuda(A, b.dofs, dr, dc),
                           ks.ruiz_scale_plain(A, b.dofs, dr, dc))


def test_banded_kernels(banded_inputs):
    sysm, _, _, _, _, jf, pat, plans, diag = banded_inputs
    Ck, Dk, Bk = kb.assemble_cuda(jf, fb.plans_to_device(plans, "cuda"),
                                  pat.nb, pat.c, diag.cuda())
    Cp, Dp, Bp = kb.assemble_plain([A.cpu() for A in jf],
                                   fb.plans_to_device(plans, "cpu"),
                                   pat.nb, pat.c, diag)
    for k, p in ((Ck, Cp), (Dk, Dp), (Bk, Bp)):
        assert torch.equal(k.cpu(), p)
    Sinv, H, G, rel = fb.factorize_banded(Ck, Dk, Bk)
    assert np.isfinite(rel)
    perm = torch.as_tensor(pat.perm, device="cuda")
    r = torch.as_tensor(np.random.default_rng(4).normal(size=pat.ndof),
                        device="cuda")
    rb = torch.zeros(pat.npad, dtype=torch.float64, device="cuda")
    rb[:pat.ndof] = r[perm].float().double()
    x64 = kb.solve_blocks_plain(Sinv.double(), H.double(), G.double(),
                                rb.view(pat.nb, pat.c)).reshape(-1)
    ref = torch.empty_like(r)
    ref[perm] = x64[:pat.ndof]
    for dt in (torch.float64, torch.float32):
        xk = kb.apply_cuda(Sinv, H, G, perm, r.to(dt))
        xp = kb.apply_plain(Sinv, H, G, perm, r.to(dt))
        assert xk.dtype == dt
        assert _rel(xk.double(), ref) <= 2 * _rel(xp.double(), ref) + 1e-6


@pytest.fixture(scope="module")
def robin_system(system):
    """The tiny tube with the aneurysm's Robin term on marker 33, and a
    seeded state."""
    sysm, U, U0 = system
    cfg = dict(sysm.cfg, robin_bc=True, k_s=[1e5], c_s=[10], ds_s_id=[33])
    rsys = FSISystem(sysm.mesh, cfg)
    (fb_,) = [b for b in rsys.assembler.blocks if b.kernel.kind == "robin"]
    return rsys, fb_, U, U0


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_robin_residual_kernel(robin_system, f32):
    _, b, U, _ = robin_system
    dt = torch.float32 if f32 else None
    name = "robin_residual" + ("_f32" if f32 else "")
    n0 = build.LAUNCHES[name]
    Rk = facet.block_residual(b, U, None, torch.zeros_like(U), dt)
    Rp = facet.residual_plain(b, U, torch.zeros_like(U), dt)
    R64 = facet.residual_plain(b, U, torch.zeros_like(U))
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 1
    if f32:
        assert float((Rk - Rp).norm()) <= 2 * float((Rp - R64).norm()) \
            + 1e-14 * float(R64.norm())
    else:
        assert _rel(Rk, Rp) <= RTOL


@pytest.mark.parametrize("dt,tol", [(torch.float64, RTOL),
                                    (torch.float32, 2e-7)],
                         ids=["f64", "f32"])
def test_robin_jacobian_kernel(robin_system, dt, tol):
    _, b, U, _ = robin_system
    Ak = facet.block_jacobian(b, U, None, dt)
    Ap = facet.jacobian_plain(b, U).to(dt)
    assert Ak.dtype == dt and Ak.shape == Ap.shape
    K = Ak.shape[0]
    per_block = (Ak - Ap).double().reshape(K, -1).norm(dim=1) / \
        Ap.double().reshape(K, -1).norm(dim=1)
    assert float(per_block.max()) <= tol


@pytest.mark.parametrize("a_dt,x_dt,tol", [
    (torch.float32, torch.float64, 1e-5), (torch.float32, torch.float32, 1e-5),
    (torch.float64, torch.float64, 1e-12), (torch.float64, torch.float32, 1e-5),
], ids=["f32_f64", "f32_f32", "f64_f64", "f64_f32"])
def test_matvec_kernel_facet(robin_system, a_dt, x_dt, tol):
    _, b, U, _ = robin_system
    x = torch.as_tensor(np.random.default_rng(5).normal(size=U.shape[0]),
                        device="cuda").to(x_dt)
    A = facet.jacobian_plain(b, U).to(a_dt)
    yk = km4.elem_matvec(A, b.dofs, x, torch.zeros_like(x))
    yp = km4.elem_matvec_plain(A, b.dofs, x, torch.zeros_like(x))
    assert _rel(yk.double(), yp.double()) <= tol


def test_ruiz_kernels_facet(robin_system):
    rsys, b, U, _ = robin_system
    n = rsys.assembler.ndof
    A = facet.jacobian_plain(b, U).float()
    rng = np.random.default_rng(6)
    dr, dc = (torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                              device="cuda") for _ in range(2))
    mask = torch.as_tensor(rng.random(n) < 0.1, device="cuda")
    out = [torch.zeros(n, dtype=torch.float32, device="cuda")
           for _ in range(4)]
    ks.ruiz_sweep_cuda(A, b.dofs, dr, dc, mask, out[0], out[1])
    ks.ruiz_sweep_plain(A, b.dofs, dr, dc, mask, out[2], out[3])
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])
    assert torch.equal(ks.ruiz_scale_cuda(A, b.dofs, dr, dc),
                       ks.ruiz_scale_plain(A, b.dofs, dr, dc))


def test_dg0_project_jacobian_kernel(system):
    sysm, _, _ = system
    sp = sysm.space
    d = torch.as_tensor(1e-2 * sp.mesh.hmin * np.random.default_rng(7).normal(
        size=(sp.n_p2, 3)), device="cuda")
    n0 = build.LAUNCHES["dg0_project_jacobian"]
    jk = dg0_project_jacobian(sp, d)
    torch.cuda.synchronize()
    assert build.LAUNCHES["dg0_project_jacobian"] == n0 + 1
    dofs, Jinv, _, dN2, wq = cell_tables(sp, d.device, 2)
    jp = km.dg0_project_jacobian_plain(d, dofs, Jinv, dN2, wq)
    assert _rel(jk, jp) <= RTOL
