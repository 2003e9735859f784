"""The CUDA kernels against their plain torch versions on the card, on the
tiny tube (the same checks chip_smoke.py makes at full size). Tolerances,
each with its reason:
- float64 outputs: 1e-12 relative (the atomics' order varies, nothing
  else);
- the Mooney-Rivlin solid (K2/K3 MR, at strains ~1e-2): the same rules
  as the St.Venant-Kirchhoff one;
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
- K20a (WSS load), K20b (stress/strain, SVK and MR, and the eigenvalue
  entry) and K20c (spectral power): float64, 1e-12 relative to each
  output's scale; the eigenvalues 1e-10 of their scale (acos near
  r = +-1 turns a rounding change of r into ~1e-8 of p);
- K16 (biharmonic lifting correction): float64 1e-12; float32 by the
  K1/K2 f32 rule, against the float64 correction of the same input;
- the fluid's elastic and no-lifting instances, p_stab and gravity: the
  rules of K1/K2/K3 above; K3 on every instance under a row mask too;
- K1, K2, K3 and K13 at quadrature degree 10 (216 points, every table in
  device memory) and at degree 8 with float32 tables in device memory: the
  rules above (K13's below);
- K6: no fixed bound. Its float32 c-term dot products run in another
  order than torch's, and the scans carry the difference through 2 nb - 1
  steps, amplified by the factors' norms. The kernel must be as accurate
  as the plain version: its distance to the same scans in float64 at most
  twice the plain version's (plus 1e-6). The same rule for K6's hybrid
  and bf16 storage instances and for K12 (the folded apply of the
  low-memory layouts), against the float64 scans on the same widened
  factors;
- K18 (the RAS apply): float64 1e-12; with float32 inverses or a float32
  vector 1e-5 (1e-6 when only r is float32): m-term float32 sums in
  another order than torch's; K7's float64 sweep and scale: exact;
- K22 (the element-block Schwarz build and apply): the build exact (the
  same masks and one unfused product and sum on the diagonal), the
  multiplicity exact, the apply (with its divide) 1e-12 relative;
- K17 (the node blocks): extract and apply 1e-12 relative (atomics'
  order), the closed-form inverse 1e-12 of each node's largest entry
  (unfused float64 operations against torch's on blocks of cond ~10);
- K21a (one rank's stages of the sharded applies, every storage instance,
  and the chain's carry update): the two-span composition equal to K6's
  solve (the same GEMV instance on the same inputs in the same order), and
  K6's rule against the float64 scans; each single stage, with and
  without its carry, at its distance to the float64 stage at most
  CARRY_STAGE_RATIO times the plain version's plus 1e-6 (one stage
  averages less of the order's rounding than the whole solve, so K6's 2
  is too tight for it: tests/diag_carry_stages.py's 480 readings on an
  H100, two tubes' factors in three instances, five stages, two spans,
  eight seeds, need at most 2.29 under the 1e-6 floor, the largest bare
  ratio 5.16; 4 leaves 1.75x over the 2.29);
- K21f-a (the SPIKE refinement's residual r - T x): K6's rule against
  the same residual in float64 on the same float32 inputs (every product
  exact and each row summed in double on the card, float32 matmuls in the
  plain version);
- the two-rank SPIKE apply (K21a's stages, carry updates and K21f-a,
  refine 0 and 2): its probe, ||T M b - b|| / ||b||, at most twice the
  same apply's through the plain versions plus 1e-6 (the SPIKE apply is
  not backward stable on the tube's partitions, vasp_tpu
  banded_shard.py:575-585, so the two float32 results part where the
  local inverses amplify rounding; the probe is the quality that the
  preconditioner is held to);
- K13 (the Taylor delta, both forms, every instance and the facet route):
  the float32 rule of K1/K2 in the max norm, max|D_kernel - D_plain| <=
  2 max|D_plain - D_f64| + 1e-12 max|D_f64|, with D_f64 the same series
  in float64: both are float32 series summed in float64, in other orders
  (the kernel folds each contribution's weighted coefficients into one
  float as it adds it, the plain version sums each order apart).

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
CARRY_STAGE_RATIO = 4.0  # K21a's single stages (module docstring)


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


# the K6 storage instances and K12 (Sinv's storage), factored as the
# layouts store them
LOWMEM_INSTANCES = ("hybrid", "bf16", "lowmem_bf16", "lowmem_f32")


def _layout_factors(layout, Ck, Dk, Bk):
    """(apply, factors) of a layout from C/D/B: the full bf16 factors, the
    hybrid ones (f32 Sinv, bf16 H/G), or Sinv with bf16 C/B."""
    bf = torch.bfloat16
    if layout == "bf16":
        return kb.apply, fb.factorize_banded(Ck, Dk, Bk, bf)[:3]
    if layout == "hybrid":
        Sinv = fb.schur_scan(Ck, Dk, Bk)
        return kb.apply, (Sinv, fb.sinv_times(Sinv, Ck, bf),
                          fb.sinv_times(Sinv, Bk, bf))
    Sinv = fb.schur_scan(Ck, Dk, Bk, bf if layout == "lowmem_bf16"
                         else torch.float32)
    return kb.apply_lowmem, (Sinv, Ck.to(bf), Bk.to(bf))


@pytest.mark.parametrize("layout", LOWMEM_INSTANCES)
def test_banded_storage_kernels(banded_inputs, layout):
    """K6 in its hybrid and bf16 instances and K12 with bf16 and f32 Sinv:
    as accurate as the plain version (K6's rule), each counted under its
    instance."""
    sysm, _, _, _, _, jf, pat, plans, diag = banded_inputs
    Ck, Dk, Bk = kb.assemble_cuda(jf, fb.plans_to_device(plans, "cuda"),
                                  pat.nb, pat.c, diag.cuda())
    apply, F = _layout_factors(layout, Ck, Dk, Bk)
    perm = torch.as_tensor(pat.perm, device="cuda")
    r = torch.as_tensor(np.random.default_rng(5).normal(size=pat.ndof),
                        device="cuda")
    rb = torch.zeros(pat.npad, dtype=torch.float64, device="cuda")
    rb[:pat.ndof] = r[perm].float().double()
    solve = (kb.solve_blocks_plain if apply is kb.apply
             else kb.solve_blocks_lowmem_plain)
    x64 = solve(*(M.double() for M in F), rb.view(pat.nb, pat.c))
    ref = torch.empty_like(r)
    ref[perm] = x64.reshape(-1)[:pat.ndof]
    cuda = kb.apply_cuda if apply is kb.apply else kb.apply_lowmem_cuda
    plain = kb.apply_plain if apply is kb.apply else kb.apply_lowmem_plain
    instances = (kb.K6_INSTANCES if apply is kb.apply
                 else kb.K12_INSTANCES)
    name = instances[F[0].dtype, F[1].dtype]
    for dt in (torch.float64, torch.float32):
        build.reset_launch_counts()
        xk = cuda(*F, perm, r.to(dt))
        assert build.LAUNCHES[name] == 1
        xp = plain(*F, perm, r.to(dt))
        assert xk.dtype == dt
        assert _rel(xk.double(), ref) <= 2 * _rel(xp.double(), ref) + 1e-6


@pytest.mark.parametrize("storage", ["f32", "hybrid", "bf16"])
def test_carry_kernels(banded_inputs, storage):
    """K21a, one rank's stages of the sharded applies, on the tiny tube's
    factors in each storage instance: the two-span Thomas composition (the
    first span's forward carry handed to the second, the second's
    backward carry back; every stage with and without a carry) is K6's
    solve to the bit (the same gemv_kernel instance on the same inputs in
    the same order) and, against its plain composition, within K6's rule
    of the float64 scans; the chain's carry update a + T v by the same
    rule; one count per launch."""
    sysm, _, _, _, _, jf, pat, plans, diag = banded_inputs
    Ck, Dk, Bk = kb.assemble_cuda(jf, fb.plans_to_device(plans, "cuda"),
                                  pat.nb, pat.c, diag.cuda())
    bf = torch.bfloat16
    Sinv, H, G, _ = fb.factorize_banded(Ck, Dk, Bk,
                                        bf if storage == "bf16"
                                        else torch.float32)
    if storage == "hybrid":
        H, G = H.to(bf), G.to(bf)
    F = (Sinv, H, G)
    name = kb.K21A_INSTANCES[Sinv.dtype, H.dtype]
    rng = np.random.default_rng(6)
    a = torch.as_tensor(rng.normal(size=(pat.nb, pat.c)), dtype=torch.float32,
                        device="cuda")
    m = pat.nb // 2
    halves = ((Sinv[:m], H[:m], G[:m]), (Sinv[m:], H[m:], G[m:]))

    def two_spans(stage):
        t = [stage(*Fi, "times", ai) for Fi, ai in zip(halves,
                                                        (a[:m], a[m:]))]
        w1 = stage(*halves[0], "forward", t[0])
        w2 = stage(*halves[1], "forward", t[1], w1[-1])
        x2 = stage(*halves[1], "backward", w2)
        x1 = stage(*halves[0], "backward", w1, x2[0])
        return torch.cat([x1, x2])

    def check(k, p, ref):
        assert k.dtype == torch.float32
        assert _rel(k.double(), ref) <= 2 * _rel(p.double(), ref) + 1e-6

    build.reset_launch_counts()
    xk = two_spans(kb.carry_stage_cuda)
    assert build.LAUNCHES[name] == 6
    assert torch.equal(xk, kb.solve_blocks_cuda(Sinv, H, G, a))
    check(xk, two_spans(kb.carry_stage_plain),
          kb.solve_blocks_plain(*(M.double() for M in F), a.double()))
    T = H[0].float()
    carry = xk[m]
    build.reset_launch_counts()
    uk = kb.carry_update_cuda(T, carry, a[0])
    assert build.LAUNCHES["banded_carry_update"] == 1
    check(uk, kb.carry_update_plain(T, carry, a[0]),
          a[0].double() + T.double() @ carry.double())


@pytest.mark.parametrize("storage", ["f32", "hybrid", "bf16"])
def test_carry_stages(banded_inputs, storage):
    """K21a's single stages on each span of the tiny tube's factors in each
    storage instance, at three seeded right-hand sides: t = Sinv r, and
    the forward and backward scans each with and without the incoming
    carry, the kernel's distance to the float64 stage on the same float32
    inputs at most CARRY_STAGE_RATIO times the plain version's plus
    1e-6."""
    sysm, _, _, _, _, jf, pat, plans, diag = banded_inputs
    Ck, Dk, Bk = kb.assemble_cuda(jf, fb.plans_to_device(plans, "cuda"),
                                  pat.nb, pat.c, diag.cuda())
    bf = torch.bfloat16
    Sinv, H, G, _ = fb.factorize_banded(Ck, Dk, Bk,
                                        bf if storage == "bf16"
                                        else torch.float32)
    if storage == "hybrid":
        H, G = H.to(bf), G.to(bf)
    m = pat.nb // 2
    halves = ((Sinv[:m], H[:m], G[:m]), (Sinv[m:], H[m:], G[m:]))
    for seed in (6, 7, 8):
        a = torch.as_tensor(np.random.default_rng(seed).normal(
            size=(pat.nb, pat.c)), dtype=torch.float32, device="cuda")
        t = [kb.carry_stage_plain(*F, "times", ai)
             for F, ai in zip(halves, (a[:m], a[m:]))]
        w0 = kb.carry_stage_plain(*halves[0], "forward", t[0])
        w1 = kb.carry_stage_plain(*halves[1], "forward", t[1], w0[-1])
        x_in = kb.carry_stage_plain(*halves[1], "backward", w1)[0]
        for k, F in enumerate(halves):
            for stage, inp, carry in (
                    ("times", (a[:m], a[m:])[k], None),
                    ("forward", t[k], None), ("forward", t[k], w0[-1]),
                    ("backward", (w0, w1)[k], None),
                    ("backward", (w0, w1)[k], x_in)):
                ref = kb.carry_stage_plain(
                    *F, stage, inp.double(),
                    None if carry is None else carry.double())
                dk = _rel(kb.carry_stage_cuda(*F, stage, inp,
                                              carry).double(), ref)
                dp = _rel(kb.carry_stage_plain(*F, stage, inp,
                                               carry).double(), ref)
                assert dk <= CARRY_STAGE_RATIO * dp + 1e-6, (
                    seed, k, stage, carry is not None, dk, dp)


def _spans(banded_inputs):
    """The tiny tube's C/D/B (K8) split into two ranks' spans."""
    sysm, _, _, _, _, jf, pat, plans, diag = banded_inputs
    Ck, Dk, Bk = kb.assemble_cuda(jf, fb.plans_to_device(plans, "cuda"),
                                  pat.nb, pat.c, diag.cuda())
    m = pat.nb // 2
    return [tuple(M[sl] for M in (Ck, Dk, Bk))
            for sl in (slice(0, m), slice(m, pat.nb))], pat


def test_tri_residual_kernel(banded_inputs):
    """K21f-a on each span of the tiny tube's C/D/B, with the neighbour's
    boundary row where the span has one: K6's rule against the float64
    residual; one count per launch."""
    spans, pat = _spans(banded_inputs)
    m, c = spans[0][1].shape[:2]
    rng = np.random.default_rng(9)
    x, r = (torch.as_tensor(rng.normal(size=(2, m, c)), dtype=torch.float32,
                            device="cuda") for _ in range(2))
    build.reset_launch_counts()
    for k, (C, D, B) in enumerate(spans):
        nbr = (None, x[1][0]) if k == 0 else (x[0][-1], None)
        yk = kb.tri_residual_cuda(C, D, B, x[k], r[k], *nbr)
        yp = kb.tri_residual_plain(C, D, B, x[k], r[k], *nbr)
        ref = kb.tri_residual_plain(
            C, D, B, x[k].double(), r[k].double(),
            *(None if v is None else v.double() for v in nbr))
        assert yk.dtype == torch.float32
        assert _rel(yk.double(), ref) <= 2 * _rel(yp.double(), ref) + 1e-6
    assert build.LAUNCHES["banded_tri_residual"] == 2


@pytest.mark.parametrize("refine", [0, 2])
def test_spike_apply_kernels(banded_inputs, refine):
    """The two-rank SPIKE apply (the ranks as threads of this process) on
    the tiny tube's C/D/B: through the kernels its probe at most twice the
    probe through the plain versions plus 1e-6, with K21a's stages, its
    carry updates and (refine > 0) K21f-a launched."""
    from _torch_dist import plain_banded, thread_ranks
    from vasp_tpu_torch.parallel import banded_shard as bs

    spans, pat = _spans(banded_inputs)
    m, c = pat.nb // 2, pat.c
    plan = bs.ShardPlan(c=c, nb_loc=m, span=m * c, n=2, ndof=pat.ndof,
                        npad=pat.nb * c, perm=None, iperm=None)

    factors = thread_ranks(2, lambda comm: bs.sharded_factorize_spike(
        *spans[comm.rank], comm, refine=refine))

    def probe(comm):
        return bs.sharded_probe_rel(
            *spans[comm.rank], factors[comm.rank],
            bs.make_sharded_spike_apply(plan, comm, refine), comm)

    build.reset_launch_counts()
    pk = thread_ranks(2, probe)
    launches = dict(build.LAUNCHES)
    with plain_banded():
        pp = thread_ranks(2, probe)
    assert pk[0] == pk[1] and pp[0] == pp[1]
    assert pk[0] <= 2 * pp[0] + 1e-6, (pk, pp)
    assert launches["banded_carry"] > 0
    assert launches["banded_carry_update"] > 0
    assert (launches["banded_tri_residual"] > 0) == (refine > 0)


def test_ruiz_sweep_kernel_f64(banded_inputs):
    """K7's float64 sweep (the RAS rebuild's): exact, as the float32 one."""
    sysm, jacs, mask, dr, dc, *_ = banded_inputs
    n = sysm.assembler.ndof
    for b, A in zip(sysm.assembler.blocks, jacs):
        A, dr64, dc64 = A.double(), dr.double(), dc.double()
        out = [torch.zeros(n, dtype=torch.float64, device="cuda")
               for _ in range(4)]
        ks.ruiz_sweep_cuda(A, b.dofs, dr64, dc64, mask, out[0], out[1])
        ks.ruiz_sweep_plain(A, b.dofs, dr64, dc64, mask, out[2], out[3])
        assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])


def test_ruiz_scale_kernel_f64(banded_inputs):
    """K7's float64 scale (make_step_fn's node blocks): exact, the same two
    float64 multiplies."""
    sysm, jacs, mask, dr, dc, *_ = banded_inputs
    for b, A in zip(sysm.assembler.blocks, jacs):
        A, dr64, dc64 = A.double(), dr.double(), dc.double()
        n0 = build.LAUNCHES["ruiz_scale_f64"]
        out = ks.ruiz_scale_cuda(A, b.dofs, dr64, dc64)
        assert build.LAUNCHES["ruiz_scale_f64"] == n0 + 1
        assert torch.equal(out, ks.ruiz_scale_plain(A, b.dofs, dr64, dc64))


@pytest.mark.parametrize("p_dt,r_dt,tol", [
    (torch.float64, torch.float64, RTOL), (torch.float64, torch.float32, 1e-6),
    (torch.float32, torch.float64, 1e-5), (torch.float32, torch.float32, 1e-5),
], ids=["f64_f64", "f64_f32", "f32_f64", "f32_f32"])
def test_ras_apply_kernel(p_dt, r_dt, tol):
    """K18 against its plain version on a seeded pattern (every dof owned
    once) and seeded inverses: float64 1e-12; float32 sums (the inverses'
    or r's type) 1e-5 and 1e-6, m-term sums in another order."""
    from vasp_tpu_torch.kernels import ras as kr

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    ndof, S = 5000, 7
    owner = rng.integers(0, S, ndof)
    ext = [np.sort(np.concatenate([
        np.nonzero(owner == s)[0],
        rng.choice(np.nonzero(owner != s)[0], 300, replace=False)]))
        for s in range(S)]
    m = max(len(e) for e in ext)
    idx = np.full((S, m), ndof, np.int64)
    own = np.zeros((S, m), bool)
    for s, e in enumerate(ext):
        idx[s, :len(e)] = e
        own[s, :len(e)] = owner[e] == s
    assert np.all(np.bincount(idx[own], minlength=ndof) == 1)
    idx_t = torch.as_tensor(idx, device="cuda")
    own_t = torch.as_tensor(own, device="cuda")
    pinv = torch.as_tensor(rng.normal(size=(S, m, m)), device="cuda").to(p_dt)
    r = torch.as_tensor(rng.normal(size=ndof), device="cuda").to(r_dt)
    build.reset_launch_counts()
    yk = kr.apply_cuda(pinv, idx_t, own_t, r)
    assert build.LAUNCHES[kr.counter(pinv)] == 1
    yp = kr.apply_plain(pinv, idx_t, own_t, r)
    assert yk.dtype == r_dt
    assert _rel(yk.double(), yp.double()) <= tol


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


@pytest.fixture(scope="module")
def mr_system(system):
    """The tiny tube with a Mooney-Rivlin wall (predeform's constants, C10
    made nonzero so that every term of S counts) and a displacement whose
    strains are ~1e-2."""
    sysm, U, U0 = system
    props = dict(material_model="MooneyRivlin", rho_s=1e3, mu_s=3.45e5,
                 lambda_s=3.1e6, C01=2e4, C10=5e4, C11=1.8e6, dx_s_id=2)
    mr = FSISystem(sysm.mesh, dict(sysm.cfg, solid_properties=props))
    sp = mr.space
    rng = np.random.default_rng(31)
    d = torch.as_tensor(1e-2 * sysm.mesh.hmin * rng.normal(size=3 * sp.n_p2),
                        device="cuda")
    U, U0 = U.clone(), U0.clone()
    U[:3 * sp.n_p2] = d
    U0[:3 * sp.n_p2] = 0.5 * d
    return mr.assembler.blocks[1], U, U0


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_mr_residual_kernel(mr_system, f32):
    b, U, U0 = mr_system
    dtype = torch.float32 if f32 else None
    name = "solid_residual_mr" + ("_f32" if f32 else "")
    n0 = build.LAUNCHES[name]
    Rk = element.block_residual(b, U, U0, torch.zeros_like(U), dtype)
    Rp = element.residual_plain(b, U, U0, torch.zeros_like(U), dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 1
    if not f32:
        assert _rel(Rk, Rp) <= RTOL
        return
    R64 = element.residual_plain(b, U, U0, torch.zeros_like(U))
    assert float((Rk - Rp).norm()) <= 2 * float((Rp - R64).norm()) \
        + 1e-14 * float(R64.norm())


@pytest.mark.parametrize("dt,tol", [(torch.float64, RTOL),
                                    (torch.float32, 2e-7)],
                         ids=["f64", "f32"])
def test_mr_jacobian_kernel(mr_system, dt, tol):
    b, U, U0 = mr_system
    name = "solid_jacobian_mr" + ("_f32" if dt == torch.float32 else "")
    n0 = build.LAUNCHES[name]
    Ak = element.block_jacobian(b, U, U0, dt)
    Ap = element.jacobian_plain(b, U, U0).to(dt)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 1
    K = Ak.shape[0]
    per_block = (Ak - Ap).double().reshape(K, -1).norm(dim=1) / \
        Ap.double().reshape(K, -1).norm(dim=1)
    assert float(per_block.max()) <= tol


# ------------------------------------------------------- postprocessing --
def _close_to_scale(a, b, rel):
    assert float((a - b).abs().max()) <= rel * float(b.abs().max()), (
        float((a - b).abs().max()), float(b.abs().max()))


@pytest.fixture(scope="module")
def postproc_inputs(system):
    """The tiny tube's fluid-boundary and solid-vertex tables on the card,
    and seeded 3-step velocity and displacement series (strains ~1e-2)."""
    from vasp_tpu_torch.postprocessing.fields.hemodynamics import (
        FluidBoundaryTables,
    )
    from vasp_tpu_torch.postprocessing.fields.stress_strain import (
        SolidVertexTables,
    )

    sysm = system[0]
    mesh, space = sysm.space.mesh, sysm.space
    rng = np.random.default_rng(31)
    u = torch.as_tensor(rng.normal(size=(3, space.n_p2, 3)), device="cuda")
    d = torch.as_tensor(rng.normal(size=(3, space.n_p2, 3)) * 1e-6,
                        device="cuda")
    wss = FluidBoundaryTables(mesh)
    svk = {"dx_s_id": 2, "material_model": "StVenantKirchoff",
           "mu_s": 3.45e5, "lambda_s": 3.1e6}
    mr = dict(svk, material_model="MooneyRivlin", C01=0.003e6, C10=0.0,
              C11=0.538e6)
    solids = {name: SolidVertexTables(mesh, space, [props])
              for name, props in (("svk", svk), ("mr", mr))}
    return u, d, wss, space, solids


def test_wss_load_kernel(postproc_inputs):
    from vasp_tpu_torch.kernels import postproc

    u, _, wss, space, _ = postproc_inputs
    tables = wss.device_tables(space.cell_dofs_p2, u.device)
    nb = len(wss.bnodes)
    out = postproc.wss_load_cuda(u, *tables, nb, 3.5e-3)
    torch.cuda.synchronize()
    _close_to_scale(out, postproc.wss_load_plain(u, *tables, nb, 3.5e-3),
                    RTOL)


@pytest.mark.parametrize("walls", ["svk", "mr"])
def test_stress_strain_kernel(postproc_inputs, walls):
    from vasp_tpu_torch.kernels import postproc

    _, d, _, _, solids = postproc_inputs
    tab = solids[walls]
    args = (d, *tab.device_tables(d.device), tab.segments)
    build.reset_launch_counts()
    got = postproc.stress_strain_cuda(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"stress_strain_{walls}"] == 1
    want = postproc.stress_strain_plain(*args)
    for g, w, rel in zip(got, want, (RTOL, RTOL, 1e-10, 1e-10)):
        _close_to_scale(g, w, rel)


def _compact(dofs):
    """dofs with the nodes renumbered 0.. in order of first use, and their
    count: a few cells' tables over a series of only their nodes."""
    nodes, inv = np.unique(dofs.cpu().numpy(), return_inverse=True)
    return torch.as_tensor(inv.reshape(dofs.shape), device=dofs.device), \
        len(nodes)


def test_post_kernels_past_the_grid_limit(postproc_inputs):
    """K20a and K20b at T = 70,000 steps, more than the 65,535 blocks of
    the grid's second axis, on 4 facets / 2 cells of the tiny tube: every
    step, the last ones too, agrees with the plain version (1e-12; the
    eigenvalues 1e-10)."""
    from vasp_tpu_torch.kernels import postproc

    _, _, wss, space, solids = postproc_inputs
    T = 70_000
    rng = np.random.default_rng(34)
    dofs, G2, normals, wq, N1f, area2, fb = wss.device_tables(
        space.cell_dofs_p2, "cuda")
    dofs, n = _compact(dofs[:4])
    fb, nb = _compact(fb[:4])
    u = torch.as_tensor(rng.normal(size=(T, n, 3)), device="cuda")
    args = (u, dofs, G2[:4].contiguous(), normals[:4].contiguous(), wq, N1f,
            area2[:4].contiguous(), fb, nb, 3.5e-3)
    out = postproc.wss_load_cuda(*args)
    torch.cuda.synchronize()
    _close_to_scale(out, postproc.wss_load_plain(*args), RTOL)
    svk = solids["svk"]
    sdofs, G = svk.device_tables("cuda")
    sdofs, n = _compact(sdofs[:2])
    d = torch.as_tensor(rng.normal(size=(T, n, 3)) * 1e-6, device="cuda")
    args = (d, sdofs, G[:2].contiguous(), [(0, 2, svk.segments[0][2])])
    got = postproc.stress_strain_cuda(*args)
    torch.cuda.synchronize()
    want = postproc.stress_strain_plain(*args)
    for g, w, rel in zip(got, want, (RTOL, RTOL, 1e-10, 1e-10)):
        _close_to_scale(g, w, rel)
        _close_to_scale(g[-1], w[-1], rel)


def test_max_eig_kernel(postproc_inputs):
    from vasp_tpu_torch.fem.kinematics import get_eig
    from vasp_tpu_torch.kernels import postproc

    rng = np.random.default_rng(32)
    A = rng.normal(size=(4096, 3, 3))
    A = torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), device="cuda")
    out = postproc.max_eig_cuda(A)
    torch.cuda.synchronize()
    _close_to_scale(out, get_eig(A), 1e-10)


@pytest.mark.parametrize("even", [True, False])
def test_spectral_power_kernel(even):
    from vasp_tpu_torch.kernels import postproc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(33)
    x = torch.as_tensor(rng.normal(size=(300, 5, 64 if even else 63)),
                        device="cuda")
    X = torch.fft.rfft(x, dim=2)
    got = postproc.spectral_power_cuda(X, 0.37, even)
    torch.cuda.synchronize()
    _close_to_scale(got, postproc.spectral_power_plain(X, 0.37, even), RTOL)


# ------------------------------------------- lifting and body force --
# the element kernels' lifting and body-force options: each variant is
# the tiny tube's fluid or solid block with another kernel
LIFT_VARIANTS = {
    "elastic": (0, dict(lift="elastic")),
    "elastic_p_stab": (0, dict(lift="elastic", p_stab=0.1)),
    "no_extrapolation": (0, dict(lift="no_extrapolation")),
    "laplace_p_stab": (0, dict(p_stab=0.1)),
    "biharmonic_volume": (0, dict(lift="biharmonic", lift_sub="volume",
                                  lift_coeff=2.3)),
    "gravity": (1, dict(gravity=[0.0, 0.0, -9.81])),
    "gravity_mr": (1, dict(gravity=[0.0, 0.0, -9.81])),
}


def _variant_block(sysm, mr_block, name):
    import dataclasses

    from vasp_tpu_torch.fem import forms

    i, kw = LIFT_VARIANTS[name]
    b = sysm.assembler.blocks[i]
    k = b.kernel
    if i == 0:
        kern = forms.make_fluid_kernel(
            k.rho_f, k.mu_f, k.dt, k.theta, quad_degree=k.quad_degree,
            **(dict(lift_sub=k.lift_sub, lift_coeff=k.lift_coeff) | kw))
    else:
        if name == "gravity_mr":
            b, k = mr_block, mr_block.kernel
        kern = forms.make_solid_kernel(k.props, k.dt, k.theta,
                                       quad_degree=k.quad_degree, **kw)
    return dataclasses.replace(b, kernel=kern)


@pytest.mark.parametrize("name", sorted(LIFT_VARIANTS))
def test_lifting_and_body_force_kernels(system, mr_system, name):
    """K1/K2 (f64 and f32) and K3 (f64 and f32) with a lifting or
    body-force option against their plain versions, counted under the
    block's own names (the _elastic and _nolift instances; p_stab and
    gravity are parameters of the existing ones)."""
    _, U, U0 = system
    mr_b, Umr, U0mr = mr_system
    if name == "gravity_mr":
        U, U0 = Umr, U0mr
    b = _variant_block(system[0], mr_b, name)
    names = [element.counter_name(b, op, f32) for op in ("residual",
                                                         "jacobian")
             for f32 in (False, True)]
    n0 = [build.LAUNCHES[n] for n in names]
    Rk = element.block_residual(b, U, U0, torch.zeros_like(U))
    Rp = element.residual_plain(b, U, U0, torch.zeros_like(U))
    assert _rel(Rk, Rp) <= RTOL
    Rk32 = element.block_residual(b, U, U0, torch.zeros_like(U),
                                  torch.float32)
    Rp32 = element.residual_plain(b, U, U0, torch.zeros_like(U),
                                  torch.float32)
    assert float((Rk32 - Rp32).norm()) <= 2 * float((Rp32 - Rp).norm()) \
        + 1e-14 * float(Rp.norm())
    Ap = element.jacobian_plain(b, U, U0)
    K = Ap.shape[0]
    for dt, tol in ((torch.float64, RTOL), (torch.float32, 2e-7)):
        Ak = element.block_jacobian(b, U, U0, dt)
        per_block = (Ak - Ap.to(dt)).double().reshape(K, -1).norm(dim=1) / \
            Ap.to(dt).double().reshape(K, -1).norm(dim=1)
        assert float(per_block.max()) <= tol
    torch.cuda.synchronize()
    assert [build.LAUNCHES[n] for n in names] == [x + 1 for x in n0]


@pytest.mark.parametrize("sub_type", ["bc1", "bc2"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_lift_correction_kernel(system, sub_type, dtype):
    """K16 against its plain version on the tiny tube's biharmonic tables:
    float64 1e-12; float32 as accurate as the plain version, i.e. its
    distance to the float64 correction of the same input at most twice the
    plain version's plus 1e-14 of it (both sum the two L applications in
    float32, in other orders)."""
    from vasp_tpu_torch.kernels import lifting

    sysm, U, _ = system
    bih = FSISystem(sysm.mesh, dict(sysm.cfg, extrapolation="biharmonic",
                                    extrapolation_sub_type=sub_type))
    x = U.to(dtype)
    name = lifting.counter_name(x)
    n0 = build.LAUNCHES[name]
    ck = lifting.correction_apply(bih.lift, x)
    cp = lifting.correction_plain(bih.lift, x)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 1
    assert ck.dtype == dtype and ck.shape == x.shape
    n_d = 3 * bih.space.n_p2
    assert not ck[n_d:].any()
    if dtype == torch.float64:
        assert _rel(ck, cp) <= RTOL
        return
    c64 = lifting.correction_plain(bih.lift, x.double())
    assert float((ck.double() - cp.double()).norm()) <= \
        2 * float((cp.double() - c64).norm()) + 1e-14 * float(c64.norm())


@pytest.mark.parametrize("n", [64, 36], ids=["cells", "facets"])
def test_schwarz_kernels(system, robin_system, n):
    """K22 at the cells' 64 and the Robin facets' 36 local dofs, on the
    element Jacobians of the tube and a seeded bc mask."""
    from vasp_tpu_torch.kernels import schwarz as kz

    sysm, U, U0 = system
    if n == 64:
        b = sysm.assembler.blocks[0]
        A = element.block_jacobian(b, U, U0)
    else:
        _, b, U, _ = robin_system
        A = facet.jacobian_plain(b, U)
    ndof = U.shape[0]
    rng = np.random.default_rng(8)
    mask = torch.as_tensor(rng.random(ndof) < 0.05, device="cuda")
    mk = torch.zeros(ndof, dtype=torch.float64, device="cuda")
    mp = torch.zeros_like(mk)
    build.reset_launch_counts()
    Ak = kz.build_cuda(A, b.dofs, mask, 1e-12, mk)
    assert build.LAUNCHES[km4.launch_name("schwarz_build", n)] == 1
    Ap = kz.build_plain(A, b.dofs, mask, 1e-12, mp)
    assert torch.equal(Ak, Ap) and torch.equal(mk, mp)
    P = torch.linalg.inv(Ap).contiguous()
    r = torch.as_tensor(rng.normal(size=ndof), device="cuda")
    mult = torch.clamp(mp, min=1.0)
    yk = kz.apply_cuda([P], [b.dofs], r, mult)
    assert build.LAUNCHES[km4.launch_name("schwarz_apply", n)] == 1
    assert build.LAUNCHES["schwarz_divide"] == 1
    assert _rel(yk, kz.apply_plain([P], [b.dofs], r, mult)) <= RTOL
    assert _rel(kz.apply_cuda([P], [b.dofs], r),
                kz.apply_plain([P], [b.dofs], r)) <= RTOL


def test_node_block_kernels(system):
    """K17 on the tube's Ruiz-scaled float64 cell Jacobians and a seeded
    bc mask."""
    from vasp_tpu_torch.fem.scaling import scale_element_jacobians
    from vasp_tpu_torch.kernels import nodeblock as knb

    sysm, U, U0 = system
    sp, blocks = sysm.space, sysm.assembler.blocks
    rng = np.random.default_rng(9)
    mask = torch.as_tensor(rng.random(sp.ndof) < 0.05, device="cuda")
    jacs = [element.block_jacobian(b, U, U0) for b in blocks]
    dr, dc = ruiz_scales(blocks, jacs, mask, sp.ndof, sweeps=4)
    jacs = scale_element_jacobians(blocks, jacs, dr, dc)
    nk = torch.zeros((sp.n_p2, 6, 6), dtype=torch.float64, device="cuda")
    npl = torch.zeros_like(nk)
    build.reset_launch_counts()
    for b, A in zip(blocks, jacs):
        knb.extract_cuda(A, b.dofs, nk)
        knb.extract_plain(A, b.dofs, npl)
    assert build.LAUNCHES["node_block_extract"] == len(blocks)
    assert _rel(nk, npl) <= RTOL
    Pk, Pp = knb.invert_cuda(npl, mask), knb.invert_plain(npl, mask)
    assert build.LAUNCHES["node_block_invert"] == 1
    scale = Pp.abs().amax(dim=(1, 2), keepdim=True)
    assert float(((Pk - Pp).abs() / scale).max()) <= RTOL
    r = torch.as_tensor(rng.normal(size=sp.ndof), device="cuda")
    yk = knb.apply_cuda(Pp, r, sp.n_p2, sp.off_p)
    assert build.LAUNCHES["node_block_apply"] == 1
    assert _rel(yk, knb.apply_plain(Pp, r, sp.n_p2, sp.off_p)) <= RTOL
    assert torch.equal(yk[sp.off_p:], r[sp.off_p:])


# ------------------------------------------------------------------ K13 --
# the K13 instances: a block of the tiny tube (its Laplace fluid, its SVK
# solid, the Mooney-Rivlin solid, the Robin facets) or a lifting or
# body-force variant of LIFT_VARIANTS
DELTA_BLOCKS = ("fluid", "solid", "solid_mr", "robin", "elastic_p_stab",
                "no_extrapolation", "gravity_mr")


@pytest.mark.parametrize("form", ["delta", "delta2"])
@pytest.mark.parametrize("name", DELTA_BLOCKS)
def test_delta_kernel(system, robin_system, mr_system, name, form):
    """K13 against its plain version at a seeded anchor A (the fixture's
    state), U = A + du and U0new = U0 + du with du = 1e-3 (A - U0), at
    1e-3 of the state's scales (an endgame-size step)."""
    sysm, A, U0 = system
    mr_b, Amr, U0mr = mr_system
    if name in ("solid_mr", "gravity_mr"):
        A, U0 = Amr, U0mr
    if name == "robin":
        b, ops = robin_system[1], facet
    elif name in ("fluid", "solid"):
        b, ops = sysm.assembler.blocks[name == "solid"], element
    elif name == "solid_mr":
        b, ops = mr_b, element
    else:
        b, ops = _variant_block(sysm, mr_b, name), element
    du = 1e-3 * (A - U0)
    U = A + du
    U0new = U0 + du if form == "delta2" else None
    counter = ("robin_" + form if ops is facet
               else element.counter_name(b, form, False))
    n0 = build.LAUNCHES[counter]
    Dk = ops.block_delta(b, U, A, U0, torch.zeros_like(U), U0new)
    torch.cuda.synchronize()
    assert build.LAUNCHES[counter] == n0 + 1

    def plain(dtype):
        D = torch.zeros_like(U)
        if ops is facet:
            return facet.delta_plain(b, U, A, D, dtype)
        if U0new is None:
            return element.delta_plain(b, U, A, U0, D, dtype)
        return element.delta2_plain(b, U, A, U0new, U0, D, dtype)

    Dp, D64 = plain(torch.float32), plain(torch.float64)
    assert float(D64.abs().max()) > 0
    assert float((Dk - Dp).abs().max()) <= 2 * float(
        (Dp - D64).abs().max()) + 1e-12 * float(D64.abs().max())


# ------------------------------------- K3 instances, quadrature degrees --
# every form instance of the element kernels: the tiny tube's fluid block
# with each lifting and sub-type and the pressure stabilization, its solid
# block in each material and with gravity
K3_INSTANCES = {
    "laplace_constant": (0, {}),
    "laplace_volume": (0, dict(lift_sub="volume", lift_coeff=2.3)),
    "laplace_volume_change": (0, dict(lift_sub="volume_change",
                                      lift_coeff=1.7)),
    "elastic": (0, dict(lift="elastic")),
    "no_extrapolation": (0, dict(lift="no_extrapolation")),
    "p_stab": (0, dict(p_stab=0.1)),
    "svk": (1, {}),
    "mr": (1, {}),
    "gravity": (1, dict(gravity=[0.0, 0.0, -9.81])),
}


def _instance_block(system, mr_system, name, degree=None, n=None, mask=True):
    """The instance's block (its first n cells), at another quadrature
    degree where one is given, with a seeded 0/1 row mask, and its state."""
    import dataclasses

    from vasp_tpu_torch.fem import forms

    sysm, U, U0 = system
    i, kw = K3_INSTANCES[name]
    b = sysm.assembler.blocks[i]
    if name == "mr":
        b, U, U0 = mr_system
    k = b.kernel
    deg = degree or k.quad_degree
    if i == 0:
        kern = forms.make_fluid_kernel(
            k.rho_f, k.mu_f, k.dt, k.theta, quad_degree=deg,
            **(dict(lift_sub=k.lift_sub, lift_coeff=k.lift_coeff) | kw))
    else:
        kern = forms.make_solid_kernel(k.props, k.dt, k.theta,
                                       quad_degree=deg, **kw)
    n = n or b.dofs.shape[0]
    rng = np.random.default_rng(17)
    rowmask = (torch.as_tensor(rng.random((n, 64)) > 0.2,
                               dtype=torch.float64, device="cuda")
               if mask else None)
    return dataclasses.replace(
        b, kernel=kern, dofs=b.dofs[:n], Jinv=b.Jinv[:n], detJ=b.detJ[:n],
        vol=b.vol[:n], rowmask=rowmask), U, U0


def _k3_holds(b, U, U0, dtypes=(torch.float64, torch.float32)):
    """K3 against jacobian_plain: 1e-12 per block in float64, 2e-7 in
    float32, each launch counted once."""
    Ap = element.jacobian_plain(b, U, U0)
    K = Ap.shape[0]
    for dt in dtypes:
        name = element.counter_name(b, "jacobian", dt == torch.float32)
        n0 = build.LAUNCHES[name]
        Ak = element.block_jacobian(b, U, U0, dt)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == n0 + 1
        assert Ak.dtype == dt and Ak.shape == (K, 64, 64)
        ref = Ap.to(dt).double()
        per_block = (Ak.double() - ref).reshape(K, -1).norm(dim=1) / \
            ref.reshape(K, -1).norm(dim=1)
        assert float(per_block.max()) <= (RTOL if dt == torch.float64
                                          else 2e-7)
        if b.rowmask is not None:
            assert not Ak[b.rowmask == 0].any()


@pytest.mark.parametrize("name", sorted(K3_INSTANCES))
def test_jacobian_instances(system, mr_system, name):
    """The point-linearised K3 on every instance, float64 and float32
    outputs, under a row mask."""
    _k3_holds(*_instance_block(system, mr_system, name))


def _residual_holds(b, U, U0, f32):
    """K1/K2 against their plain versions by their rules: float64 1e-12,
    float32 as accurate as the plain float32 version."""
    dtype = torch.float32 if f32 else None
    Rk = element.block_residual(b, U, U0, torch.zeros_like(U), dtype)
    Rp = element.residual_plain(b, U, U0, torch.zeros_like(U), dtype)
    if not f32:
        assert _rel(Rk, Rp) <= RTOL
        return
    R64 = element.residual_plain(b, U, U0, torch.zeros_like(U))
    assert float((Rk - Rp).norm()) <= 2 * float((Rp - R64).norm()) \
        + 1e-14 * float(R64.norm())


def _delta_holds(b, U, U0):
    """K13 (delta and delta2) against its plain version by its rule."""
    du = 1e-3 * (U - U0)
    A, Un = U, U + du
    for U0new in (None, U0 + du):
        Dk = element.block_delta(b, Un, A, U0, torch.zeros_like(U), U0new)

        def plain(dtype):
            D = torch.zeros_like(U)
            if U0new is None:
                return element.delta_plain(b, Un, A, U0, D, dtype)
            return element.delta2_plain(b, Un, A, U0new, U0, D, dtype)

        Dp, D64 = plain(torch.float32), plain(torch.float64)
        assert float((Dk - Dp).abs().max()) <= 2 * float(
            (Dp - D64).abs().max()) + 1e-12 * float(D64.abs().max())


@pytest.mark.parametrize("name", ["laplace_constant", "elastic", "svk",
                                  "mr"])
def test_element_kernels_degree_10(system, mr_system, name):
    """Degree 10 (216 points, past both constant banks: every table read
    from device memory) on a sub-block of 256 cells: K1/K2 in float64 and
    float32, K3 in both outputs, K13 in both forms."""
    b, U, U0 = _instance_block(system, mr_system, name, degree=10, n=256)
    assert len(b.kernel.tables_np[0]) == 216
    for f32 in (False, True):
        _residual_holds(b, U, U0, f32)
    _k3_holds(b, U, U0)
    _delta_holds(b, U, U0)


@pytest.mark.parametrize("name", ["laplace_constant", "svk"])
def test_element_kernels_degree_8_f32(system, mr_system, name):
    """Degree 8 (125 points: the float64 tables in the constant bank, the
    float32 ones past it, in device memory) on a sub-block of 256 cells:
    K1/K2 in float32 and float64, K3 in float32, K13."""
    b, U, U0 = _instance_block(system, mr_system, name, degree=8, n=256)
    assert len(b.kernel.tables_np[0]) == 125
    assert element.table_route(125, "f64") == "constant"
    assert element.table_route(125, "f32") == "memory"
    for f32 in (True, False):
        _residual_holds(b, U, U0, f32)
    _k3_holds(b, U, U0, (torch.float32,))
    _delta_holds(b, U, U0)


def test_table_routes_match_the_library(system):
    """The host side's constant-bank limits and K3's launch shape agree
    with the library's, at degrees 1 to 10."""
    lib = build.library()
    assert element.NQ_CONSTANT == {"f64": lib.vt_element_nq_max(),
                                   "f32": lib.vt_element_nq_max_f32()}
    assert lib.vt_delta_nq_max() == element.NQ_CONSTANT["f32"]
    for degree in range(1, 11):
        nq = len(tet_quadrature(degree)[1])
        for solid, kind in enumerate(("fluid", "solid")):
            qc, smem = element.jacobian_launch(kind, nq)
            assert lib.vt_jacobian_chunk(solid, nq) == qc
            assert lib.vt_jacobian_smem_bytes(solid, nq) == smem
