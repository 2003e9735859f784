"""Parity of the port's Robin facet term (K14) and of the kernels that meet
its 36-wide facet blocks (K4 matvec, K7 Ruiz, K8 banded assembly) with
vasp_tpu's, on the tiny aneurysm of tests/test_driver_aneurysm.py (Robin
on marker 33), with seeded states.

The port's blocks are built from vasp_tpu's block arrays
(vasp_tpu_torch.convert.from_vasp_tpu, which carries the facet blocks
across). Tolerances, each with its reason:
- float64 facet residual and Jacobians: 1e-12 relative (per block for the
  Jacobians); the same float64 arithmetic in other orders;
- float32 facet residual: the K1/K2 float32 rule of test_torch_assembly.py
  (each package within its float32 floor of its own float64 residual, the
  two no further apart than twice that floor);
- float32 facet Jacobians: 1e-6 per block (vasp_tpu runs jacfwd in
  float32, the port rounds the float64 Jacobian once; a facet block is a
  short sum of positive products, a few float32 roundings);
- matvec, Ruiz and banded C/D/B: the bounds of test_torch_matvec.py,
  test_torch_scaling.py and test_torch_banded.py for the same reasons."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_small_fsi import torch_threads
from vasp_tpu.fem import banded as jb
from vasp_tpu.fem.assembly import Assembler as JAssembler
from vasp_tpu.fem.assembly import FacetBlock as JFacetBlock
from vasp_tpu.fem.assembly import blocks_to_arrays, build_scatter_plan
from vasp_tpu.fem.scaling import ruiz_scales as jax_ruiz_scales
from vasp_tpu.fem.scaling import scale_element_jacobians as jax_scale
from vasp_tpu.models import aneurysm as janeurysm
from vasp_tpu.run.system import FSISystem as JFSISystem
from vasp_tpu_torch.convert import from_vasp_tpu
from vasp_tpu_torch.fem import banded as tb
from vasp_tpu_torch.fem.assembly import Assembler, FacetBlock
from vasp_tpu_torch.fem.scaling import ruiz_scales, scale_element_jacobians
from vasp_tpu_torch.kernels import facet
from vasp_tpu_torch.mesh.tetmesh import TetMesh
from vasp_tpu_torch.run.system import FSISystem as TFSISystem

_threads = torch_threads(2)

E_s, nu_s = 1e6, 0.45
MU_S = E_s / (2 * (1 + nu_s))
CFG = dict(dt=1e-3, theta=0.501, rho_f=1e3, mu_f=3.5e-3, rho_s=1e3,
           mu_s=MU_S, lambda_s=nu_s * 2 * MU_S / (1 - 2 * nu_s), dx_f_id=1,
           dx_s_id=2, extrapolation="laplace",
           extrapolation_sub_type="constant", quadrature_degree=2,
           robin_bc=True, k_s=[1e5], c_s=[10], ds_s_id=[33], device="cpu")
F32_FLOOR = 5e-7


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def systems():
    """(vasp_tpu system, port assembler from its arrays, port system,
    bc mask, U, U0) on the tiny aneurysm; the states at the aneurysm's
    scales (displacement ~1 um, velocity ~1 cm/s, pressure ~100 Pa)."""
    from vasp_tpu.fem.dirichlet import DirichletBC as JBC

    from vasp_tpu_torch.fem.dirichlet import DirichletBC

    m = janeurysm.get_mesh_domain_and_boundaries(
        None, generated_mesh_params=dict(n_theta=8, n_z=8))
    js = JFSISystem(m, CFG)
    ts = TFSISystem(TetMesh(coords=m.coords, cells=m.cells,
                            cell_markers=m.cell_markers, facets=m.facets,
                            facet_markers=m.facet_markers), CFG)
    _, arrays = blocks_to_arrays(js.assembler.blocks)
    arrays = [{k: np.asarray(v) for k, v in a.items()} for a in arrays]
    blocks = from_vasp_tpu(dict(blocks=arrays),
                           [b.kernel for b in ts.assembler.blocks],
                           names=[b.name for b in js.assembler.blocks])["blocks"]
    tasm = Assembler(ts.space.ndof, blocks)
    bcs = [(f, m_) for m_ in (2, 11) for f in ("d", "v")]
    jbc = js.make_bcset([JBC(js.space.field_dofs(f, js.space.p2_dofs_on_facets(
        m_)), 0.0) for f, m_ in bcs])
    tbc = ts.make_bcset([DirichletBC(ts.space.field_dofs(
        f, ts.space.p2_dofs_on_facets(m_)), 0.0) for f, m_ in bcs])
    assert np.array_equal(np.asarray(jbc.mask), tbc.mask)
    sp = ts.space
    scale = np.concatenate([np.full(3 * sp.n_p2, 1e-6),
                            np.full(3 * sp.n_p2, 1e-2), np.full(sp.n_p1, 1e2)])
    rng = np.random.default_rng(40)
    U, U0 = (rng.normal(size=sp.ndof) * scale for _ in range(2))
    return js, tasm, ts, tbc.mask, U, U0


def _facet(blocks):
    (b,) = [b for b in blocks if isinstance(b, (FacetBlock, JFacetBlock))]
    return b


def test_robin_blocks_match_vasp_tpu(systems):
    """The port's FSISystem builds vasp_tpu's facet block, and
    from_vasp_tpu carries it across as a FacetBlock."""
    js, tasm, ts, *_ = systems
    jb_, cb, tb_ = (_facet(s) for s in (js.assembler.blocks, tasm.blocks,
                                         ts.assembler.blocks))
    assert tb_.name == cb.name == jb_.name == "robin_33"
    assert tb_.dofs.shape == (len(np.asarray(jb_.dofs)), 36)
    for b in (tb_, cb):
        np.testing.assert_array_equal(b.dofs.numpy(), np.asarray(jb_.dofs))
        np.testing.assert_allclose(b.area2.numpy(), np.asarray(jb_.area2),
                                   rtol=1e-15, atol=0)
    assert (tb_.kernel.k_s, tb_.kernel.c_s) == (1e5, 10.0)


def _facet_residuals(systems, jdt, tdt):
    js, tasm, _, _, U, _ = systems
    jb_, tb_ = _facet(js.assembler.blocks), _facet(tasm.blocks)
    jr = np.asarray(JAssembler(js.space.ndof, [jb_]).residual(
        jnp.asarray(U), jnp.asarray(U), dtype=jdt))
    tr = Assembler(tasm.ndof, [tb_]).residual(torch.as_tensor(U),
                                              torch.as_tensor(U), tdt)
    assert tr.dtype == torch.float64
    return jr, tr.numpy()


def test_facet_residual_matches_vasp_tpu(systems):
    jr, tr = _facet_residuals(systems, None, None)
    assert np.abs(tr).max() > 0
    assert _rel(tr, jr) <= 1e-12


def test_facet_residual_f32_matches_vasp_tpu(systems):
    jr64, tr64 = _facet_residuals(systems, None, None)
    jr, tr = _facet_residuals(systems, jnp.float32, torch.float32)
    assert 0.0 < _rel(jr, jr64) <= F32_FLOOR
    assert 0.0 < _rel(tr, tr64) <= F32_FLOOR
    assert _rel(tr, jr) <= 2 * F32_FLOOR


@pytest.mark.parametrize("jdt,tdt,tol", [
    (None, torch.float64, 1e-12), (jnp.float32, torch.float32, 1e-6)],
    ids=["f64", "f32"])
def test_facet_jacobians_match_vasp_tpu(systems, jdt, tdt, tol):
    js, tasm, _, _, U, _ = systems
    jb_, tb_ = _facet(js.assembler.blocks), _facet(tasm.blocks)
    Aj = np.asarray(jb_.jacobian_local(jnp.asarray(U), None, dtype=jdt),
                    np.float64)
    At = facet.block_jacobian(tb_, torch.as_tensor(U), None, tdt)
    assert At.dtype == tdt and At.shape == Aj.shape
    At = At.double().numpy()
    K = len(Aj)
    per_block = np.linalg.norm((At - Aj).reshape(K, -1), axis=1) / \
        np.linalg.norm(Aj.reshape(K, -1), axis=1)
    assert per_block.max() <= tol


def test_facet_jacobian_closed_form(systems):
    """The closed form the CUDA kernel writes, [[0, 0], [k_s M x I3,
    c_s M x I3]] with M_ab = area2 sum_q w_q N_a N_b, is the plain
    jacfwd's Jacobian (1e-12 per block), whatever the state (the term is
    linear)."""
    _, tasm, _, _, U, _ = systems
    b = _facet(tasm.blocks)
    wq, N2t = b.kernel.tables_np
    M = np.einsum("q,qa,qb->ab", wq, N2t, N2t)[None] * \
        b.area2.numpy()[:, None, None]  # (K,6,6)
    eye = np.eye(3)
    A = np.zeros((len(M), 36, 36))
    A[:, 18:, :18] = b.kernel.k_s * np.einsum("kab,ij->kaibj", M, eye) \
        .reshape(-1, 18, 18)
    A[:, 18:, 18:] = b.kernel.c_s * np.einsum("kab,ij->kaibj", M, eye) \
        .reshape(-1, 18, 18)
    for state in (U, np.zeros_like(U)):
        At = facet.jacobian_plain(b, torch.as_tensor(state)).numpy()
        K = len(A)
        per_block = np.linalg.norm((At - A).reshape(K, -1), axis=1) / \
            np.linalg.norm(A.reshape(K, -1), axis=1)
        assert per_block.max() <= 1e-12


@pytest.fixture(scope="module")
def jacobians32(systems):
    """vasp_tpu's float32 element Jacobians of every block, cells and
    facets, at the seeded state."""
    js, _, _, _, U, U0 = systems
    return [np.array(A) for A in js.assembler.element_jacobians(
        jnp.asarray(U), jnp.asarray(U0), dtype=jnp.float32)]


@pytest.mark.parametrize("a_dt,x_dt,tol", [
    (np.float32, np.float64, 2e-6), (np.float32, np.float32, 2e-6),
    (np.float64, np.float64, 1e-12),
], ids=["jac_f32_krylov_f64", "jac_f32_krylov_f32", "exact_f64"])
def test_matvec_with_facet_block_matches_vasp_tpu(systems, jacobians32, a_dt,
                                                  x_dt, tol):
    js, tasm, *_ = systems
    blocks = js.assembler.blocks
    jasm = JAssembler(js.space.ndof, blocks,
                      scatter_plan=build_scatter_plan(blocks,
                                                      js.space.ndof))
    jacs = [A.astype(a_dt) for A in jacobians32]
    assert [A.shape[1] for A in jacs] == [64, 64, 36]
    x = np.random.default_rng(41).normal(size=tasm.ndof).astype(x_dt)
    yj = np.asarray(jasm.matvec([jnp.asarray(A) for A in jacs],
                                jnp.asarray(x)))
    yt = tasm.matvec([torch.as_tensor(A) for A in jacs], torch.as_tensor(x))
    assert yt.dtype == torch.as_tensor(x).dtype
    assert _rel(yt.double().numpy(), yj.astype(np.float64)) <= tol


def test_ruiz_with_facet_block_matches_vasp_tpu(systems, jacobians32):
    """Scales within 1e-6 (test_torch_scaling.py's bound: XLA's float32
    sqrt is not correctly rounded), the scaled matrices of the same scales
    exactly."""
    js, tasm, _, mask, _, _ = systems
    n = tasm.ndof
    jdr, jdc = jax_ruiz_scales(js.assembler.blocks,
                               [jnp.asarray(A) for A in jacobians32],
                               jnp.asarray(mask), n, sweeps=4)
    tdr, tdc = ruiz_scales(tasm.blocks,
                           [torch.as_tensor(A) for A in jacobians32],
                           torch.as_tensor(mask), n, sweeps=4)
    assert _rel(tdr.numpy(), np.asarray(jdr)) <= 1e-6
    assert _rel(tdc.numpy(), np.asarray(jdc)) <= 1e-6
    ja = jax_scale(js.assembler.blocks, [jnp.asarray(A) for A in jacobians32],
                   jdr, jdc)
    ta = scale_element_jacobians(tasm.blocks,
                                 [torch.as_tensor(A) for A in jacobians32],
                                 torch.as_tensor(np.asarray(jdr)),
                                 torch.as_tensor(np.asarray(jdc)))
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_banded_with_facet_block_matches_vasp_tpu(systems, jacobians32):
    """The host pattern and plan over the cell and facet blocks, and C/D/B
    from the same scaled matrices, equal vasp_tpu's."""
    js, tasm, _, mask, _, _ = systems
    jdr, jdc = jax_ruiz_scales(js.assembler.blocks,
                               [jnp.asarray(A) for A in jacobians32],
                               jnp.asarray(mask), tasm.ndof, sweeps=4)
    jf = [np.array(A) for A in jax_scale(
        js.assembler.blocks, [jnp.asarray(A) for A in jacobians32], jdr, jdc)]
    block_dofs = [b.dofs.numpy() for b in tasm.blocks]
    jpat = jb.build_banded_pattern(block_dofs, tasm.ndof)
    tpat = tb.build_banded_pattern(block_dofs, tasm.ndof)
    np.testing.assert_array_equal(tpat.perm, jpat.perm)
    assert (tpat.c, tpat.nb) == (jpat.c, jpat.nb) and tpat.nb >= 2
    jplan = jb.build_banded_assembly_plan(block_dofs, jpat, mask)
    tplan = tb.build_banded_assembly_plan(block_dofs, tpat, mask)
    for jper, tper in zip(jplan, tplan):
        for jp, tp in zip(jper, tper):
            np.testing.assert_array_equal(tp["src"], np.asarray(jp["src"]))
    want = jb.assemble_banded_planned(
        [jnp.asarray(A) for A in jf], jplan, jpat,
        jnp.asarray(jb.identity_diag_slots(jpat, mask)))
    got = tb.assemble_banded_planned(
        [torch.as_tensor(A) for A in jf], tb.plans_to_device(tplan, "cpu"),
        tpat, torch.as_tensor(tb.identity_diag_slots(tpat, mask)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
