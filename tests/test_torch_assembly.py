"""Parity of the port's assembly (residual, element Jacobians, host CSR)
with vasp_tpu's, on the tiny tube with small random states.

Both packages get the same system: the port's blocks are built from
vasp_tpu's block arrays (vasp_tpu_torch.convert.from_vasp_tpu)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vasp_tpu.fem.assembly import blocks_to_arrays
from vasp_tpu.run.system import FSISystem as JFSISystem
from vasp_tpu_torch.convert import from_vasp_tpu
from vasp_tpu_torch.fem.assembly import Assembler
from vasp_tpu_torch.run.system import FSISystem as TFSISystem
from vasp_tpu_torch.mesh.tetmesh import TetMesh
from _torch_small_fsi import torch_threads

_threads = torch_threads(2)

E_s, nu_s = 1e6, 0.45
MU_S = E_s / (2 * (1 + nu_s))
CFG = dict(dt=1e-3, theta=0.501, rho_f=1.025e3, mu_f=3.5e-3, rho_s=1e3,
           mu_s=MU_S, lambda_s=nu_s * 2 * MU_S / (1 - 2 * nu_s),
           dx_f_id=1, dx_s_id=2, extrapolation="laplace",
           extrapolation_sub_type="constant", device="cpu")


def _port_mesh(m):
    return TetMesh(coords=m.coords, cells=m.cells,
                   cell_markers=m.cell_markers, facets=m.facets,
                   facet_markers=m.facet_markers)


def _systems(mesh, qd, **extra):
    cfg = dict(CFG, quadrature_degree=qd, **extra)
    js = JFSISystem(mesh, cfg)
    ts = TFSISystem(_port_mesh(mesh), cfg)
    _, arrays = blocks_to_arrays(js.assembler.blocks)
    arrays = [{k: np.asarray(v) for k, v in a.items()} for a in arrays]
    blocks = from_vasp_tpu(dict(blocks=arrays),
                           [b.kernel for b in ts.assembler.blocks],
                           names=[b.name for b in js.assembler.blocks])["blocks"]
    return js, Assembler(ts.space.ndof, blocks), ts


def _states(ndof, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=ndof) * 1e-4, rng.normal(size=ndof) * 1e-4


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("lift_sub", ["constant", "volume_change"])
def test_residual_matches_vasp_tpu(tiny_tube, lift_sub):
    js, tasm, _ = _systems(tiny_tube, qd=6, extrapolation_sub_type=lift_sub)
    # the fluid block carries the kinematic rowmask
    assert tasm.blocks[0].rowmask is not None
    U, U0 = _states(js.space.ndof, 10)
    Rj = np.asarray(js.assembler.residual(jnp.asarray(U), jnp.asarray(U0)))
    Rt = tasm.residual(torch.as_tensor(U), torch.as_tensor(U0))
    assert Rt.dtype == torch.float64
    assert _rel(Rt.numpy(), Rj) <= 1e-12


def test_port_system_matches_converted_system(tiny_tube):
    """The port's own FSISystem builds the same blocks as vasp_tpu."""
    js, tasm, ts = _systems(tiny_tube, qd=3)
    for a, b in zip(tasm.blocks, ts.assembler.blocks):
        assert a.name == b.name
        assert torch.equal(a.dofs, b.dofs)
        assert torch.allclose(a.Jinv, b.Jinv, rtol=1e-14, atol=0)
        assert (a.rowmask is None) == (b.rowmask is None)
        if a.rowmask is not None:
            assert torch.equal(a.rowmask, b.rowmask)


@pytest.fixture(scope="module")
def jacobians(tiny_tube):
    js, tasm, _ = _systems(tiny_tube, qd=3)
    U, U0 = _states(js.space.ndof, 11)
    Aj = [np.asarray(A) for A in js.assembler.element_jacobians(
        jnp.asarray(U), jnp.asarray(U0))]
    At = tasm.element_jacobians(torch.as_tensor(U), torch.as_tensor(U0))
    return js, tasm, Aj, At


def test_element_jacobians_match_vasp_tpu(jacobians):
    js, tasm, Aj, At = jacobians
    for aj, at in zip(Aj, At):
        at = at.numpy()
        assert at.shape == aj.shape
        num = np.linalg.norm((at - aj).reshape(len(aj), -1), axis=1)
        den = np.linalg.norm(aj.reshape(len(aj), -1), axis=1)
        assert np.all(num <= 1e-11 * den)


def test_to_csr_matches_vasp_tpu(jacobians):
    js, tasm, Aj, At = jacobians
    rng = np.random.default_rng(12)
    mask = rng.random(js.space.ndof) < 0.1
    Mj = js.assembler.to_csr([jnp.asarray(a) for a in Aj], bc_mask=mask)
    Mt = tasm.to_csr(At, bc_mask=mask)
    Mj.sort_indices()
    Mt.sort_indices()
    np.testing.assert_array_equal(Mt.indptr, Mj.indptr)
    np.testing.assert_array_equal(Mt.indices, Mj.indices)
    scale = np.abs(Mj.data).max()
    assert np.abs(Mt.data - Mj.data).max() <= 1e-12 * scale


def test_from_vasp_tpu_carries_state_and_bcs(tiny_tube):
    """U, U0 and the Dirichlet mask/values cross over exactly, and the
    port's strong BC application matches vasp_tpu's."""
    from vasp_tpu.fem.dirichlet import BCSet, DirichletBC

    js, _, ts = _systems(tiny_tube, qd=2)
    n = js.space.ndof
    U, U0 = _states(n, 13)
    rng = np.random.default_rng(14)
    dofs = np.nonzero(rng.random(n) < 0.05)[0]
    bcs = BCSet(n, [DirichletBC(dofs, rng.normal(size=len(dofs)))])
    _, arrays = blocks_to_arrays(js.assembler.blocks)
    out = from_vasp_tpu(
        dict(blocks=[{k: np.asarray(v) for k, v in a.items()}
                     for a in arrays],
             U=U, U0=U0, bc_mask=bcs.mask, bc_values=bcs.values_at(0.0)),
        [b.kernel for b in ts.assembler.blocks])
    assert out["U"].dtype == torch.float64
    np.testing.assert_array_equal(out["U"].numpy(), U)
    np.testing.assert_array_equal(out["U0"].numpy(), U0)
    Ut = torch.where(out["bc_mask"], out["bc_values"], out["U"])
    np.testing.assert_array_equal(
        Ut.numpy(), np.asarray(bcs.apply(jnp.asarray(U), 0.0)))


# relative distance of a float32-element-work residual to the float64 one
# on these states (measured at degree 6: 1.1e-7 vasp_tpu, 2.2e-7 the port,
# whose plain float32 sums round more than XLA's); "mixed" keeps the solid
# in float64, where the float32 cancellation noise lives (measured 9e-12
# and 8e-12)
F32_FLOOR = 5e-7
MIXED_FLOOR = 5e-9


@pytest.mark.parametrize("mode", ["f32", "mixed"])
def test_hybrid_residual_matches_vasp_tpu(tiny_tube, mode):
    """Assembler.residual(dtype=float32 / "mixed"): each package within its
    noise floor of its own float64 residual, and the two packages no
    further apart than twice the float32 floor (both are float32 element
    work summed in float64, in other orders)."""
    js, tasm, _ = _systems(tiny_tube, qd=6)
    U, U0 = _states(js.space.ndof, 10)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "mixed": ("mixed", "mixed")}[mode]
    args_j = (jnp.asarray(U), jnp.asarray(U0))
    args_t = (torch.as_tensor(U), torch.as_tensor(U0))
    Rj64 = np.asarray(js.assembler.residual(*args_j))
    Rt64 = tasm.residual(*args_t).numpy()
    Rj = np.asarray(js.assembler.residual(*args_j, dtype=jdt))
    Rt = tasm.residual(*args_t, tdt)
    assert Rt.dtype == torch.float64
    Rt = Rt.numpy()
    floor = F32_FLOOR if mode == "f32" else MIXED_FLOOR
    assert 0.0 < _rel(Rj, Rj64) <= floor
    assert 0.0 < _rel(Rt, Rt64) <= floor
    assert _rel(Rt, Rj) <= 2 * F32_FLOOR


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, "f32"])
def test_residual_refuses_other_precisions(tiny_tube, dtype):
    _, tasm, _ = _systems(tiny_tube, qd=2)
    U = torch.zeros(tasm.ndof, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32|mixed"):
        tasm.residual(U, U, dtype)
