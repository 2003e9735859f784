"""The Mooney-Rivlin solid of the port against vasp_tpu's: the closed-form
stress, the solid block's residual and its Jacobians.

The same inputs (numpy, one seed) go through vasp_tpu (jax.grad of the
strain energy for S, jax.vmap of its element kernel, jax.jacfwd for the
Jacobians) and the port's plain torch versions. Tolerances, each with its
reason:
- S and the float64 residuals: 1e-12 relative; both float64, the port's S
  in closed form where vasp_tpu differentiates W, whose constant terms
  cancel to O(|E|) (the largest distance is at strain 1e-4);
- the port's float32 S: F32_FLOOR relative to its float64 S at every
  strain (its constant terms folded);
- element Jacobians: 1e-11 per cell block (forward mode over the same
  expressions on both sides);
- float32 element work: by the rule of test_torch_assembly.py, each
  package within F32_FLOOR of its own float64 residual and the two no
  further apart than twice that.
Parameter sets: the predeform wall (vasp_tpu/models/predeform.py:58-67)
and the AVF vein (vasp_tpu/models/avf.py:68-72), the latter with C10 made
nonzero so that every term of S counts."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vasp_tpu.fem import forms as jforms
from vasp_tpu.fem import kinematics as jkin
from vasp_tpu.fem.assembly import blocks_to_arrays
from vasp_tpu.run.system import FSISystem as JFSISystem
from vasp_tpu_torch.convert import from_vasp_tpu
from vasp_tpu_torch.fem import forms as tforms
from vasp_tpu_torch.fem import kinematics as tkin
from vasp_tpu_torch.fem.assembly import Assembler
from vasp_tpu_torch.mesh.tetmesh import TetMesh
from vasp_tpu_torch.run.system import FSISystem as TFSISystem
from _torch_small_fsi import torch_threads

_threads = torch_threads(2)

RTOL = 1e-12
F32_FLOOR = 5e-7  # tests/test_torch_assembly.py
_E, _NU = 1e6, 0.45
_MU = _E / (2 * (1 + _NU))
_LAM = _NU * 2.0 * _MU / (1.0 - 2.0 * _NU)
PREDEFORM = dict(material_model="MooneyRivlin", rho_s=1e3, mu_s=_MU,
                 lambda_s=_LAM, C01=0.02e6, C10=0.0, C11=1.8e6)
VEIN = dict(material_model="MooneyRivlin", rho_s=1e3, mu_s=3 * _MU,
            lambda_s=3 * _LAM, C01=0.003e6, C10=0.05e6, C11=0.538e6)
PROPS = {"predeform": PREDEFORM, "vein": VEIN}


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("which", sorted(PROPS))
@pytest.mark.parametrize("strain", [1e-4, 1e-3, 1e-2, 1e-1])
def test_stress_matches_autodiff_and_vasp_tpu(strain, which):
    props = PROPS[which]
    H = np.random.default_rng(1).normal(size=(32, 3, 3)) * strain
    Ht = torch.as_tensor(H)
    S = tkin.S_(Ht, props)
    E = tkin.E_(Ht)
    dW = torch.func.vmap(torch.func.grad(
        lambda e: tkin.W_mooney_rivlin(e, props)))(E)
    S_ad = 0.5 * (dW + dW.transpose(1, 2))
    assert _rel(S.numpy(), S_ad.numpy()) <= RTOL
    S_j = np.asarray(jax.vmap(lambda h: jkin.S_(h, props))(jnp.asarray(H)))
    assert _rel(S.numpy(), S_j) <= RTOL
    assert torch.equal(S, S.transpose(1, 2))


@pytest.mark.parametrize("strain", [1e-4, 1e-3, 1e-2, 1e-1])
def test_f32_stress_is_f32_grade(strain):
    """In float32 the closed form keeps its precision relative to |S| at
    every strain: its constant terms are folded, where W's gradient
    cancels them to O(|E|). Bound: F32_FLOOR."""
    H = np.random.default_rng(2).normal(size=(32, 3, 3)) * strain
    for props in PROPS.values():
        S64 = tkin.S_(torch.as_tensor(H), props).numpy()
        S32 = tkin.S_(torch.as_tensor(H, dtype=torch.float32), props)
        assert S32.dtype == torch.float32
        assert _rel(S32.double().numpy(), S64) <= F32_FLOOR


@pytest.mark.parametrize("which", sorted(PROPS))
def test_stress_free_at_rest(which):
    for dtype in (torch.float64, torch.float32):
        S = tkin.S_(torch.zeros(4, 3, 3, dtype=dtype), PROPS[which])
        assert S.dtype == dtype and not S.any()


def _local_inputs(seed, K, strain):
    """Random well-shaped tets of size ~1 mm (the unit corner tet with
    its vertices moved by ~0.2 mm) and local states whose displacement
    gradients are ~strain."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, 4, 3)) * 0.2e-3
    x[:, 1:] += np.eye(3)[None] * 1e-3
    A = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]],
                 axis=2)
    detJ = np.abs(np.linalg.det(A))
    u, u0 = rng.normal(size=(2, K, 64))
    for a in (u, u0):
        a[:, :30] *= 1e-3 * strain
        a[:, 30:] *= 1e-2  # velocities ~1 cm/s (and the unused p)
    return u, u0, np.linalg.inv(A), detJ, detJ / 6.0


@pytest.mark.parametrize("which", sorted(PROPS))
@pytest.mark.parametrize("qd", [2, 6])
def test_solid_residual_matches_vasp_tpu(qd, which):
    args = _local_inputs(2, 16, 1e-2)
    jk = jforms.make_solid_kernel(PROPS[which], 1e-2, 1.0, quad_degree=qd)
    tk = tforms.make_solid_kernel(PROPS[which], 1e-2, 1.0, quad_degree=qd)
    rj = np.asarray(jax.vmap(jk)(*[jnp.asarray(a) for a in args]))
    rt = tk(*[torch.as_tensor(a) for a in args]).numpy()
    assert _rel(rt, rj) <= RTOL


def test_cell_jacobians_match_jax_jacfwd():
    """The vein's constants (C10 nonzero); the predeform wall's Jacobians
    are held at the system level below."""
    args = _local_inputs(3, 4, 1e-2)
    jk = jforms.make_solid_kernel(VEIN, 1e-2, 0.501, quad_degree=3)
    tk = tforms.make_solid_kernel(VEIN, 1e-2, 0.501, quad_degree=3)
    Aj = np.asarray(jax.vmap(jax.jacfwd(jk))(*[jnp.asarray(a) for a in args]))
    At = torch.func.vmap(torch.func.jacfwd(tk.cell))(
        *[torch.as_tensor(a) for a in args]).numpy()
    for k in range(4):
        assert _rel(At[k], Aj[k]) <= 1e-11


# ---- the MR solid blocks of a system, built from vasp_tpu's arrays ----
CFG = dict(dt=1e-2, theta=1.0, rho_f=1.025e3, mu_f=3.5e-3, dx_f_id=1,
           extrapolation="laplace", extrapolation_sub_type="constant",
           quadrature_degree=2, device="cpu",
           solid_properties=dict(PREDEFORM, dx_s_id=2))


@pytest.fixture(scope="module")
def mr_systems(tiny_tube):
    """vasp_tpu's MR system, the port's own, the port's blocks converted
    from vasp_tpu's arrays, and a state with strains ~1e-2."""
    js = JFSISystem(tiny_tube, CFG)
    m = tiny_tube
    ts = TFSISystem(TetMesh(coords=m.coords, cells=m.cells,
                            cell_markers=m.cell_markers, facets=m.facets,
                            facet_markers=m.facet_markers), CFG)
    _, arrays = blocks_to_arrays(js.assembler.blocks)
    blocks = from_vasp_tpu(
        dict(blocks=[{k: np.asarray(v) for k, v in a.items()}
                     for a in arrays]),
        [b.kernel for b in ts.assembler.blocks],
        names=[b.name for b in js.assembler.blocks])["blocks"]
    rng = np.random.default_rng(4)
    sp = js.space
    scale = np.concatenate([np.full(3 * sp.n_p2, 1e-2 * m.hmin),
                            np.full(3 * sp.n_p2, 1e-2),
                            np.full(sp.n_p1, 1e2)])
    U, U0 = (rng.normal(size=sp.ndof) * scale for _ in range(2))
    return js, ts, Assembler(ts.space.ndof, blocks), U, U0


def test_system_builds_mr_blocks(mr_systems):
    js, ts, conv, _, _ = mr_systems
    names = [b.name for b in ts.assembler.blocks]
    assert names == [b.name for b in js.assembler.blocks] \
        == ["fluid_1", "solid_2"]
    for asm in (ts.assembler, conv):
        kern = asm.blocks[1].kernel
        assert kern.props["material_model"] == "MooneyRivlin"
        assert (kern.props["C01"], kern.props["C11"]) == (0.02e6, 1.8e6)
        assert torch.equal(asm.blocks[1].dofs, conv.blocks[1].dofs)


def test_residual_matches_vasp_tpu(mr_systems):
    js, ts, conv, U, U0 = mr_systems
    Rj = np.asarray(js.assembler.residual(jnp.asarray(U), jnp.asarray(U0)))
    for asm in (conv, ts.assembler):
        Rt = asm.residual(torch.as_tensor(U), torch.as_tensor(U0)).numpy()
        assert _rel(Rt, Rj) <= RTOL


def test_f32_residual_as_accurate_as_vasp_tpu(mr_systems):
    js, _, conv, U, U0 = mr_systems
    args_j = (jnp.asarray(U), jnp.asarray(U0))
    args_t = (torch.as_tensor(U), torch.as_tensor(U0))
    Rj64 = np.asarray(js.assembler.residual(*args_j))
    Rt64 = conv.residual(*args_t).numpy()
    Rj = np.asarray(js.assembler.residual(*args_j, dtype=jnp.float32))
    Rt = conv.residual(*args_t, torch.float32).numpy()
    assert 0.0 < _rel(Rj, Rj64) <= F32_FLOOR
    assert 0.0 < _rel(Rt, Rt64) <= F32_FLOOR
    assert _rel(Rt, Rj) <= 2 * F32_FLOOR


def test_element_jacobians_match_vasp_tpu(mr_systems):
    js, _, conv, U, U0 = mr_systems
    Aj = [np.asarray(A) for A in js.assembler.element_jacobians(
        jnp.asarray(U), jnp.asarray(U0))]
    At = conv.element_jacobians(torch.as_tensor(U), torch.as_tensor(U0))
    for aj, at in zip(Aj, At):
        at = at.numpy()
        num = np.linalg.norm((at - aj).reshape(len(aj), -1), axis=1)
        den = np.linalg.norm(aj.reshape(len(aj), -1), axis=1)
        assert np.all(num <= 1e-11 * den)
