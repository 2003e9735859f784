"""Parity of the port's plain element kernels with vasp_tpu's.

The same random local inputs (numpy, one seed) go through jax.vmap of the
vasp_tpu kernel and the port's batched torch kernel, both in float64."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vasp_tpu.fem import forms as jforms
from vasp_tpu.fem import kinematics as jkin
from vasp_tpu_torch.fem import forms as tforms
from vasp_tpu_torch.fem import kinematics as tkin
from _torch_small_fsi import torch_threads

_threads = torch_threads(1)

RTOL = 1e-12  # both sides f64; only summation order differs
FLUID = dict(rho_f=1.025e3, mu_f=3.5e-3, dt=1e-3, theta=0.501)
SOLID = dict(material_model="StVenantKirchoff", rho_s=1e3,
             mu_s=1e6 / 2.9, lambda_s=0.45 * 2 * (1e6 / 2.9) / 0.1)


def _local_inputs(seed, K=12, scale=1e-3):
    """Random tets of size ~1 mm plus random local states."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, 4, 3)) * 1e-3
    x[:, 1:] += np.eye(3)[None] * 1e-3  # keep the tets well shaped
    A = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]],
                 axis=2)
    detA = np.linalg.det(A)
    Jinv = np.linalg.inv(A)
    detJ = np.abs(detA)
    u = rng.normal(size=(K, 64)) * scale
    u0 = rng.normal(size=(K, 64)) * scale
    return u, u0, Jinv, detJ, detJ / 6.0


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _both(jk, tk, args):
    rj = np.asarray(jax.vmap(jk)(*[jnp.asarray(a) for a in args]))
    rt = tk(*[torch.as_tensor(a, dtype=torch.float64) for a in args]).numpy()
    return rj, rt


FLUID_CASES = [
    dict(lift="laplace", lift_sub="constant", lift_coeff=1.0),
    dict(lift="laplace", lift_sub="small_constant", lift_coeff=3.7e-9),
    dict(lift="laplace", lift_sub="volume", lift_coeff=1.0),
    dict(lift="laplace", lift_sub="volume_change", lift_coeff=1.0),
    dict(lift="elastic", lift_sub="constant", lift_coeff=1.0),
    dict(lift="no_extrapolation"),
    dict(lift="laplace", lift_sub="constant", p_stab=0.1),
]


@pytest.mark.parametrize("qd", [3, 6])
@pytest.mark.parametrize("case", FLUID_CASES,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_fluid_residual_matches_vasp_tpu(case, qd):
    args = _local_inputs(1)
    rj, rt = _both(jforms.make_fluid_kernel(**FLUID, quad_degree=qd, **case),
                   tforms.make_fluid_kernel(**FLUID, quad_degree=qd, **case),
                   args)
    assert rt.shape == (12, 64)
    assert _rel(rt, rj) <= RTOL


@pytest.mark.parametrize("gravity", [None, [0.0, 0.0, -9.81]])
@pytest.mark.parametrize("qd", [3, 6])
def test_solid_residual_matches_vasp_tpu(qd, gravity):
    args = _local_inputs(2)
    rj, rt = _both(
        jforms.make_solid_kernel(SOLID, 1e-3, 0.501, gravity=gravity,
                                 quad_degree=qd),
        tforms.make_solid_kernel(SOLID, 1e-3, 0.501, gravity=gravity,
                                 quad_degree=qd),
        args)
    assert _rel(rt, rj) <= RTOL


@pytest.mark.parametrize("kind", ["fluid", "solid"])
def test_cell_jacobian_matches_jax_jacfwd(kind):
    """The plain K3 (torch.func.jacfwd of the per-cell residual) against
    jax.jacfwd of the vasp_tpu kernel, per element block."""
    args = _local_inputs(3, K=4)
    if kind == "fluid":
        jk = jforms.make_fluid_kernel(**FLUID, quad_degree=3)
        tk = tforms.make_fluid_kernel(**FLUID, quad_degree=3)
    else:
        jk = jforms.make_solid_kernel(SOLID, 1e-3, 0.501, quad_degree=3)
        tk = tforms.make_solid_kernel(SOLID, 1e-3, 0.501, quad_degree=3)
    Aj = np.asarray(jax.vmap(jax.jacfwd(jk))(*[jnp.asarray(a) for a in args]))
    At = torch.func.vmap(torch.func.jacfwd(tk.cell))(
        *[torch.as_tensor(a, dtype=torch.float64) for a in args]).numpy()
    assert At.shape == (4, 64, 64)
    for k in range(4):
        assert _rel(At[k], Aj[k]) <= 1e-11


def test_svk_closed_form_matches_autodiff_and_vasp_tpu():
    rng = np.random.default_rng(4)
    H = rng.normal(size=(16, 3, 3)) * 1e-2
    Ht = torch.as_tensor(H, dtype=torch.float64)
    S = tkin.S_(Ht, SOLID)
    # S = dW/dE, symmetrized as the reference package does
    dW = torch.func.vmap(torch.func.grad(
        lambda E: tkin.W_st_venant_kirchoff(E, SOLID)))(tkin.E_(Ht))
    S_ad = 0.5 * (dW + dW.transpose(1, 2))
    assert _rel(S.numpy(), S_ad.numpy()) <= RTOL
    S_j = np.asarray(jax.vmap(lambda h: jkin.S_(h, SOLID))(jnp.asarray(H)))
    assert _rel(S.numpy(), S_j) <= RTOL
