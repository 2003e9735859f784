"""Parity of the port's float32 element Jacobians (K3) and element matvec
(K4) with vasp_tpu's, on the small FSI tube with seeded states, and the
matvec against a central difference of the residual.

Tolerances, each with its reason:
- float32 Jacobians: 5e-6 relative per cell block. vasp_tpu runs jacfwd in
  float32 arithmetic, the port rounds its float64 Jacobian once; measured
  2.6e-7 on this tube.
- matvec with float32 products: 2e-6 relative (64-term float32 row sums
  in another order; measured 9e-8). Float64 throughout: 1e-12 (vasp_tpu
  accumulates by a prefix-sum difference, the port by index_add_).
- central difference: 1e-6 relative. Its O(eps^2) truncation and roundoff
  sit near 1e-9 at eps = 1e-3 of the state's scale."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_small_fsi import build_pair, random_state, torch_threads
from vasp_tpu.fem.assembly import Assembler as JAssembler
from vasp_tpu.fem.assembly import build_scatter_plan

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def pair():
    (js, _), (ts, _) = build_pair()
    blocks = js.assembler.blocks
    # vasp_tpu's iterative path assembles through the sorted scatter plan
    jasm = JAssembler(js.assembler.ndof, blocks,
                      scatter_plan=build_scatter_plan(blocks,
                                                      js.assembler.ndof))
    U = random_state(ts.space, 0)
    U0 = random_state(ts.space, 1)
    # the finite-difference direction, at the state's scales
    dU = random_state(ts.space, 3)
    return jasm, ts.assembler, U, U0, dU


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_f32_jacobians_match_vasp_tpu(pair):
    jasm, tasm, U, U0, _ = pair
    jj = jasm.element_jacobians(jnp.asarray(U), jnp.asarray(U0),
                                dtype=jnp.float32)
    tj = tasm.element_jacobians(torch.as_tensor(U), torch.as_tensor(U0),
                                dtype=torch.float32)
    for a, b in zip(jj, tj):
        assert b.dtype == torch.float32
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        K = a.shape[0]
        per_block = np.linalg.norm((a - b).reshape(K, -1), axis=1) / \
            np.linalg.norm(a.reshape(K, -1), axis=1)
        assert per_block.max() <= 5e-6


@pytest.mark.parametrize("a_dt,x_dt,tol", [
    (np.float32, np.float64, 2e-6), (np.float32, np.float32, 2e-6),
    (np.float64, np.float64, 1e-12),
], ids=["jac_f32_krylov_f64", "jac_f32_krylov_f32", "exact_f64"])
def test_matvec_matches_vasp_tpu(pair, a_dt, x_dt, tol):
    jasm, tasm, U, U0, _ = pair
    jacs = [np.asarray(A).astype(a_dt) for A in jasm.element_jacobians(
        jnp.asarray(U), jnp.asarray(U0))]
    x = np.random.default_rng(2).normal(size=tasm.ndof).astype(x_dt)
    yj = np.asarray(jasm.matvec([jnp.asarray(A) for A in jacs],
                                jnp.asarray(x)))
    yt = tasm.matvec([torch.as_tensor(A) for A in jacs], torch.as_tensor(x))
    assert yt.dtype == torch.as_tensor(x).dtype
    assert _rel(yt.double().numpy(), yj.astype(np.float64)) <= tol


def test_matvec_is_the_residual_derivative(pair):
    _, tasm, U, U0, dU = pair
    U, U0, x = (torch.as_tensor(a) for a in (U, U0, dU))
    jacs = tasm.element_jacobians(U, U0)
    eps = 1e-3
    fd = (tasm.residual(U + eps * x, U0) - tasm.residual(U - eps * x, U0)) \
        / (2 * eps)
    Jx = tasm.matvec(jacs, x)
    assert _rel(Jx.numpy(), fd.numpy()) <= 1e-6
