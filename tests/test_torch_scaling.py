"""Parity of the port's Ruiz equilibration (K7) with vasp_tpu's: the same
float32 element Jacobians in, the scales and scaled Jacobians out.

Tolerance: 1e-6 relative. The maxima are exact on both sides, but XLA's
CPU float32 sqrt is not correctly rounded while torch's is, so a few
scales differ in their last bit and the next sweeps carry that on
(measured 2.3e-7 on 47 of 6,024 scales of this tube)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_small_fsi import build_pair, random_state, torch_threads
from vasp_tpu.fem.scaling import ruiz_scales as jax_ruiz_scales
from vasp_tpu.fem.scaling import scale_element_jacobians as jax_scale
from vasp_tpu_torch.fem.scaling import ruiz_scales, scale_element_jacobians

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def jacobians():
    (js, jbc), (ts, tbc) = build_pair()
    U = random_state(ts.space, 0)
    U0 = random_state(ts.space, 1)
    jacs = [np.array(A) for A in js.assembler.element_jacobians(
        jnp.asarray(U), jnp.asarray(U0), dtype=jnp.float32)]
    return js, ts, tbc.mask, jacs


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("sweeps", [1, 4])
def test_ruiz_scales_match_vasp_tpu(jacobians, sweeps):
    js, ts, mask, jacs = jacobians
    n = ts.space.ndof
    jdr, jdc = jax_ruiz_scales(js.assembler.blocks,
                               [jnp.asarray(A) for A in jacs],
                               jnp.asarray(mask), n, sweeps=sweeps)
    tdr, tdc = ruiz_scales(ts.assembler.blocks,
                           [torch.as_tensor(A) for A in jacs],
                           torch.as_tensor(mask), n, sweeps=sweeps)
    assert tdr.dtype == torch.float32
    assert np.all(tdr.numpy()[mask] == 1.0) and np.all(tdc.numpy()[mask] == 1.0)
    assert _rel(tdr.numpy(), np.asarray(jdr)) <= 1e-6
    assert _rel(tdc.numpy(), np.asarray(jdc)) <= 1e-6


def test_scaled_jacobians_match_vasp_tpu(jacobians):
    """The same scales in: the two float32 products agree exactly."""
    js, ts, mask, jacs = jacobians
    rng = np.random.default_rng(5)
    dr = rng.uniform(0.5, 2.0, ts.space.ndof).astype(np.float32)
    dc = rng.uniform(0.5, 2.0, ts.space.ndof).astype(np.float32)
    ja = jax_scale(js.assembler.blocks, [jnp.asarray(A) for A in jacs],
                   jnp.asarray(dr), jnp.asarray(dc))
    ta = scale_element_jacobians(ts.assembler.blocks,
                                 [torch.as_tensor(A) for A in jacs],
                                 torch.as_tensor(dr), torch.as_tensor(dc))
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
