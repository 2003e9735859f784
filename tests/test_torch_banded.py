"""Parity of the port's banded preconditioner (host pattern and plan, K8
assembly, K9 Schur scan, K10 probe, K6 apply) with vasp_tpu.fem.banded on
the small FSI tube, both sides fed the same inputs; and
test_banded.py::test_banded_is_direct_solve repeated on the port alone.

Tolerances, each with its reason:
- ordering, block size, identity slots, plan: equal (the same C++ RCM and
  the same host numpy code);
- C/D/B: equal (the same float32 additions in plan order on both sides);
- factors: 2e-3 relative. Both run the same recursion in float32, with
  another LU (LAPACK through torch against XLA's) and other matmul
  orders; their rounding is amplified by the Schur blocks' conditioning
  (measured 6e-5 to 1.2e-4 on this tube).
- apply on the same factors: 1e-4 relative (float32 dot products in
  another order through 2 nb - 1 scan steps; measured 7.5e-6)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_small_fsi import build_pair, torch_threads
from vasp_tpu.fem import banded as jb
from vasp_tpu.fem.scaling import ruiz_scales as jax_ruiz_scales
from vasp_tpu.fem.scaling import scale_element_jacobians as jax_scale
from vasp_tpu_torch.fem import banded as tb
from vasp_tpu_torch.fem.scaling import ruiz_scales, scale_element_jacobians

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def setup():
    """vasp_tpu's scaled f32 Jacobians at the first step of a loaded tube
    (as test_banded.py builds them), with both packages' patterns."""
    (js, jbc), (ts, tbc) = build_pair()
    mask = tbc.mask
    jmask = jnp.asarray(mask)
    asm = js.assembler
    U0 = js.zero_state()
    U1 = jnp.where(jmask, jnp.asarray(jbc.values_at(0.001)), U0)
    jacs = asm.element_jacobians(U1, U0, dtype=jnp.float32)
    dr, dc = jax_ruiz_scales(asm.blocks, jacs, jmask, asm.ndof, sweeps=4)
    jf = [np.array(A) for A in jax_scale(asm.blocks, jacs, dr, dc)]
    block_dofs = [b.dofs.numpy() for b in ts.assembler.blocks]
    jpat = jb.build_banded_pattern(block_dofs, asm.ndof)
    tpat = tb.build_banded_pattern(block_dofs, asm.ndof)
    return js, ts, tbc, mask, jf, block_dofs, jpat, tpat


@pytest.fixture(scope="module")
def cdb(setup):
    """C/D/B from vasp_tpu's assembly (numpy f32)."""
    _, _, _, mask, jf, block_dofs, jpat, _ = setup
    plan = jb.build_banded_assembly_plan(block_dofs, jpat, mask)
    diag = jnp.asarray(jb.identity_diag_slots(jpat, mask))
    return tuple(np.array(M) for M in jb.assemble_banded_planned(
        [jnp.asarray(A) for A in jf], plan, jpat, diag))


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_pattern_and_plan_match_vasp_tpu(setup):
    _, _, _, mask, _, block_dofs, jpat, tpat = setup
    assert tpat.nb >= 2  # exercises the off-diagonal recursion
    np.testing.assert_array_equal(tpat.perm, jpat.perm)
    np.testing.assert_array_equal(tpat.iperm, jpat.iperm)
    assert (tpat.c, tpat.nb, tpat.ndof) == (jpat.c, jpat.nb, jpat.ndof)
    np.testing.assert_array_equal(tb.identity_diag_slots(tpat, mask),
                                  jb.identity_diag_slots(jpat, mask))
    jplan = jb.build_banded_assembly_plan(block_dofs, jpat, mask)
    tplan = tb.build_banded_assembly_plan(block_dofs, tpat, mask)
    for jper, tper in zip(jplan, tplan):
        for jp, tp in zip(jper, tper):
            for key in ("src", "dst", "udst", "starts"):
                assert tp[key].dtype == np.int32
                np.testing.assert_array_equal(tp[key], np.asarray(jp[key]))


def test_rcm_is_the_native_ordering(setup):
    """The port's own C++ RCM builds on this host and reproduces
    vasp_tpu's permutation (scipy's RCM is only the fallback)."""
    from vasp_tpu_torch import native

    *_, block_dofs, jpat, _ = setup
    assert native._library() is not None
    import scipy.sparse as sp

    rows = np.concatenate([np.repeat(d, 64, axis=1).ravel()
                           for d in block_dofs])
    cols = np.concatenate([np.tile(d, (1, 64)).ravel() for d in block_dofs])
    adj = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                        shape=(jpat.ndof, jpat.ndof)).tocsr()
    adj = adj + adj.T
    np.testing.assert_array_equal(
        native.rcm_order(adj.indptr, adj.indices, jpat.ndof), jpat.perm)


def test_assembly_matches_vasp_tpu(setup, cdb):
    _, _, _, mask, jf, block_dofs, _, tpat = setup
    plans = tb.plans_to_device(
        tb.build_banded_assembly_plan(block_dofs, tpat, mask), "cpu")
    diag = torch.as_tensor(tb.identity_diag_slots(tpat, mask))
    got = tb.assemble_banded_planned([torch.as_tensor(A) for A in jf],
                                     plans, tpat, diag)
    for g, want in zip(got, cdb):
        assert g.dtype == torch.float32 and g.shape == want.shape
        np.testing.assert_array_equal(g.numpy(), want)


def test_factors_and_probe_match_vasp_tpu(cdb):
    js_out = jb.factorize_banded(*(jnp.asarray(M) for M in cdb))
    t_out = tb.factorize_banded(*(torch.as_tensor(M) for M in cdb))
    for j, t in zip(js_out[:3], t_out[:3]):
        assert t.dtype == torch.float32
        assert _rel(t.numpy(), np.asarray(j)) <= 2e-3
    # the probe measures solve quality: both small, same order
    jrel, trel = float(js_out[3]), t_out[3]
    assert jrel < 1e-1 and trel < 1e-1
    assert 0.1 < trel / jrel < 10.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_apply_matches_vasp_tpu(setup, cdb, dtype):
    *_, mask, _, _, jpat, tpat = setup
    Sinv, H, G, _ = jb.factorize_banded(*(jnp.asarray(M) for M in cdb))
    r = np.where(mask, 0.0, np.random.default_rng(1).standard_normal(
        tpat.ndof)).astype(dtype)
    want = np.asarray(jb.make_banded_apply(jpat)(Sinv, H, G, jnp.asarray(r)))
    got = tb.make_banded_apply(tpat, "cpu")(
        *(torch.as_tensor(np.array(M)) for M in (Sinv, H, G)),
        torch.as_tensor(r))
    assert got.dtype == torch.as_tensor(r).dtype
    assert _rel(got.numpy().astype(np.float64), want.astype(np.float64)) \
        <= 1e-4


def test_banded_is_direct_solve_on_the_port(setup):
    """test_banded.py::test_banded_is_direct_solve with the port's own
    Jacobians, scales, assembly, factors and apply: M inverts the scaled
    Jacobian to f32 accuracy (forward error against an f64 direct solve)."""
    import scipy.sparse.linalg as spla

    _, ts, tbc, mask, _, block_dofs, _, pat = setup
    asm = ts.assembler
    tmask = torch.as_tensor(mask)
    U0 = ts.zero_state()
    U1 = tbc.apply(U0, 0.001)
    jacs = asm.element_jacobians(U1, U0, dtype=torch.float32)
    dr, dc = ruiz_scales(asm.blocks, jacs, tmask, asm.ndof, sweeps=4)
    jf = scale_element_jacobians(asm.blocks, jacs, dr, dc)
    plans = tb.plans_to_device(
        tb.build_banded_assembly_plan(block_dofs, pat, mask), "cpu")
    diag = torch.as_tensor(tb.identity_diag_slots(pat, mask))
    Sinv, H, G, _ = tb.factorize_banded(
        *tb.assemble_banded_planned(jf, plans, pat, diag))
    r = np.where(mask, 0.0, np.random.default_rng(1).standard_normal(
        asm.ndof))
    z = tb.make_banded_apply(pat, "cpu")(Sinv, H, G,
                                         torch.as_tensor(r)).numpy()
    A_s = asm.to_csr([A.double() for A in jf], bc_mask=mask).tocsc()
    x_ref = spla.splu(A_s).solve(r)
    assert np.linalg.norm(z - x_ref) / np.linalg.norm(x_ref) < 0.1


def test_f64_factors_match_vasp_tpu(cdb):
    """K11, the escalation tier's float64 recursion with float32 factor
    storage, against vasp_tpu's on the same C/D/B: within 1e-6 relative
    (measured 6.9e-11 on Sinv, 4.7e-8 on H, 8.3e-9 on G; both store the
    float32 rounding of float64 Schur inverses that differ only by
    vasp_tpu's polished f32-seeded inverse against the LU, and H and G
    are float32 products in other orders). Its factors solve no worse
    than the float32 recursion's (probe measured 3.3e-3 against 1.1e-2)."""
    js_out = jb.factorize_banded_f64(*(jnp.asarray(M) for M in cdb))
    tcdb = [torch.as_tensor(M) for M in cdb]
    t_out = tb.factorize_banded_f64(*tcdb)
    for j, t in zip(js_out, t_out):
        assert t.dtype == torch.float32
        assert _rel(t.numpy(), np.asarray(j)) <= 1e-6
    rel64 = tb.probe_rel(*tcdb, *t_out)
    assert rel64 <= tb.factorize_banded(*tcdb)[3]
