"""Parity of the port's banded factor layouts with vasp_tpu.fem.banded on
the C/D/B of the small FSI tube's first 3 layers (vasp_tpu's assembly,
float32): the bf16 factorization, the Sinv-only scans, the hybrid H/G,
the K6 storage instances and the K12 folded apply (plain versions), and
the layout rule against vasp_tpu's mapping.

Tolerances, each with its reason:
- bf16 factors: one bf16 ulp, 2^-8 relative in norm. Both round float32
  values to nearest even, and those differ only as the two float32 scans
  do (measured 2.4e-4 on Sinv, 4.1e-4 on H, 1.4e-4 on G);
- the hybrid H/G from the same float32 Sinv: one bf16 ulp (float32
  products in another order flip a few roundings; measured 1.1e-6);
- float32 Sinv of the Sinv-only scan: 1e-4 relative (another LU and other
  matmul orders, amplified by the Schur blocks' conditioning; measured
  2.0e-5 here, 6.0e-5 on the 5-layer tube); its float64-recursion twin
  1e-6 (measured 1.7e-12);
- the applies on identical factors (bf16 tensors made from one float32
  array): 1e-5 relative. Both packages scan in float32 with dot products
  in other orders through 2 nb - 1 (K12: 4 nb - 3) steps; each lies
  within 8e-7 of the same scans in float64 and the two within 1.3e-6 of
  each other (on the 5-layer tube, whose factors amplify more, 1.0e-4)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_small_fsi import SHORT_MESH, build_pair, torch_threads
from vasp_tpu.fem import banded as jb
from vasp_tpu.fem.timestepper import IterativeStepper as JaxStepper
from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
from vasp_tpu_torch.fem import banded as tb
from vasp_tpu_torch.fem.scaling import ruiz_scales, scale_element_jacobians

_threads = torch_threads(2)
ULP_BF16 = 2.0 ** -8
TOL_APPLY = 1e-5


@pytest.fixture(scope="module")
def setup():
    """Both packages' systems, the port's C/D/B (numpy float32) at the first
    step of the tube (its assembly equals vasp_tpu's on the same Jacobians,
    tests/test_torch_banded.py; here both packages factor the same C/D/B),
    and both patterns."""
    (js, jbc), (ts, tbc) = build_pair(SHORT_MESH)
    mask = tbc.mask
    asm = ts.assembler
    U0 = ts.zero_state()
    U1 = tbc.apply(U0, 0.001)
    jacs = asm.element_jacobians(U1, U0, dtype=torch.float32)
    dr, dc = ruiz_scales(asm.blocks, jacs, torch.as_tensor(mask), asm.ndof,
                         sweeps=4)
    jf = scale_element_jacobians(asm.blocks, jacs, dr, dc)
    block_dofs = [b.dofs.numpy() for b in asm.blocks]
    jpat = jb.build_banded_pattern(block_dofs, asm.ndof)
    tpat = tb.build_banded_pattern(block_dofs, asm.ndof)
    plans = tb.plans_to_device(
        tb.build_banded_assembly_plan(block_dofs, tpat, mask), "cpu")
    diag = torch.as_tensor(tb.identity_diag_slots(tpat, mask))
    cdb = tuple(M.numpy() for M in tb.assemble_banded_planned(
        jf, plans, tpat, diag))
    return js, jbc, ts, mask, jpat, tpat, cdb


def _rel(a, b):
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _f32(x):
    """A float32 numpy copy of a jax or torch array (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(M, bf16):
    """(torch, jax) arrays of one numpy float32 array, both rounded to the
    same bf16 values where bf16 (torch rounds, jax gets its bits)."""
    t = torch.as_tensor(M)
    if not bf16:
        return t, jnp.asarray(M)
    t = t.to(torch.bfloat16)
    return t, jax.lax.bitcast_convert_type(
        jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)


def test_bf16_factors_and_probe_match_vasp_tpu(setup):
    cdb = setup[-1]
    j_out = jb.factorize_banded(*(jnp.asarray(M) for M in cdb),
                                factor_dtype=jnp.bfloat16)
    t_out = tb.factorize_banded(*(torch.as_tensor(M) for M in cdb),
                                torch.bfloat16)
    for j, t in zip(j_out[:3], t_out[:3]):
        assert t.dtype == torch.bfloat16
        assert _rel(_f32(t), _f32(j)) <= ULP_BF16
    # the probe on the stored bf16 factors: the same order (measured 0.757
    # and 0.745; 53.6 and 52.4 on the 5-layer tube)
    jrel, trel = float(j_out[3]), t_out[3]
    assert 0.5 < trel / jrel < 2.0


@pytest.mark.parametrize("storage,tol", [
    ("bf16", ULP_BF16), ("f32", 1e-4), ("f64", 1e-6)])
def test_sinv_only_scans_match_vasp_tpu(setup, storage, tol):
    """factorize_banded_lowmem (bf16), factorize_banded_sinv32 and
    factorize_banded_f64_lowmem against the port's schur_scan in bf16 and
    float32 and schur_scan_f64."""
    cdb = setup[-1]
    jcdb = [jnp.asarray(M) for M in cdb]
    tcdb = [torch.as_tensor(M) for M in cdb]
    if storage == "bf16":
        want, got = (jb.factorize_banded_lowmem(*jcdb),
                     tb.schur_scan(*tcdb, torch.bfloat16))
    elif storage == "f32":
        want, got = jb.factorize_banded_sinv32(*jcdb), tb.schur_scan(*tcdb)
    else:
        want, got = (jb.factorize_banded_f64_lowmem(*jcdb),
                     tb.schur_scan_f64(*tcdb))
    assert got.dtype == (torch.bfloat16 if storage == "bf16"
                         else torch.float32)
    assert _rel(_f32(got), _f32(want)) <= tol


def test_hybrid_hg_match_vasp_tpu(setup):
    """H = bf16(Sinv C) and G = bf16(Sinv B) from one float32 Sinv, formed in
    chunks of blocks, against vasp_tpu's hybrid rebuild products."""
    cdb = setup[-1]
    Sinv = np.asarray(jb.factorize_banded_sinv32(*(jnp.asarray(M)
                                                  for M in cdb)))
    for X in (cdb[0], cdb[2]):
        want = jnp.einsum("kab,kbc->kac", jnp.asarray(Sinv), jnp.asarray(X),
                          preferred_element_type=jnp.float32
                          ).astype(jnp.bfloat16)
        got = tb.sinv_times(torch.as_tensor(Sinv), torch.as_tensor(X),
                            torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert _rel(_f32(got), _f32(want)) <= ULP_BF16


@pytest.mark.parametrize("instance", ["hybrid", "bf16", "lowmem_bf16",
                                      "lowmem_f32"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_applies_match_vasp_tpu(setup, instance, dtype):
    """The plain K6 storage instances against make_banded_apply and the
    plain K12 against make_banded_apply_lowmem, on identical factors."""
    _, _, _, mask, jpat, tpat, cdb = setup
    Sinv, H, G, _ = jb.factorize_banded(*(jnp.asarray(M) for M in cdb))
    Sinv, H, G = (np.asarray(M) for M in (Sinv, H, G))
    if instance in ("hybrid", "bf16"):
        F = [_both(Sinv, instance == "bf16"), _both(H, True), _both(G, True)]
        japply = jb.make_banded_apply(jpat)
        tapply = tb.make_banded_apply(tpat, "cpu")
    else:
        F = [_both(Sinv, instance == "lowmem_bf16"), _both(cdb[0], True),
             _both(cdb[2], True)]
        japply = jb.make_banded_apply_lowmem(jpat)
        tapply = tb.make_banded_apply_lowmem(tpat, "cpu")
    r = np.where(mask, 0.0, np.random.default_rng(1).standard_normal(
        tpat.ndof)).astype(dtype)
    want = np.asarray(japply(*(j for _, j in F), jnp.asarray(r)))
    got = tapply(*(t for t, _ in F), torch.as_tensor(r))
    assert got.dtype == torch.as_tensor(r).dtype
    assert _rel(got.numpy(), want) <= TOL_APPLY


# vasp_tpu's low-memory mode per banded_factor_dtype
# (vasp_tpu/fem/timestepper.py:431-434)
DTYPES = [None, "hybrid", "bf16", "f32"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fits", [True, False], ids=["full_fits",
                                                     "full_does_not_fit"])
def test_layout_matches_vasp_tpu_mapping(setup, monkeypatch, dtype, fits):
    """On each side of the memory line (the free bytes at the full layout's
    peak, or one byte short of it) banded_layout picks vasp_tpu's layout:
    its full one, or the low-memory mode vasp_tpu takes under
    VASP_FORCE_LOWMEM."""
    js, jbc, ts, *_ = setup
    tpat = setup[5]
    sizes = [tuple(b.dofs.shape) for b in ts.assembler.blocks]
    full = tb.banded_layout(tpat, sizes, float("inf"), dtype).full_bytes
    got = tb.banded_layout(tpat, sizes, full if fits else full - 1, dtype)
    if not fits:
        monkeypatch.setenv("VASP_FORCE_LOWMEM", "1")
    jst = JaxStepper(js, jbc, JaxOptions(banded_factor_dtype=dtype))
    assert jst._banded_lowmem == (not fits)
    want = "full" if fits else jst._lowmem_mode
    assert got.layout == want
    assert got.full_bytes == full and got.bytes <= full


def test_layout_refusal_and_f64_tier(setup):
    """Where the full layout and the one vasp_tpu's mapping falls back to
    both do not fit, banded_layout raises, naming the bytes (None goes no
    further than the hybrid, as in vasp_tpu). The float64 factor tier
    counts the float32 factors its scan stores whatever the layout's
    storage: under the bf16 full layout the float32 full one's peak, under
    the bf16 Sinv-only layout the float32 Sinv-only one's."""
    ts, tpat = setup[2], setup[5]
    sizes = [tuple(b.dofs.shape) for b in ts.assembler.blocks]

    def lay(free, dtype):
        return tb.banded_layout(tpat, sizes, free, dtype)

    full = lay(float("inf"), None)
    assert full.layout == "full" and full.f64_fits
    assert full.f64_bytes > full.bytes
    hybrid = lay(full.bytes - 1, None)
    assert hybrid.layout == "hybrid" and hybrid.bytes < full.bytes
    for dtype in (None, "hybrid"):
        with pytest.raises(MemoryError, match="GiB in the hybrid layout"):
            lay(hybrid.bytes - 1, dtype)
    full16 = lay(float("inf"), "bf16")
    sinv16 = lay(full16.bytes - 1, "bf16")
    sinv32 = lay(full.bytes - 1, "f32")
    assert (full16.layout, sinv16.layout, sinv32.layout) == (
        "full", "bf16", "f32")
    assert full16.f64_bytes == full.f64_bytes
    assert sinv16.f64_bytes == sinv32.f64_bytes == hybrid.f64_bytes
    assert sinv16.f64_bytes > sinv16.bytes and not sinv16.f64_fits
    assert lay(full.f64_bytes - 1, "bf16").f64_fits is False
    with pytest.raises(MemoryError, match="GiB in the bf16 layout"):
        lay(sinv16.bytes - 1, "bf16")
    assert tb.device_free_bytes("cpu") > 0
