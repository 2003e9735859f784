"""The sharded Newton-Krylov path (parallel/banded_shard.py, K21) on 4 gloo
ranks against vasp_tpu on tests/test_banded_shard.py's tube (Robin facets
on), vasp_tpu's ShardedBandedStepper on 4 of the virtual CPU devices of
tests/conftest.py (build_device_mesh(4, "dof")).

One port world (4 processes) and one vasp_tpu run serve the module. The
rank-level stages are fed vasp_tpu's own inputs where the two packages'
would differ (its float32 element Jacobians of the first rebuild: the
port rounds float64 Jacobians once, vasp_tpu runs jacfwd in float32), and
each is held against the single-device function it shards. Tolerances,
each with its reason:
- the residual after halo_add against vasp_tpu's residual: 1e-12 relative
  (float64 sums in another order);
- Ruiz scales against vasp_tpu's ruiz_scales on the same Jacobians: 1e-6
  relative (XLA's CPU float32 sqrt is not correctly rounded,
  tests/test_torch_scaling.py);
- the merged C/D/B against vasp_tpu's assembly of the whole padded system:
  1e-6 relative (those scales, and the halo row summed on the left rank
  before it is added);
- the sharded factors against the port's single-device factorize_banded
  on the same padded system: 2e-3 relative, tests/test_torch_banded.py's
  bound (the same recursion; its carry crosses ranks exactly);
- the chain and Thomas applies against the single-device block-Thomas
  solve: K6's rule, the distance to the float64 scans at most twice the
  float32 single-device solve's plus 1e-6;
- one step and the second (which reuses the factors): the Newton count of
  vasp_tpu's sharded stepper, U within 3e-5 of its scale (the GMRES
  path's rule, tests/test_torch_driver_gmres.py).
The file mirrors vasp_tpu's three other sharded cases on the port itself
(the reuse, test_sharded_hybrid_delta_endgame and test_sharded_ladder_tiers
with their bounds), and its chain-against-Thomas check.

SPIKE (algo="spike", K21f), in the same world and the same vasp_tpu run:
- a seeded, diagonally dominant block-tridiagonal system (_torch_dist's
  benign_system) factorized and solved by both packages at 4 ranks (the
  port with 0 and 2 refinement passes, vasp_tpu with none): within 1e-5
  of each other and of the float64 direct solve (vasp_tpu calls its SPIKE
  exact to 1e-7 on such systems);
- a step on the tube at TIGHT with 2 refinement passes: converged to
  1e-9, vasp_tpu's spike stepper's Newton count at N = 4, U within 2e-6
  of the scale of the port's Thomas step (vasp_tpu's
  test_parallel_solve_variants_match_thomas bars);
- the factors' probe with 2 passes below the probe with none, in both
  packages;
- a bf16-factor step at the hybrid case's options (atol 1e-6) and the
  float64 factor tier's rebuild with its probe under 1e-2
  (test_sharded_ladder_tiers' bar)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_dist import (
    BENIGN,
    TIGHT,
    banded_shard_world,
    benign_system,
    start_world,
    tube_system,
)
from _torch_small_fsi import random_state, same_rcm, torch_threads
from vasp_tpu_torch.fem import banded as tb
from vasp_tpu_torch.kernels import banded as kb

_threads = torch_threads(2)
N = 4


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _facet_order(jdofs, tdofs):
    """Index of each port facet row among vasp_tpu's rows (the two list
    the same facets in other orders)."""
    where = {tuple(row): i for i, row in enumerate(jdofs)}
    return np.array([where[tuple(row)] for row in tdofs])


def _jax_spike_probe(st, refine):
    """vasp_tpu's probe of a SPIKE stepper's factors (its probe_rel,
    banded_shard.py:1010-1028) through its spike apply with `refine`
    passes, under shard_map."""
    import jax

    from jax.sharding import PartitionSpec as P
    from vasp_tpu.parallel.banded_shard import (
        _left_perm,
        _right_perm,
        bgemv,
        make_sharded_spike_apply,
        shard_map,
    )

    plan, axis = st.plan, st.axis
    m, c, n = plan.nb_loc, plan.c, plan.n
    apply = make_sharded_spike_apply(plan, axis, refine)

    def probe(F):
        b = jnp.where(jnp.arange(plan.span) % 2 == 0, 1.0, -1.0
                      ).astype(jnp.float32)
        x = apply(F, b).astype(jnp.float32).reshape(m, c)
        xprev = jax.lax.ppermute(x[m - 1], axis, _right_perm(n))
        xnext = jax.lax.ppermute(x[0], axis, _left_perm(n))
        xm = jnp.concatenate([xprev[None], x, xnext[None]], axis=0)
        y = (bgemv(F["Db"], x) + bgemv(F["Cb"], xm[:m])
             + bgemv(F["Bb"], xm[2:]))
        r = (y - b.reshape(m, c)).reshape(-1)
        return jnp.sqrt(jax.lax.psum(jnp.dot(r, r), axis)
                        / jax.lax.psum(jnp.dot(b, b), axis))

    F = st._factors[2]
    return float(jax.jit(shard_map(
        probe, mesh=st.mesh, in_specs=(jax.tree.map(lambda _: P(axis), F),),
        out_specs=P(), check_vma=False))(F))


def _jax_spike_benign():
    """vasp_tpu's SPIKE factorization and apply (refine 0) of the benign
    system at N devices, as scripts/bench_spike.py:77-90 runs its apply."""
    import jax

    from jax.sharding import PartitionSpec as P
    from vasp_tpu.parallel.banded_shard import (
        ShardPlan,
        _sharded_factorize_spike,
        make_sharded_spike_apply,
        shard_map,
    )
    from vasp_tpu.parallel.shard import build_device_mesh

    *CDB, rhs = benign_system()
    m, c = BENIGN["nb_loc"], BENIGN["c"]
    nd = N * m * c
    plan = ShardPlan(c=c, nb_loc=m, span=m * c, n=N, ndof=nd, npad=nd,
                     perm=np.arange(nd), iperm=np.arange(nd))

    def solve(Cl, Dl, Bl, rl):
        F = _sharded_factorize_spike(Cl, Dl, Bl, "dof", plan)
        return make_sharded_spike_apply(plan, "dof", 0)(F, rl)

    return np.asarray(jax.jit(shard_map(
        solve, mesh=build_device_mesh(N, "dof"), in_specs=(P("dof"),) * 4,
        out_specs=P("dof"), check_vma=False))(
            *map(jnp.asarray, CDB), jnp.asarray(rhs)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(vasp_tpu's results, the port's ranks' results, the port's system)."""
    same_rcm()
    from vasp_tpu.fem import banded as jb
    from vasp_tpu.fem.dirichlet import DirichletBC
    from vasp_tpu.fem.scaling import ruiz_scales, scale_element_jacobians
    from vasp_tpu.fem.timestepper import StepOptions
    from vasp_tpu.mesh.generate import fsi_tube_mesh
    from vasp_tpu.parallel.banded_shard import (
        ShardedBandedStepper,
        build_shard_plan,
    )
    from vasp_tpu.parallel.shard import build_device_mesh
    from vasp_tpu.run.system import FSISystem

    js, jbc, jload = tube_system(DirichletBC=DirichletBC, FSISystem=FSISystem,
                                 fsi_tube_mesh=fsi_tube_mesh)
    ts = tube_system()[0]
    asm = js.assembler
    mask = np.asarray(jbc.mask)
    jmask = jnp.asarray(mask)
    space = ts.space
    U, U0 = random_state(space, 0), random_state(space, 1)
    jout = dict(R=np.asarray(asm.residual(jnp.asarray(U), jnp.asarray(U0))))
    Z = js.zero_state()
    bcv = jnp.asarray(jbc.values_at(0.001))
    U1 = jnp.where(jmask, bcv, Z)
    jacs = asm.element_jacobians(U1, Z, dtype=jnp.float32)
    dr, dc = ruiz_scales(asm.blocks, jacs, jmask, asm.ndof, sweeps=4)
    jout.update(dr=np.asarray(dr), dc=np.asarray(dc))
    block_dofs = [b.dofs.numpy() for b in ts.assembler.blocks]
    plan = build_shard_plan(block_dofs, asm.ndof, N)
    pat = jb.BandedPattern(perm=plan.perm, iperm=plan.iperm, c=plan.c,
                           nb=N * plan.nb_loc, ndof=asm.ndof)
    jf = scale_element_jacobians(asm.blocks, jacs, dr, dc)
    jout["CDB"] = [np.array(M) for M in jb.assemble_banded_planned(
        jf, jb.build_banded_assembly_plan(
            [np.asarray(b.dofs) for b in asm.blocks], pat, mask),
        pat, jnp.asarray(jb.identity_diag_slots(pat, mask)))]
    inputs = dict(U=U, U0=U0, r=np.where(mask, 0.0, np.random.default_rng(
        2).standard_normal(asm.ndof)))
    # the delta's anchor: U less a step at 1e-3 of the state's scales
    inputs["A"] = U - 1e-3 * random_state(space, 3)
    jout.update(r=inputs["r"], U=U, U0=U0, A=inputs["A"])
    jdofs = [np.asarray(b.dofs) for b in asm.blocks]
    for i, A in enumerate(jacs):
        A = np.asarray(A)
        if jdofs[i].shape[1] == 36:  # the facets, in the port's order
            A = A[_facet_order(jdofs[i], block_dofs[i])]
        inputs[f"jac{i}"] = A
    path = tmp_path_factory.mktemp("banded_shard_inputs") / "inputs.npz"
    np.savez(path, **inputs)
    # the port's ranks run while vasp_tpu's steppers do
    ranks = start_world(N, banded_shard_world, path.parent, str(path))

    st = ShardedBandedStepper(js, jbc, StepOptions(**TIGHT),
                              mesh=build_device_mesh(N, "dof"),
                              recompute_tstep=20)
    Uj1, info1 = st.step(Z, bcv, jload, tstep=1)
    Uj2, info2 = st.step(Uj1, bcv, 1.2 * jload, tstep=2)
    jout.update(U1=np.asarray(Uj1), info1=info1, U2=np.asarray(Uj2),
                info2=info2, rel=st._last_rel)
    # SPIKE at N ranks with VASP_SPIKE_REFINE's default, 2 passes
    sp = ShardedBandedStepper(js, jbc, StepOptions(**TIGHT),
                              mesh=build_device_mesh(N, "dof"),
                              recompute_tstep=20, algo="spike")
    assert sp.spike_refine == 2
    Us, infos = sp.step(Z, bcv, jload, tstep=1)
    jout.update(U_spike=np.asarray(Us), info_spike=infos,
                rel_spike2=sp._last_rel, rel_spike0=_jax_spike_probe(sp, 0),
                x_benign=_jax_spike_benign())
    return jout, ranks(), ts


def _gathered(ranks, key):
    return torch.cat([r[key] for r in ranks])


def test_world_shape(world):
    _, ranks, ts = world
    assert [r["rank"] for r in ranks] == list(range(N))
    assert all(r["n"] == N for r in ranks)


def test_residual_after_halo_add(world):
    jout, ranks, ts = world
    iperm = torch.as_tensor(tb.build_banded_pattern(
        [b.dofs.numpy() for b in ts.assembler.blocks], ts.space.ndof).iperm)
    R = _gathered(ranks, "R")
    assert R.dtype == torch.float64
    assert _rel(R[iperm].numpy(), jout["R"]) <= 1e-12
    padding = torch.ones(R.shape[0], dtype=torch.bool)
    padding[iperm] = False
    assert torch.all(R[padding] == 0.0)


def test_ruiz_scales(world):
    jout, ranks, ts = world
    iperm = torch.as_tensor(tb.build_banded_pattern(
        [b.dofs.numpy() for b in ts.assembler.blocks], ts.space.ndof).iperm)
    for key in ("dr", "dc"):
        d = _gathered(ranks, key)
        assert d.dtype == torch.float32
        assert _rel(d[iperm].numpy(), jout[key]) <= 1e-6


def test_merged_cdb(world):
    jout, ranks, _ = world
    for key, want in zip("CDB", jout["CDB"]):
        got = _gathered(ranks, key)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 1e-6


@pytest.fixture(scope="module")
def single(world):
    """The port's single-device factors of the ranks' merged C/D/B."""
    _, ranks, _ = world
    return tb.factorize_banded(*(_gathered(ranks, k) for k in "CDB"))


def test_factors_match_single_device(world, single):
    jout, ranks, _ = world
    for key, want in zip(("Sinv", "H", "G"), single[:3]):
        assert _rel(_gathered(ranks, key).numpy(), want.numpy()) <= 2e-3
    # the probes measure solve quality: small, and of one order with the
    # single-device one and vasp_tpu's sharded rebuild's
    for algo in ("chain", "thomas"):
        p = ranks[0][f"probe_{algo}"]
        assert all(r[f"probe_{algo}"] == p for r in ranks)
        assert p < 1e-2
        assert 0.1 < p / single[3] < 10.0
        assert 0.1 < p / jout["rel"] < 10.0


@pytest.mark.parametrize("algo", ["chain", "thomas"])
def test_apply_matches_single_device(world, algo):
    """On the ranks' factors, gathered (the single-device factors of the
    fixture `single` differ from them by the thread counts' matmul
    rounding, amplified by the Schur blocks' conditioning)."""
    jout, ranks, ts = world
    Sinv, H, G = (_gathered(ranks, k) for k in ("Sinv", "H", "G"))
    nb, c, _ = Sinv.shape
    perm = tb.build_banded_pattern(
        [b.dofs.numpy() for b in ts.assembler.blocks], ts.space.ndof).perm
    rb = torch.zeros(nb * c, dtype=torch.float32)
    rb[:len(perm)] = torch.as_tensor(jout["r"][perm], dtype=torch.float32)
    rb = rb.view(nb, c)
    x = _gathered(ranks, f"x_{algo}")
    assert x.dtype == torch.float64  # the apply returns r's dtype
    x64 = kb.solve_blocks_plain(Sinv.double(), H.double(), G.double(),
                                rb.double()).reshape(-1)
    x1 = kb.solve_blocks_plain(Sinv, H, G, rb).reshape(-1)
    d1 = _rel(x1.double().numpy(), x64.numpy())
    ds = _rel(x.numpy(), x64.numpy())
    assert ds <= 2 * d1 + 1e-6, (ds, d1)


def _converged(info, tol):
    res = float(info["residual"])
    return res < tol * max(1.0, float(info["r0"])) or res < tol


@pytest.mark.parametrize("step", [1, 2])
def test_steps_match_vasp_tpu(world, step):
    """Step 1 rebuilds, step 2 (1.2x the load) reuses the factors: the same
    Newton counts as vasp_tpu's sharded stepper, U within 3e-5 of its
    scale, every rank holding the same full U."""
    jout, ranks, _ = world
    want, jinfo = jout[f"U{step}"], jout[f"info{step}"]
    for r in ranks:
        info = r[f"info{step}"]
        assert _converged(info, 1e-9)
        assert info["iterations"] == int(jinfo["iterations"])
        assert torch.equal(r[f"U{step}"], ranks[0][f"U{step}"])
        assert r["last_rebuild"] == 1
    got = ranks[0][f"U{step}"].numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 3e-5 * scale


def test_thomas_matches_chain(world):
    """vasp_tpu's test_parallel_solve_variants_match_thomas on the port:
    the same factors' probe, the same state (2e-6 of its scale)."""
    _, ranks, _ = world
    r = ranks[0]
    assert r["rel_thomas"] < 1e-2 and r["rel_chain"] < 1e-2
    assert _converged(r["info_thomas"], 1e-9)
    a, b = r["U_thomas"].numpy(), r["U1"].numpy()
    assert np.abs(a - b).max() <= 2e-6 * np.abs(a).max() + 1e-14
    assert r["info1"]["iterations"] <= 2 * max(1, r["info_thomas"][
        "iterations"])


def test_hybrid_delta_endgame(world):
    """vasp_tpu's test_sharded_hybrid_delta_endgame on the port: f32
    coarse residuals with the Taylor-delta endgame and raw float64
    residuals reach the same state (2e-4 of its scale), both within atol
    1e-6; and the endgame's sharded delta (K13 on the rank's elements,
    halo_add) is the single-device residual_delta, 1e-12 relative (the
    same float32 element series, summed in float64 in another order)."""
    jout, ranks, ts = world
    r = ranks[0]
    assert r["info_hybrid"]["residual"] <= 1e-6
    assert r["info_raw"]["residual"] <= 1e-6
    a, b = r["U_raw"].numpy(), r["U_hybrid"].numpy()
    assert np.abs(a - b).max() <= 2e-4 * np.abs(a).max()
    iperm = torch.as_tensor(tb.build_banded_pattern(
        [b.dofs.numpy() for b in ts.assembler.blocks], ts.space.ndof).iperm)
    want = ts.assembler.residual_delta(
        *(torch.as_tensor(jout[k]) for k in ("U", "A", "U0")))
    assert _rel(_gathered(ranks, "delta")[iperm].numpy(), want.numpy()) \
        <= 1e-12


def test_ladder_tiers(world):
    """vasp_tpu's test_sharded_ladder_tiers on the port: the float64
    factor rebuild (K11's recursion phase by phase) certified by its
    probe, and the float64 direction tier converging on those factors."""
    _, ranks, _ = world
    for r in ranks:
        assert r["rel_f64"] < 1e-2
        assert _converged(r["info_exact"], 1e-9)
        assert torch.isfinite(r["U_exact"]).all()


def _direct(C, D, B, rhs):
    """The float64 dense solve of the block-tridiagonal system."""
    nb, c, _ = D.shape
    A = np.zeros((nb * c, nb * c))
    for k in range(nb):
        rows = slice(k * c, (k + 1) * c)
        A[rows, rows] = D[k]
        if k:
            A[rows, (k - 1) * c:k * c] = C[k]
        if k < nb - 1:
            A[rows, (k + 1) * c:(k + 2) * c] = B[k]
    return np.linalg.solve(A, rhs)


def test_spike_benign_system(world):
    """SPIKE on a seeded, diagonally dominant block-tridiagonal system, the
    same C/D/B in both packages at 4 ranks: within 1e-5 of each other and
    of the float64 direct solve (vasp_tpu's docstring: exact to 1e-7 on
    such systems); the port's refined apply too."""
    jout, ranks, _ = world
    x64 = _direct(*benign_system())
    xj = jout["x_benign"]
    assert _rel(xj, x64) <= 1e-5
    for refine in (0, 2):
        x = _gathered(ranks, f"x_benign{refine}").numpy()
        assert x.shape == x64.shape == (N * BENIGN["nb_loc"] * BENIGN["c"],)
        assert _rel(x, x64) <= 1e-5
        assert _rel(x, xj) <= 1e-5


def test_spike_step_matches_vasp_tpu(world):
    """vasp_tpu's spike case of test_parallel_solve_variants_match_thomas on
    the port: a SPIKE step at TIGHT (2 refinement passes) converges to
    1e-9, with vasp_tpu's spike stepper's Newton count at N = 4, and its U
    is within 2e-6 of the scale of the port's Thomas step."""
    jout, ranks, _ = world
    for r in ranks:
        info = r["info_spike"]
        assert _converged(info, 1e-9)
        assert info["iterations"] == int(jout["info_spike"]["iterations"])
        assert torch.equal(r["U_spike"], ranks[0]["U_spike"])
    a, b = ranks[0]["U_thomas"].numpy(), ranks[0]["U_spike"].numpy()
    assert np.abs(a - b).max() <= 2e-6 * np.abs(a).max() + 1e-14


def test_spike_refinement_contracts_the_probe(world):
    """The SPIKE factors' probe with 2 refinement passes is below the probe
    with none, in both packages (vasp_tpu measured 5.4 -> 1.26 -> 0.14 on
    its tube fixture, banded_shard.py:575-585), every rank reading the
    same."""
    jout, ranks, _ = world
    assert jout["rel_spike2"] < jout["rel_spike0"]
    for key in ("rel_spike0", "rel_spike2"):
        assert all(r[key] == ranks[0][key] for r in ranks)
    assert ranks[0]["rel_spike2"] < ranks[0]["rel_spike0"]


def test_spike_ladder_tiers(world):
    """test_ladder_tiers on SPIKE: a step with bf16 factors at
    test_hybrid_delta_endgame's options converges to their atol 1e-6, and
    the float64 factor tier's rebuild (K11's recursion in each rank's local
    scan, the float64 reduced inverse) is certified by its probe."""
    _, ranks, _ = world
    for r in ranks:
        assert r["spike_bf16_dtype"] == torch.bfloat16
        assert r["info_spike_bf16"]["residual"] <= 1e-6
        assert torch.isfinite(r["U_spike_bf16"]).all()
        assert r["rel_spike_f64"] < 1e-2
