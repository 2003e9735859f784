"""Worlds of gloo ranks for the port's sharded-path tests.

``run_world`` starts n processes (spawn, one FileStore under the test's
tmp_path, so that pytest-xdist workers never share a rendezvous), each at
one torch and one BLAS thread, runs a module-level function of this module
in every rank and returns the ranks' results in rank order. The rank
functions build the port's systems themselves: this module imports
neither jax nor vasp_tpu (a rank is a fresh interpreter, which should not
load XLA).
"""
import threading
from contextlib import contextmanager

import numpy as np
import torch

# tests/test_banded_shard.py's tube (Robin facets on) and its options
TUBE = dict(r_inner=0.001, r_outer=0.0013, length=0.004, n_theta=8,
            n_r_fluid=2, n_r_solid=1, n_z=4)
_E, _NU = 1e6, 0.45
_MU_S = _E / (2 * (1 + _NU))
TUBE_CFG = dict(dt=0.001, theta=0.501, rho_f=1.025e3, mu_f=3.5e-3,
                dx_f_id=1, rho_s=1e3, mu_s=_MU_S,
                lambda_s=_NU * 2 * _MU_S / (1 - 2 * _NU), dx_s_id=2,
                material_model="StVenantKirchoff", extrapolation="laplace",
                extrapolation_sub_type="constant", quadrature_degree=2,
                robin_bc=True, k_s=[1e5], c_s=[10], ds_s_id=[33])
TIGHT = dict(atol=1e-9, rtol=1e-9, max_it=8, gmres_tol=1e-8,
             gmres_restart=60, gmres_maxiter=600, jac_dtype="f32",
             krylov_dtype="f32")


def tube_system(mesh=TUBE, cfg=TUBE_CFG, DirichletBC=None, FSISystem=None,
                fsi_tube_mesh=None, device="cpu"):
    """(system, bc set, load) of test_banded_shard.py's tube_system, built
    by the package whose classes are given (the port's by default)."""
    if FSISystem is None:
        from vasp_tpu_torch.fem.dirichlet import DirichletBC
        from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
        from vasp_tpu_torch.run.system import FSISystem
        cfg = dict(cfg, device=device)
    system = FSISystem(fsi_tube_mesh(**mesh), cfg)
    space = system.space
    bcs = [DirichletBC(space.field_dofs("d", space.p2_dofs_on_facets(m)),
                       0.0) for m in (2, 3, 11)]
    bcs += [DirichletBC(space.field_dofs("v", space.p2_dofs_on_facets(m)),
                        0.0) for m in (2, 11)]
    bc = system.make_bcset(bcs)
    return system, bc, 150.0 * system.interface_pressure_load()


def _rank_entry(fn, out_dir, args):
    import torch.distributed as dist
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        out = fn(*args)
    torch.save(out, f"{out_dir}/rank{dist.get_rank()}.pt")


def run_world(n, fn, tmp_path, *args):
    """fn(*args) on n gloo ranks; the list of what each rank returned."""
    from vasp_tpu_torch.parallel.bootstrap import spawn_world

    out_dir = tmp_path / f"world_{fn.__name__}_{n}"
    out_dir.mkdir()
    spawn_world(n, _rank_entry, (fn, str(out_dir), args), "gloo",
                store_dir=str(tmp_path), threads=1)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def in_thread(fn, *args):
    """fn(*args) started on a thread of this process, so that the caller's
    own work overlaps it (a world of spawned ranks waits on them with the
    interpreter lock released); returns a function that waits for it and
    returns its result (or raises its error)."""
    out = {}

    def target():
        try:
            out["result"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - raised by result()
            out["error"] = e

    thread = threading.Thread(target=target)
    thread.start()

    def result():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["result"]

    return result


def start_world(n, fn, tmp_path, *args):
    """run_world(n, fn, tmp_path, *args) on a thread (in_thread)."""
    return in_thread(run_world, n, fn, tmp_path, *args)


class _Box:
    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)


def thread_ranks(n, fn, *args):
    """fn(comm, *args) on n threads of this process, each one rank with a
    parallel/comm.py Collectives whose all-reduce is a barrier-synchronized
    sum (or maximum) of the ranks' buffers in rank order: several ranks'
    work composed in one process on one card (the exchanges' buffers hold
    one sender's values and zeros, so the sums are exact, as gloo's).
    Returns the ranks' results in rank order; a rank's exception is raised
    here."""
    import torch.distributed as dist

    from vasp_tpu_torch.parallel.comm import Collectives

    box = _Box(n)

    class ThreadCollectives(Collectives):
        def __init__(self, rank):
            self.group, self.rank, self.n = None, rank, n
            self.span = self.c = None

        def _reduce(self, x, op):
            box.slots[self.rank] = x.detach().reshape(-1).clone()
            box.barrier.wait()
            out = box.slots[0].clone()
            for y in box.slots[1:]:
                out = (out + y if op == dist.ReduceOp.SUM
                       else torch.maximum(out, y))
            box.barrier.wait()
            return out.reshape(x.shape)

    results, errors = [None] * n, []

    def run(rank):
        try:
            results[rank] = fn(ThreadCollectives(rank), *args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            box.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


@contextmanager
def plain_banded():
    """kernels/banded.py's dispatchers of the sharded applies (carry_stage,
    carry_update, tri_residual) bound to their plain versions, on a card's
    tensors too: the same apply through the plain versions."""
    from vasp_tpu_torch.kernels import banded as kb

    names = ("carry_stage", "carry_update", "tri_residual")
    saved = {k: getattr(kb, k) for k in names}
    for k in names:
        setattr(kb, k, getattr(kb, f"{k}_plain"))
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(kb, k, f)


# ---------------------------------------------------------- rank bodies
def comm_ops(span, c):
    """Every Collectives operation on this rank's seeded inputs: the
    integer-valued sums are exact in any order, the exchanges move values
    untouched."""
    from vasp_tpu_torch.parallel.comm import Collectives

    comm = Collectives(span, c)
    rng = np.random.default_rng(comm.rank)
    ints = torch.as_tensor(rng.integers(-1000, 1000, span), dtype=torch.float64)
    x = torch.as_tensor(rng.normal(size=span))
    y_ext = torch.as_tensor(np.abs(rng.normal(size=span + c + 1)))
    n = comm.n
    return dict(
        red=comm.red(ints), red_scalar=comm.red(ints.sum()),
        red_max=comm.red_max(x), ppermute=comm.ppermute(x, n - 1, 0),
        shift_right=comm.shift_right(x), shift_left=comm.shift_left(x),
        ext_gather=comm.ext_gather(x), halo_add=comm.halo_add(y_ext),
        halo_max=comm.halo_max(y_ext), gather_spans=comm.gather_spans(x),
        inputs=(ints, x, y_ext))


def rank_devices():
    """The card this rank takes and makes current (use_rank_device) for
    device="cuda": torch's own where CUDA is visible, else on a host made
    to show two cards, torch.cuda.set_device recorded."""
    from vasp_tpu_torch.parallel import bootstrap

    if torch.cuda.is_available():
        dev = bootstrap.use_rank_device("cuda")
        return dict(device=dev, current=torch.cuda.current_device(),
                    cards=torch.cuda.device_count())
    set_to = []
    torch.cuda.device_count = lambda: 2
    torch.cuda.set_device = set_to.append
    dev = bootstrap.use_rank_device("cuda")
    return dict(device=dev, current=set_to[-1].index if set_to else None,
                cards=2)


def _rank_rows(st, A, block_index):
    """The rows of a global (K, n, n) element array that the rank's block
    holds, in its order, zero on its padding rows."""
    plan, rank = st.plan, st.comm.rank
    pi = plan.iperm[st.global_dofs[block_index]]
    owner = np.clip(pi.min(axis=1) // plan.span, 0, plan.n - 1)
    sel = np.nonzero(owner == rank)[0]
    out = torch.zeros((st.blocks[block_index].dofs.shape[0],)
                      + A.shape[1:], dtype=torch.float32)
    out[:len(sel)] = torch.as_tensor(A[sel])
    return out


# a seeded, diagonally dominant block-tridiagonal system for SPIKE: 4 ranks
# of 3 blocks of 16
BENIGN = dict(n=4, nb_loc=3, c=16)


def benign_system(seed=20261018):
    """(C, D, B) float32 (nb, c, c) with C_0 = B_{nb-1} = 0, D_k 4 I plus
    N(0, 0.1) entries, C_k and B_k N(0, 0.1), and a N(0, 1) right-hand side
    (nb c,) float64: the kind of system on which vasp_tpu calls its SPIKE
    exact to 1e-7 (banded_shard.py:587)."""
    nb, c = BENIGN["n"] * BENIGN["nb_loc"], BENIGN["c"]
    rng = np.random.default_rng(seed)
    C = 0.1 * rng.standard_normal((nb, c, c))
    B = 0.1 * rng.standard_normal((nb, c, c))
    D = 0.1 * rng.standard_normal((nb, c, c)) + 4.0 * np.eye(c)
    C[0] = 0.0
    B[-1] = 0.0
    f32 = [a.astype(np.float32) for a in (C, D, B)]
    return (*f32, rng.standard_normal(nb * c))


def _spike_benign(comm):
    """This rank's SPIKE solve of benign_system with refine 0 and 2."""
    from vasp_tpu_torch.parallel import banded_shard as bs

    m, c = BENIGN["nb_loc"], BENIGN["c"]
    *CDB, rhs = benign_system()
    lo = comm.rank * m
    Cl, Dl, Bl = (torch.as_tensor(a[lo:lo + m]) for a in CDB)
    plan = bs.ShardPlan(c=c, nb_loc=m, span=m * c, n=comm.n,
                        ndof=comm.n * m * c, npad=comm.n * m * c, perm=None,
                        iperm=None)
    r = torch.as_tensor(rhs[lo * c:(lo + m) * c])
    out = {}
    for refine in (0, 2):
        F = bs.sharded_factorize_spike(Cl, Dl, Bl, comm, refine=refine)
        out[f"x_benign{refine}"] = bs.make_sharded_spike_apply(
            plan, comm, refine)(F, r)
    return out


def banded_shard_world(inputs):
    """The sharded path on one rank of test_torch_banded_shard.py's world:
    its residual and Taylor delta after halo_add at seeded states; on
    vasp_tpu's float32
    element Jacobians of the first rebuild (`inputs`), its Ruiz scales,
    merged C/D/B, factors, transfer products, both applies of a seeded
    vector and their probes; then two steps of the chain stepper, one of
    the Thomas one, the delta endgame against raw residuals, and the
    ladder's float64 factor and direction tiers."""
    from vasp_tpu_torch.fem.timestepper import StepOptions
    from vasp_tpu_torch.parallel import banded_shard as bs

    inp = np.load(inputs)
    system, bc, load = tube_system()
    bcv = torch.as_tensor(bc.values_at(0.001))
    zero = system.zero_state()
    st = bs.ShardedBandedStepper(system, bc, StepOptions(**TIGHT))
    st.global_dofs = [b.dofs.numpy() for b in system.assembler.blocks]
    comm, plan = st.comm, st.plan
    out = dict(rank=comm.rank, n=comm.n, c=plan.c, nb_loc=plan.nb_loc)

    U_ext, U0_ext, A_ext = (comm.ext_gather(st.to_loc(torch.as_tensor(
        inp[k]))) for k in ("U", "U0", "A"))
    out["R"] = comm.halo_add(st.asm.residual(U_ext, U0_ext))
    out["delta"] = comm.halo_add(st.asm.residual_delta(U_ext, A_ext, U0_ext))
    jacs = [_rank_rows(st, inp[f"jac{i}"], i) for i in range(len(st.blocks))]
    dr, dc = bs.sharded_ruiz(st.blocks, jacs, st.mask_loc, st.mask_ext, comm,
                             4)
    Cm, D, Bm = bs.merge_halo_blockrow(*bs.sharded_assemble_banded(
        st.blocks, jacs, comm.ext_gather(dr), comm.ext_gather(dc), st._plans,
        plan, st._diag), comm)
    Sinv, H, G = bs.sharded_factorize(Cm, D, Bm, comm)
    Tf, Tb = bs.sharded_transfer_products(H, G)
    F = dict(Sinv=Sinv, H=H, G=G, Tf=Tf, Tb=Tb)
    out.update(dr=dr, dc=dc, C=Cm.clone(), D=D.clone(), B=Bm.clone(),
               Sinv=Sinv, H=H, G=G)
    r_loc = st.to_loc(torch.as_tensor(inp["r"]))
    for algo, make in (("chain", bs.make_sharded_chain_apply),
                       ("thomas", bs.make_sharded_banded_apply)):
        apply = make(plan, comm)
        out[f"x_{algo}"] = apply(F, r_loc)
        out[f"probe_{algo}"] = bs.sharded_probe_rel(Cm, D, Bm, F, apply, comm)

    out["U1"], out["info1"] = st.step(zero, bcv, load, 1)
    out["U2"], out["info2"] = st.step(out["U1"], bcv, 1.2 * load, 2)
    out["last_rebuild"], out["rel_chain"] = st._last_rebuild, st._last_rel
    thomas = bs.ShardedBandedStepper(system, bc, StepOptions(**TIGHT),
                                     algo="thomas")
    out["U_thomas"], out["info_thomas"] = thomas.step(zero, bcv, load, 1)
    out["rel_thomas"] = thomas._last_rel

    common = dict(TIGHT, atol=1e-6, rtol=1e-6, max_it=10, gmres_tol=1e-3,
                  gmres_maxiter=240)
    for label, extra in (("hybrid", dict(residual_dtype="f32")),
                         ("raw", {})):
        s2 = bs.ShardedBandedStepper(system, bc, StepOptions(**common,
                                                             **extra))
        out[f"U_{label}"], out[f"info_{label}"] = s2.step(zero, bcv, load, 1)

    U1 = torch.where(bc.mask_on("cpu"), bcv, zero)
    st._rebuild(U1, zero, 1, f64=True)
    out["rel_f64"] = st._last_rel
    out["U_exact"], out["info_exact"] = st._newton(zero, zero, bcv, load,
                                                   True, exact=True)

    # SPIKE (K21f): the benign system, a step at TIGHT with refine 2 and
    # its factors' probe with refine 0, the float64 factor tier's rebuild
    # and a bf16-factor step at the hybrid case's options
    out.update(_spike_benign(comm))
    spike = bs.ShardedBandedStepper(system, bc, StepOptions(**TIGHT),
                                    algo="spike")
    out["U_spike"], out["info_spike"] = spike.step(zero, bcv, load, 1)
    out["rel_spike2"] = spike._last_rel
    F = spike._factors[2]
    out["rel_spike0"] = bs.sharded_probe_rel(
        F["Cb"], F["Db"], F["Bb"], F,
        bs.make_sharded_spike_apply(plan, comm, 0), comm)
    spike._rebuild(U1, zero, 1, f64=True)
    out["rel_spike_f64"] = spike._last_rel
    bf16 = bs.ShardedBandedStepper(
        system, bc, StepOptions(**common, banded_factor_dtype="bf16"),
        algo="spike")
    out["U_spike_bf16"], out["info_spike_bf16"] = bf16.step(zero, bcv, load,
                                                            1)
    out["spike_bf16_dtype"] = bf16._factors[2]["H"].dtype
    return out


# tests/test_sharded_step.py's small system (Robin facets on) and its
# step options (test_sharded_matches_single_chip)
SMALL = dict(TUBE, length=0.003, n_z=3)
STEP_OPTS = dict(atol=1e-10, rtol=1e-10, max_it=6, gmres_tol=1e-9,
                 gmres_restart=120, gmres_maxiter=1200)


def sharded_step_world():
    """One make_sharded_step solve on this rank: the small system's 150x
    interface load, its bc values at t = 1e-3, from rest."""
    from vasp_tpu_torch.fem.timestepper import StepOptions
    from vasp_tpu_torch.parallel.shard import make_sharded_step

    system, bc, load = tube_system(SMALL)
    step, comm = make_sharded_step(system, bc.mask, StepOptions(**STEP_OPTS))
    U, stats = step(system.zero_state(), torch.as_tensor(bc.values_at(0.001)),
                    load)
    return dict(rank=comm.rank, n=comm.n, U=U, stats=stats)
