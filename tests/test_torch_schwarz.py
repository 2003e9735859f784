"""NewtonSolver's Krylov branch against vasp_tpu's: the GMRES of
jax.scipy.sparse.linalg.gmres(solve_method="incremental") (fem/krylov.py
gmres_incremental), the element-block additive Schwarz preconditioner
(K22, kernels/schwarz.py) and fem/preconditioner.py, and Newton solves
through make_solver(linear_solver="krylov").

What the branch can and cannot do, measured in both packages
(tests/diag_newton_krylov.py): the Schwarz inverses are those of element
matrices whose singular parts the 1e-12 regularization leaves singular in
float64 (the solid blocks' pressure rows carry no equation, the element
Laplacians of the mesh lifting have the constants in their null space):
on _torch_small_fsi.SHORT_MESH at a seeded state the solid blocks have
cond 5e15-1.6e27 and their inverses are rounding, so on an FSI tube, with lifting or a wall,
GMRES spends its 400 restarts and Newton stalls in both packages, each on
its own rounding. The parity runs therefore take a transient flow in a
rigid pipe (no solid, no lifting), where every block is resolved in
float64 and both packages converge; the biharmonic case (K16 in the
matvec) is held at the matvec.
"""
import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax._src.scipy.sparse.linalg as jax_linalg
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_small_fsi import SHORT_MESH, build_pair, random_state, \
    torch_threads
from vasp_tpu.fem import preconditioner as jpre
from vasp_tpu_torch.fem import preconditioner as tpre
from vasp_tpu_torch.fem.krylov import gmres_incremental
from vasp_tpu_torch.kernels import schwarz as ks

_threads = torch_threads(2)
EPS64 = float(np.finfo(np.float64).eps)


def _scale_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("restart,maxiter,tol", [
    (10, 8, 1e-10), (15, 3, 1e-10), (30, 20, 1e-8)],
    ids=["restarts_spent", "few_restarts", "converges"])
def test_gmres_incremental_matches_jax(restart, maxiter, tol):
    """Iterates within 1e-12 of JAX's, and the same restart and Arnoldi
    iteration counts (JAX's counted by callbacks in its restart and Arnoldi
    functions), on a seeded nonsymmetric system with a tridiagonal
    preconditioner: exhausting its restarts, and converging inside one
    (the early exit on ptol). Measured up to 6e-15."""
    rng = np.random.default_rng(3)
    n = 120
    A = np.eye(n) * 4.0 + rng.normal(size=(n, n)) * (
        0.6 if tol < 1e-9 else 0.25)
    Minv = np.linalg.inv(np.triu(np.tril(A, 1), -1))
    b = rng.normal(size=n)
    counts = {"restarts": 0, "iterations": 0}

    def counted(fn, key):
        def wrapped(*args, **kwargs):
            jax.debug.callback(lambda: counts.__setitem__(key,
                                                          counts[key] + 1))
            return fn(*args, **kwargs)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_linalg, "_gmres_incremental",
                   counted(jax_linalg._gmres_incremental, "restarts"))
        mp.setattr(jax_linalg, "_kth_arnoldi_iteration",
                   counted(jax_linalg._kth_arnoldi_iteration, "iterations"))
        xj, _ = jax.scipy.sparse.linalg.gmres(
            lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=tol, atol=0.0,
            restart=restart, maxiter=maxiter,
            M=lambda v: jnp.asarray(Minv) @ v, solve_method="incremental")
        xj = np.asarray(xj)
    At, Mt = torch.as_tensor(A), torch.as_tensor(Minv)
    xt, (restarts, iterations) = gmres_incremental(
        lambda v: At @ v, torch.as_tensor(b), M=lambda v: Mt @ v, tol=tol,
        restart=restart, maxiter=maxiter)
    assert (restarts, iterations) == (counts["restarts"],
                                      counts["iterations"])
    assert _scale_err(xt.numpy(), xj) <= 1e-12
    if tol == 1e-8:
        assert restarts < maxiter  # converged before spending them


@pytest.fixture(scope="module")
def schwarz_pair():
    """Both packages' Krylov-branch NewtonSolver on SHORT_MESH fed the same
    float64 element Jacobians (the port's, at a seeded state): vasp_tpu's
    modified blocks (its _build_schwarz with the inverse an identity), its
    inverses and multiplicity, and the port's solver after its own
    _build_schwarz."""
    (js, jbc), (ts, tbc) = build_pair(SHORT_MESH)
    jsol = js.make_solver(jbc, linear_solver="krylov")
    tsol = ts.make_solver(tbc, linear_solver="krylov")
    U = torch.as_tensor(random_state(ts.space, 0))
    U0 = torch.as_tensor(random_state(ts.space, 1))
    jacs = ts.assembler.element_jacobians(U, U0)
    tsol.state.jacs = jacs
    jsol.state.jacs = [jnp.asarray(A.numpy()) for A in jacs]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "inv", lambda a: a)
        jsol._build_schwarz()
        jmod = [np.asarray(P) for P in jsol.state.pinv]
    jsol._build_schwarz()
    tsol._build_schwarz()
    return jsol, tsol, jmod


def test_schwarz_build_matches_vasp_tpu(schwarz_pair):
    """K22's build pass (the plain version here) on the same Jacobians:
    the modified blocks equal vasp_tpu's (the same IEEE operations: masks,
    one product and one sum on the diagonal), and so does the
    multiplicity."""
    jsol, tsol, jmod = schwarz_pair
    mask = tsol.bc.mask_on("cpu")
    mult = torch.zeros(tsol.asm.ndof, dtype=torch.float64)
    for b, A, Aj in zip(tsol.asm.blocks, tsol.state.jacs, jmod):
        Amod = ks.build(A, b.dofs, mask, 1e-12, mult)
        assert np.array_equal(Amod.numpy(), Aj), b.name
    assert np.array_equal(torch.clamp(mult, min=1.0).numpy(),
                          np.asarray(jsol.state.multiplicity))
    assert np.array_equal(tsol.state.multiplicity.numpy(),
                          np.asarray(jsol.state.multiplicity))


def test_schwarz_inverses_match_vasp_tpu(schwarz_pair):
    """torch.linalg.inv against jnp.linalg.inv on the same modified blocks,
    per element: where float64 resolves the block (cond x eps <= 1e-4),
    within cond x eps of the largest entry (measured at most 2.8e-7 cond x
    eps); elsewhere both only finite (the fluid block's cond reaches 1e19,
    the solid block's 5e15-1.6e27: its inverses part by up to 57x their
    largest entry). A third of the fluid elements are resolved at this
    state (measured: tests/diag_newton_krylov.py blocks)."""
    jsol, tsol, jmod = schwarz_pair
    for b, Pt, Pj, Am in zip(tsol.asm.blocks, tsol.state.pinv,
                             jsol.state.pinv, jmod):
        Pt, Pj = Pt.numpy(), np.asarray(Pj)
        assert np.isfinite(Pt).all() and np.isfinite(Pj).all()
        cond = np.linalg.cond(Am)
        err = (np.abs(Pt - Pj).max(axis=(1, 2))
               / np.abs(Pj).max(axis=(1, 2)))
        ok = cond * EPS64 <= 1e-4
        assert (err[ok] <= cond[ok] * EPS64).all(), b.name
        if b.name.startswith("fluid"):
            assert ok.mean() >= 0.25, ok.mean()


def test_schwarz_apply_matches_vasp_tpu(schwarz_pair):
    """K22's apply (plain here) on vasp_tpu's own inverses and multiplicity
    against its _precond: 1e-12 of the output's scale."""
    jsol, tsol, _ = schwarz_pair
    r = np.random.default_rng(5).normal(size=tsol.asm.ndof)
    yj = np.asarray(jsol._precond(jnp.asarray(r)))
    yt = ks.apply([torch.as_tensor(np.asarray(P)) for P in jsol.state.pinv],
                  [b.dofs for b in tsol.asm.blocks], torch.as_tensor(r),
                  torch.as_tensor(np.asarray(jsol.state.multiplicity)))
    assert _scale_err(yt.numpy(), yj) <= 1e-12


def test_f32_preconditioner_matches_vasp_tpu():
    """fem/preconditioner.py on seeded element blocks that float32
    resolves (diagonally dominant, random dofs and bc mask, 64 and 36 local
    dofs): the float32 inverses within 1e-5 of vasp_tpu's per block
    (float32 LU inverses of cond ~10 matrices by two LAPACKs), the raw
    multiplicity equal, the unscaled apply within 1e-12 of its scale on
    the same inverses."""
    rng = np.random.default_rng(7)
    ndof = 500
    mask = rng.random(ndof) < 0.1
    blocks, jacs = [], []
    for K, n in ((40, 64), (12, 36)):
        dofs = np.stack([rng.choice(ndof, n, replace=False)
                         for _ in range(K)])
        blocks.append(dofs)
        jacs.append(rng.normal(size=(K, n, n)) + 8.0 * np.eye(n))
    jb = [SimpleNamespace(dofs=jnp.asarray(d)) for d in blocks]
    tb = [SimpleNamespace(dofs=torch.as_tensor(d)) for d in blocks]
    jp, jm = jpre.build_schwarz(jb, [jnp.asarray(A) for A in jacs],
                                jnp.asarray(mask), ndof)
    tp, tm = tpre.build_schwarz(tb, [torch.as_tensor(A) for A in jacs],
                                torch.as_tensor(mask), ndof)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    for Pt, Pj in zip(tp, jp):
        assert Pt.dtype == torch.float64
        assert _scale_err(Pt.numpy(), np.asarray(Pj)) <= 1e-5
    r = rng.normal(size=ndof)
    yj = jpre.apply_schwarz(jb, jp, jnp.asarray(r))
    yt = tpre.apply_schwarz(tb, [torch.as_tensor(np.asarray(P)) for P in jp],
                            torch.as_tensor(r))
    assert _scale_err(yt.numpy(), np.asarray(yj)) <= 1e-12


def _pipe_system(pkg, extrapolation):
    """A transient flow in a rigid pipe (the mesh and boundary data of
    tests/test_fluid_poiseuille.py at 1,858 dofs, dt = 1e-3) on the Krylov
    branch: (system, bc set). Under "no_extrapolation" every d dof is held;
    under "biharmonic" (bc2, beta 1e-2) only the boundary ones."""
    if pkg == "vasp_tpu":
        from vasp_tpu.fem.dirichlet import DirichletBC
        from vasp_tpu.mesh.generate import poiseuille_pipe_mesh
        from vasp_tpu.run.system import FSISystem
        device = {}
    else:
        from vasp_tpu_torch.fem.dirichlet import DirichletBC
        from vasp_tpu_torch.mesh.generate import poiseuille_pipe_mesh
        from vasp_tpu_torch.run.system import FSISystem
        device = dict(device="cpu")
    mesh = poiseuille_pipe_mesh(radius=1.0, length=3.0, n_theta=6, n_r=2,
                                n_z=3)
    cfg = dict(dt=1e-3, theta=1.0, rho_f=1.0, mu_f=1.0, dx_f_id=1,
               solid="no_solid", extrapolation=extrapolation, atol=1e-10,
               rtol=1e-12, recompute=1, recompute_tstep=1,
               linear_solver="krylov", quadrature_degree=4, verbose=True,
               **device)
    if extrapolation == "biharmonic":
        cfg.update(extrapolation_sub_type="bc2", biharmonic_beta=1e-2)
    system = FSISystem(mesh, cfg)
    space = system.space
    walls = np.unique(np.concatenate([space.p2_dofs_on_facets(m)
                                      for m in (2, 3, 22)]))
    held = np.arange(space.n_p2) if extrapolation == "no_extrapolation" \
        else walls
    bcs = [DirichletBC(space.field_dofs("d", held), 0.0)]
    for marker in (2, 3, 22):
        p2d = space.p2_dofs_on_facets(marker)
        xyz = space.p2_coords[p2d]
        u = np.zeros_like(xyz)
        u[:, 2] = 1.0 - xyz[:, 0] ** 2 - xyz[:, 1] ** 2
        bcs.append(DirichletBC(space.field_dofs("v", p2d), u.reshape(-1)))
    bcs.append(DirichletBC(space.pressure_dofs(mesh.facet_vertices(3)),
                           0.0))
    return system, system.make_bcset(bcs)


def test_krylov_newton_solve_matches_vasp_tpu():
    """One solve of the pipe's first step through make_solver in both
    packages: the same Newton count, both converged, U within 1e-10
    relative (measured 3.4e-16: both reach the discrete solution to atol
    1e-10). gmres_tol=1e-8: at the default 1e-4 the directions are as
    inexact as the wall elements' rounding-level inverses make them, and
    the residual after the first iteration parts by 4x between the
    packages (measured 0.24-0.95), so the count is decided by where that
    rounding lands against atol; at 1e-8 both take 3.879e1, 9.378e-2,
    ~3e-8, ~1e-12. gmres_maxiter=10: the outer restarts change nothing once
    the inner exit has fired (the preconditioned-residual exit never does),
    and each costs a matvec."""
    out = []
    for pkg in ("vasp_tpu", "vasp_tpu_torch"):
        system, bc = _pipe_system(pkg, "no_extrapolation")
        solver = system.make_solver(bc, gmres_tol=1e-8, gmres_maxiter=10,
                                    max_it=8)
        assert solver.opt.linear_solver == "krylov"
        U0 = system.zero_state()
        with redirect_stdout(io.StringIO()):
            U, info = solver.solve(bc.apply(U0, 0.0), U0, t=0.0, tstep=0)
        out.append((np.asarray(U), info))
    (Uj, ij), (Ut, it) = out
    assert ij["converged"] and it["converged"]
    assert it["iterations"] == ij["iterations"]
    assert np.linalg.norm(Ut - Uj) <= 1e-10 * np.linalg.norm(Uj)


def _tube_newton(pkg):
    """One Krylov-branch solve of the pressure-loaded small FSI tube's
    first layer (1,652 dofs; tests/diag_newton_krylov.py's "tube") at
    t = 1e-3 from rest, max_it=3, 20 GMRES restarts: (the printed Newton
    residuals, info, U, GMRES restarts, Arnoldi iterations); vasp_tpu's
    counted by callbacks in its restart and Arnoldi functions."""
    import _torch_small_fsi as h

    mesh = dict(h.MESH, n_z=1, length=0.0016)
    if pkg == "vasp_tpu":
        from vasp_tpu.fem.dirichlet import DirichletBC
        from vasp_tpu.mesh.generate import fsi_tube_mesh
        from vasp_tpu.run.system import FSISystem
        cfg = dict(h.CFG)
    else:
        from vasp_tpu_torch.fem.dirichlet import DirichletBC
        from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
        from vasp_tpu_torch.run.system import FSISystem
        cfg = dict(h.CFG, device="cpu")
    system = FSISystem(fsi_tube_mesh(**mesh), cfg)
    bc = system.make_bcset(h._bcs(system.space, DirichletBC))
    solver = system.make_solver(bc, linear_solver="krylov", atol=1e-8,
                                rtol=1e-8, max_it=3, gmres_maxiter=20,
                                raise_on_fail=False)
    U0 = system.zero_state()
    counts = {"restarts": 0, "iterations": 0}

    def counted(fn, key):
        def wrapped(*args, **kwargs):
            jax.debug.callback(lambda: counts.__setitem__(key,
                                                          counts[key] + 1))
            return fn(*args, **kwargs)
        return wrapped

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, redirect_stdout(buf):
        mp.setattr(jax_linalg, "_gmres_incremental",
                   counted(jax_linalg._gmres_incremental, "restarts"))
        mp.setattr(jax_linalg, "_kth_arnoldi_iteration",
                   counted(jax_linalg._kth_arnoldi_iteration, "iterations"))
        U, info = solver.solve(bc.apply(U0, 1e-3), U0, 1e-3, 1,
                               load=150.0 * system.interface_pressure_load())
    res = [float(line.split("r (atol) = ")[1].split()[0])
           for line in buf.getvalue().splitlines()
           if line.startswith("Newton iteration")]
    if pkg != "vasp_tpu":
        counts = {"restarts": solver.gmres_restarts,
                  "iterations": solver.gmres_iterations}
    return res, info, np.asarray(U), counts


def test_krylov_newton_on_tube_matches_vasp_tpu():
    """The branch on the FSI tube, where it stalls in both packages
    (singular Schwarz blocks; module docstring): the same Newton count,
    neither converged, the same GMRES restarts and Arnoldi iterations (every
    solve spends its 20 restarts), the first residual within 1e-12 and each
    later one within 10% of vasp_tpu's (measured 1.6% and 6.2%: 2.782e-4
    against 2.827e-4, 2.778e-4 against 2.615e-4; unchanged at 1, 2 and 4
    threads; a copy of the port without the multiplicity division, or
    without the bc mask in the matvec, fails the count check). U is not
    held: the directions are decided by rounding in the blocks'
    1e16-1e27 inverse entries, and U parts by 1.87 of its norm (2.0 with
    vasp_tpu's own inverses handed to the port; tests/diag_newton_krylov.py
    parity [shared]), so that no bound on U would hold more than its
    finiteness."""
    (rj, ij, Uj, cj), (rt, it, Ut, ct) = (_tube_newton(p) for p in
                                          ("vasp_tpu", "vasp_tpu_torch"))
    assert it["iterations"] == ij["iterations"] == 3
    assert not ij["converged"] and not it["converged"]
    assert ct == cj and ct["restarts"] == 20 * len(rj), (ct, cj)
    assert len(rt) == len(rj)
    assert abs(rt[0] - rj[0]) <= 1e-12 * rj[0]
    for a, b in zip(rt[1:], rj[1:]):
        assert abs(a - b) <= 0.1 * b, (rt, rj)
    assert np.isfinite(Ut).all() and np.isfinite(Uj).all()


def test_krylov_matvec_with_biharmonic_lifting_matches_vasp_tpu():
    """The branch's matvec with biharmonic lifting (K4 and the K16
    correction on the masked vector, identity on the constrained dofs) and
    its residual, on the same Jacobians and vectors: 1e-12 of scale. The
    lifted pipe's Newton solves do not converge in either package (the
    element Laplacians of the lifting are singular blocks of the Schwarz
    preconditioner), so the branch is held here at its operator."""
    (js, jbc), (ts, tbc) = (_pipe_system(p, "biharmonic")
                            for p in ("vasp_tpu", "vasp_tpu_torch"))
    jsol, tsol = js.make_solver(jbc), ts.make_solver(tbc)
    assert tsol.lift is not None
    rng = np.random.default_rng(11)
    U = rng.normal(size=ts.space.ndof) * 1e-3
    x = rng.normal(size=ts.space.ndof)
    Ut, xt = torch.as_tensor(U), torch.as_tensor(x)
    tsol.state.jacs = ts.assembler.element_jacobians(Ut, Ut)
    jacs = [jnp.asarray(A.numpy()) for A in tsol.state.jacs]
    yj = np.asarray(jsol._matvec(jacs, jnp.asarray(x)))
    assert _scale_err(tsol._matvec(xt).numpy(), yj) <= 1e-12
    load = np.zeros(ts.space.ndof)
    Rj = np.asarray(jsol._residual(jnp.asarray(U), jnp.asarray(U),
                                   jnp.asarray(load)))
    Rt = tsol._residual(Ut, Ut, torch.as_tensor(load))
    assert _scale_err(Rt.numpy(), Rj) <= 1e-12
