"""NewtonSolver's Krylov branch (element-block Schwarz and GMRES) on the
CPU, in either package; and its Schwarz blocks' conditioning.

    JAX_PLATFORMS=cpu python tests/diag_newton_krylov.py vasp_tpu tube 3 400
    python tests/diag_newton_krylov.py vasp_tpu_torch tube 3 400
    python tests/diag_newton_krylov.py vasp_tpu_torch pipe 8 10 1e-4
    python tests/diag_newton_krylov.py vasp_tpu_torch tube 3 20 1e-4 identity
    JAX_PLATFORMS=cpu python tests/diag_newton_krylov.py blocks
    JAX_PLATFORMS=cpu python tests/diag_newton_krylov.py parity [shared]

(from the root of a checkout; a script beside the tests that pytest does
not collect)

Solve mode, arguments: the package; the case ("tube": the pressure-loaded
small FSI tube of tests/_torch_small_fsi.py on its first layer, 1,652 dofs,
linear_solver="krylov" at t = 1e-3 from rest; "pipe": the rigid pipe of
tests/test_torch_schwarz.py, a transient flow, every d dof held); max_it;
gmres_maxiter (restarts); optionally gmres_tol (default vasp_tpu's 1e-4)
and, on the port, "identity": GMRES without the Schwarz preconditioner.
Prints the dofs, |M R| / |R| at the start state (M the Schwarz apply,
on a solver of its own), the printed Newton residuals, the solve's result
and, on the port, the GMRES restarts and Arnoldi iterations.

"blocks": both packages' modified Schwarz blocks of the port's float64
Jacobians on _torch_small_fsi.SHORT_MESH at a seeded state (as
tests/test_torch_schwarz.py builds them): per block the condition
numbers' spread, and torch.linalg.inv against jnp.linalg.inv on the same
blocks, relative to the largest entry, and that difference over
cond x eps where float64 resolves the block.

"parity": tests/test_torch_schwarz.py's tube case
(_tube_newton: max_it=3, 20 restarts) in both packages, optionally with
the port's torch.linalg.inv replaced by jnp.linalg.inv ("shared": both
take the same inverses of their bitwise-equal blocks): each package's
Newton residuals and GMRES counts, and U's difference over its norm.

The questions it answers: does the Krylov branch converge on an FSI tube
(in neither package), why (singular element blocks), and on what does it
converge (the rigid pipe)?
"""
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def tube(pkg):
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
    return system, bc, 150.0 * system.interface_pressure_load(), 1e-3


def solve(pkg, case, max_it, gmres_maxiter, gmres_tol, identity=False):
    if case == "tube":
        system, bc, load, t = tube(pkg)
        kw = dict(linear_solver="krylov", atol=1e-8, rtol=1e-8)
    else:
        from test_torch_schwarz import _pipe_system

        system, bc = _pipe_system(pkg, "no_extrapolation")
        load, t, kw = None, 0.0, {}
    opts = dict(max_it=max_it, raise_on_fail=False,
                gmres_maxiter=gmres_maxiter, gmres_tol=gmres_tol, **kw)
    U0 = system.zero_state()
    probe = system.make_solver(bc, **opts)
    U1 = bc.apply(U0, t)
    probe._rebuild(U1, U0, 1)
    R = probe._residual(U1, U0, U0 * 0.0 if load is None else load)
    ratio = float(np.linalg.norm(np.asarray(probe._precond(R)))
                  / np.linalg.norm(np.asarray(R)))
    del probe
    solver = system.make_solver(bc, **opts)
    if identity:
        solver._precond = lambda r: r
    buf = io.StringIO()
    with redirect_stdout(buf):
        U, info = solver.solve(bc.apply(U0, t), U0, t, 1, load=load)
    print(f"{pkg} {case}: {system.assembler.ndof} dofs; |M R| / |R| at the "
          f"start {ratio:.3e}")
    print("\n".join(line for line in buf.getvalue().splitlines()
                    if line.startswith("Newton iteration")))
    print(f"result {info}")
    if hasattr(solver, "gmres_restarts"):
        print(f"GMRES restarts {solver.gmres_restarts}, Arnoldi iterations "
              f"{solver.gmres_iterations}")


def blocks():
    from test_torch_schwarz import schwarz_pair

    jsol, tsol, jmod = schwarz_pair.__wrapped__()
    eps = np.finfo(np.float64).eps
    for b, Pt, Pj, Am in zip(tsol.asm.blocks, tsol.state.pinv,
                             jsol.state.pinv, jmod):
        cond = np.linalg.cond(Am)
        Pt, Pj = Pt.numpy(), np.asarray(Pj)
        err = (np.abs(Pt - Pj).max(axis=(1, 2))
               / np.abs(Pj).max(axis=(1, 2)))
        ok = cond * eps <= 1e-4
        print(f"{b.name}: {len(cond)} elements, cond min/median/max "
              f"{cond.min():.3g} / {np.median(cond):.3g} / {cond.max():.3g};"
              f" resolved (cond eps <= 1e-4) {ok.mean():.3f}; inverse "
              f"difference max {err.max():.3g}, median {np.median(err):.3g}"
              + (f"; over cond eps where resolved, max "
                 f"{(err[ok] / (cond[ok] * eps)).max():.3g}"
                 if ok.any() else ""))


def parity(shared):
    import jax.numpy as jnp
    import torch
    from test_torch_schwarz import _tube_newton

    out = [_tube_newton("vasp_tpu")]
    if shared:
        torch.linalg.inv = lambda A: torch.as_tensor(
            np.asarray(jnp.linalg.inv(jnp.asarray(A.numpy()))))
    out.append(_tube_newton("vasp_tpu_torch"))
    for pkg, (res, info, U, counts) in zip(("vasp_tpu", "vasp_tpu_torch"),
                                           out):
        print(f"{pkg}: Newton residuals {res}, {info}, GMRES {counts}")
    Uj, Ut = out[0][2], out[1][2]
    print(f"U difference over its norm "
          f"{np.linalg.norm(Ut - Uj) / np.linalg.norm(Uj):.3g}"
          f"{' (the same inverses)' if shared else ''}")


if __name__ == "__main__":
    if sys.argv[1] == "blocks":
        blocks()
    elif sys.argv[1] == "parity":
        parity(sys.argv[2:3] == ["shared"])
    else:
        solve(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
              float(sys.argv[5]) if len(sys.argv) > 5 else 1e-4,
              sys.argv[6:7] == ["identity"])
