"""Damped Newton solver with Jacobian reuse and pluggable linear solvers.

Counterpart of vasp_tpu.fem.solver.NewtonSolver. The residual and the
element Jacobians are evaluated on the run's device (CUDA kernels on a
GPU). The linear solvers, chosen by ``NewtonOptions.linear_solver`` as in
vasp_tpu:

- "lu": the Jacobian is assembled into a host CSR, Ruiz-equilibrated and
  factorized with scipy's splu, the reference's MUMPS-equivalent path
  (reference: src/vasp/simulations/offset_stenosis.py:44-48);
- any other value (the Krylov branch): element-block additive Schwarz
  (K22, kernels/schwarz.py: the float64 element Jacobians with bc rows set
  to identity and a regularized diagonal, their torch.linalg.inv inverses,
  the multiplicity-weighted apply) and left-preconditioned GMRES with the
  semantics of jax.scipy.sparse.linalg.gmres(solve_method="incremental")
  (fem/krylov.py gmres_incremental) over the masked element matvec (K4) at
  gmres_tol, gmres_restart and gmres_maxiter.

The control flow (Jacobian reuse knobs, stall rebuild, 8-candidate
backtracking, the Levenberg fallback of the LU branch) is the reference
package's, unchanged. With biharmonic lifting (``lift``, the tables of
fem/biharmonic.py) the correction term enters the residual through K16
(kernels/lifting.py), the factorized matrix as its host CSR, bc rows and
columns zeroed, and the Krylov branch's matvec on the masked vector.

Stdout follows the reference solver's de-facto log API consumed by
vasp-log-plotter and the regression tests
(reference: src/vasp/postprocessing/log_plotter.py:73-77 regexes):
  "Newton iteration {i}: r (atol) = {...} (tol = {...}), r (rel) = {...} (tol = {...})"

``NewtonSolver.timings`` accumulates wall seconds per phase (residual,
jacobian, to_csr, ruiz, splu, solve; on the Krylov branch schwarz_build,
schwarz_invert and gmres); the device phases end in a synchronize, so
each is the time the phase holds the host (GMRES synchronizes once an
Arnoldi iteration, when its Hessenberg row comes to the host).
``gmres_restarts`` and ``gmres_iterations`` count the Krylov branch's
restart cycles and Arnoldi iterations over the run.
"""
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vasp_tpu_torch.fem.biharmonic import correction_apply, correction_csr
from vasp_tpu_torch.fem.krylov import gmres_incremental
from vasp_tpu_torch.kernels import schwarz as ks


@dataclass
class NewtonOptions:
    atol: float = 1e-7
    rtol: float = 1e-7
    max_it: int = 50
    lmbda: float = 1.0
    recompute: int = 5
    recompute_tstep: int = 1
    linear_solver: str = "lu"
    gmres_tol: float = 1e-4
    gmres_restart: int = 50
    gmres_maxiter: int = 400
    verbose: bool = True
    raise_on_fail: bool = True


@dataclass
class NewtonState:
    jacs: Optional[list] = None
    lu = None
    A_s = None
    lu_dr: Optional[np.ndarray] = None
    lu_dc: Optional[np.ndarray] = None
    pinv: Optional[list] = None  # Schwarz block inverses
    multiplicity: Optional[torch.Tensor] = None
    last_rebuild_tstep: int = -(10 ** 9)
    iters_since_rebuild: int = 0


def _host_ruiz(A, bc_mask, sweeps=4):
    """Row/col max-norm equilibration of a scipy CSR (host-side, on the
    fully assembled matrix)."""
    import scipy.sparse as sp

    n = A.shape[0]
    dr = np.ones(n)
    dc = np.ones(n)
    for _ in range(sweeps):
        B = sp.diags(dr) @ A @ sp.diags(dc)
        B = abs(B)
        rmax = np.asarray(B.max(axis=1).todense()).ravel()
        cmax = np.asarray(B.max(axis=0).todense()).ravel()
        dr /= np.sqrt(np.maximum(rmax, 1e-30))
        dc /= np.sqrt(np.maximum(cmax, 1e-30))
        dr[bc_mask] = 1.0
        dc[bc_mask] = 1.0
    return dr, dc


class NewtonSolver:
    def __init__(self, assembler, bc_set, options: NewtonOptions,
                 lift=None):
        self.asm = assembler
        self.bc = bc_set
        self.opt = options
        self.state = NewtonState()
        self.timings = defaultdict(float)
        self.factorizations = 0  # splu calls, Levenberg ones included
        self.gmres_restarts = 0
        self.gmres_iterations = 0
        # biharmonic lifting correction: the linear L M^-1 L - L term on
        # the fluid d-block, in the residual and in the factorized matrix
        self.lift = lift
        self._lift_csr = None

    @contextmanager
    def _timed(self, phase, device=None):
        tic = time.perf_counter()
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        self.timings[phase] += time.perf_counter() - tic

    def _residual(self, U, U0, load):
        R = self.asm.residual(U, U0) + load
        if self.lift is not None:
            R = R + correction_apply(self.lift, U)
        return torch.where(self.bc.mask_on(U.device), 0.0, R)

    def _residual_norm(self, U, U0, load):
        """(R, ||R||): the host reads the norm, which waits for the device."""
        with self._timed("residual"):
            R = self._residual(U, U0, load)
            return R, float(torch.linalg.norm(R))

    # ---------------- Jacobian management ----------------
    def _rebuild(self, U, U0, tstep):
        with self._timed("jacobian", U.device):
            self.state.jacs = self.asm.element_jacobians(U, U0)
        self.state.last_rebuild_tstep = tstep
        self.state.iters_since_rebuild = 0
        if self.opt.linear_solver == "lu":
            self._factorize()
        else:
            self._build_schwarz()

    def _factorize(self):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        # factorize the RUIZ-EQUILIBRATED matrix: the raw monolithic FSI
        # Jacobian spans ~12 decades and can exceed f64 LU accuracy;
        # equilibration runs on the fully assembled host CSR, so that every
        # term (the biharmonic correction too, which the element Jacobians
        # do not carry) is scaled
        with self._timed("to_csr"):
            A = self.asm.to_csr(self.state.jacs, bc_mask=self.bc.mask)
            if self.lift is not None:
                A = A + self._lift_matrix()
        with self._timed("ruiz"):
            drn, dcn = _host_ruiz(A, self.bc.mask, sweeps=4)
            A_s = (sp.diags(drn) @ A @ sp.diags(dcn)).tocsc()
        with self._timed("splu"):
            self.state.lu = spla.splu(A_s)
        self.factorizations += 1
        self.state.A_s = A_s  # kept for the Levenberg fallback
        self.state.lu_dr = drn
        self.state.lu_dc = dcn

    def _build_schwarz(self):
        """Element-block additive Schwarz (K22): each element Jacobian with
        its bc rows set to identity, its bc columns zeroed off them and a
        small diagonal regularization (the zero pressure diagonal of the
        saddle blocks), inverted; the dofs' multiplicities for weighting."""
        eps = 1e-12
        dev = self.state.jacs[0].device
        mask = self.bc.mask_on(dev)
        mult = torch.zeros(self.asm.ndof, dtype=torch.float64, device=dev)
        pinv = []
        for b, A in zip(self.asm.blocks, self.state.jacs):
            with self._timed("schwarz_build", dev):
                Amod = ks.build(A, b.dofs, mask, eps, mult)
            with self._timed("schwarz_invert", dev):
                # row-major for K22's apply (torch.linalg.inv returns each
                # matrix column-major)
                pinv.append(torch.linalg.inv(Amod).contiguous())
            del Amod
        self.state.pinv = pinv
        self.state.multiplicity = torch.clamp(mult, min=1.0)

    def _lift_matrix(self):
        """The correction's host CSR with its bc rows and columns zeroed,
        built once."""
        if self._lift_csr is None:
            C = correction_csr(self.lift, self.asm.ndof).tolil()
            idx = np.nonzero(self.bc.mask)[0]
            C[idx, :] = 0.0
            C[:, idx] = 0.0
            self._lift_csr = C.tocsr()
        return self._lift_csr

    def _precond(self, r):
        return ks.apply(self.state.pinv, [b.dofs for b in self.asm.blocks],
                        r, self.state.multiplicity)

    def _matvec(self, x):
        """The Jacobian on the free dofs, identity on the constrained ones
        (the biharmonic correction on the masked vector too)."""
        mask = self.bc.mask_on(x.device)
        y = self.asm.matvec(self.state.jacs, x)
        if self.lift is not None:
            y = y + correction_apply(self.lift, torch.where(mask, 0.0, x))
        return torch.where(mask, x, y)

    # ---------------- linear solve ----------------
    def _linear_solve(self, R):
        if self.opt.linear_solver != "lu":
            with self._timed("gmres", R.device):
                dx, (restarts, iters) = gmres_incremental(
                    self._matvec, R, M=self._precond, tol=self.opt.gmres_tol,
                    atol=0.0, restart=self.opt.gmres_restart,
                    maxiter=self.opt.gmres_maxiter)
            self.gmres_restarts += restarts
            self.gmres_iterations += iters
            return dx
        with self._timed("solve"):
            y = self.state.lu.solve(self.state.lu_dr * R.cpu().numpy())
            return torch.as_tensor(self.state.lu_dc * y, dtype=torch.float64,
                                   device=R.device)

    # ---------------- Newton loop ----------------
    def solve(self, U, U0, t, tstep, load=None):
        """One nonlinear solve. U: initial guess (typically previous step with
        BCs applied); U0: previous timestep solution. Returns (U, info)."""
        opt = self.opt
        if load is None:
            load = torch.zeros(self.asm.ndof, dtype=torch.float64,
                               device=U.device)
        U = self.bc.apply(U, t)

        first_res = None
        prev_res = None
        stalled = False
        best_res = np.inf
        best_U = U
        no_progress = 0
        it = 0
        converged = False
        last_stall_rebuild = -10
        while it < opt.max_it:
            need_rebuild = (
                self.state.jacs is None
                or (it > 0 and self.state.iters_since_rebuild >= opt.recompute)
                or (
                    it == 0
                    and (tstep - self.state.last_rebuild_tstep)
                    >= opt.recompute_tstep
                )
                # a reused (chord) Jacobian can yield ascent directions on
                # strongly nonlinear steps: rebuild once the residual stops
                # decreasing, at most once per 3 iterations
                or (stalled and self.state.iters_since_rebuild > 0
                    and it - last_stall_rebuild >= 3)
            )
            if need_rebuild:
                if stalled:
                    last_stall_rebuild = it
                self._rebuild(U, U0, tstep)

            R, res = self._residual_norm(U, U0, load)
            if first_res is None:
                first_res = res if res > 0 else 1.0
            rel = res / first_res
            if opt.verbose:
                print(
                    f"Newton iteration {it}: r (atol) = {res:.3e} "
                    f"(tol = {opt.atol:.3e}), r (rel) = {rel:.3e} "
                    f"(tol = {opt.rtol:.3e})"
                )
            if res < best_res:
                best_res, best_U = res, U
                no_progress = 0
            else:
                no_progress += 1
            if res < opt.atol or rel < opt.rtol:
                converged = True
                break
            if no_progress >= 5:
                # stagnation: return the best state seen
                break
            # a chord iteration contracting slower than 2x is cheaper to
            # rebuild than to ride out
            stalled = prev_res is not None and res > 0.5 * prev_res
            prev_res = res

            def backtrack(dx, n_halvings=8):
                """Best damped candidate by residual norm; NaN = rejected."""
                best_U, best_r = None, np.inf
                for k in range(n_halvings):
                    lam = opt.lmbda * (0.5 ** k)
                    Ut = U - lam * dx
                    _, rt = self._residual_norm(Ut, U0, load)
                    if np.isfinite(rt) and rt < best_r:
                        best_U, best_r = Ut, rt
                return best_U, best_r

            dx = self._linear_solve(R)
            cand_U, cand_r = backtrack(dx)
            if (cand_U is None or cand_r >= res) \
                    and self.state.iters_since_rebuild > 0:
                # no descent with a reused (chord) Jacobian: rebuild and
                # retry this iteration with the exact tangent
                self._rebuild(U, U0, tstep)
                dx = self._linear_solve(self._residual(U, U0, load))
                cand_U, cand_r = backtrack(dx)
            if (cand_U is None or cand_r >= res) \
                    and self.opt.linear_solver == "lu" \
                    and self.state.A_s is not None:
                # Levenberg fallback: no descent along the EXACT Newton
                # direction; solve (A_s + mu I) on the equilibrated system,
                # escalating mu until a descent direction appears
                import scipy.sparse as sp
                import scipy.sparse.linalg as spla

                n = self.asm.ndof
                Rnp = self.state.lu_dr * R.cpu().numpy()
                for mu in (1e-4, 1e-3, 1e-2, 1e-1):
                    with self._timed("splu"):
                        lu_mu = spla.splu(
                            (self.state.A_s
                             + mu * sp.identity(n, format="csc")).tocsc())
                    self.factorizations += 1
                    dxm = torch.as_tensor(
                        self.state.lu_dc * lu_mu.solve(Rnp),
                        dtype=torch.float64, device=U.device)
                    cu, cr = backtrack(dxm)
                    if cu is not None and cr < 0.999 * res:
                        cand_U, cand_r = cu, cr
                        break
            if cand_U is None:
                raise RuntimeError(
                    f"Newton line search failed at timestep {tstep}: every "
                    f"damped candidate produced a non-finite residual "
                    f"(residual {res:.3e})"
                )
            if cand_r >= res and no_progress >= 2:
                # nothing descends even with exact J + Levenberg: stop
                break
            U = cand_U
            self.state.iters_since_rebuild += 1
            it += 1

        if not converged:
            U, res = best_U, best_res
            rel = res / first_res if first_res else 1.0
            if opt.raise_on_fail:
                raise RuntimeError(
                    f"Newton solver did not converge in {it} iterations "
                    f"(best residual {res:.3e}, rel {rel:.3e})"
                )
        return U, dict(iterations=it, residual=res, rel=rel,
                       converged=converged)
