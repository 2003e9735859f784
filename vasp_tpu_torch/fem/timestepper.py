"""Newton-Krylov timestepper of the iterative path (banded preconditioner).

Counterpart of vasp_tpu.fem.timestepper: ``StepOptions``,
``IterativeStepper`` with precond="banded" in its full-f32 factor layout,
and ``IterativeNewtonSolver``. Each Newton iteration builds element
Jacobians (float32 by default, K3), solves the Ruiz-equilibrated system
(Dr J Dc) y = Dr R by right-preconditioned GMRES (K5) whose operator is the
element matvec (K4) and whose preconditioner is the banded two-scan apply
(K6), and takes a full-step-first line search on the float64 residual (K1,
K2). A rebuild (every ``recompute_tstep`` steps, or on a stall) refreshes
the preconditioner: float32 Jacobians -> Ruiz scales and element rescale
(K7) -> banded assembly (K8) -> Schur scan, H/G and probe (K9, K10).

The Newton loop is a host loop of device calls: the residual norm, the
line-search acceptance, the stall count and GMRES's early exit are read
on the host as they are needed. vasp_tpu's TPU workarounds are not ported:
the 8-iteration dispatch chunking (so iteration counts agree with
vasp_tpu for steps of at most 8 iterations), the block_until_ready
barriers, the remote-worker gate on the last ladder tier and the 7 GiB
lowmem switch; the factor layout is checked against the card's free memory
instead.

Refused, each with the ROADMAP.md item that will port it: the hybrid
residual precisions (residual_dtype f32/mixed/f32f) and jac_carry (item
7), bf16/hybrid factor storage, the lowmem layouts and the probe-flagged
f64 factor escalation (item 9), precond="ras" and chain_anchor (item 14).
In vasp_tpu the ladder reaches its exact tier (f64 Jacobians and f64
GMRES) and the rebuild-at-current-state retry only under the hybrid
residual precisions, so those two ladder steps come with item 7; the exact
Newton variant itself is here (``_newton(..., exact=True)``).
"""
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vasp_tpu_torch.fem import banded as banded_mod
from vasp_tpu_torch.fem.krylov import gmres
from vasp_tpu_torch.fem.scaling import ruiz_scales, scale_element_jacobians

# probe solve quality above which a Newton stall would take vasp_tpu's f64
# factor escalation (its VASP_BANDED_RELMAX default)
REL_MAX = 1.0


def not_ported(what, item):
    raise NotImplementedError(
        f"{what} is not ported to vasp_tpu_torch yet (ROADMAP.md queue 1, "
        f"item {item})")


@dataclass(frozen=True)
class StepOptions:
    atol: float = 1e-7
    rtol: float = 1e-7
    max_it: int = 10
    lmbda: float = 1.0
    # within-step Jacobian reuse: element Jacobians are recomputed every
    # `recompute` Newton iterations (1 = true Newton)
    recompute: int = 1
    gmres_tol: float = 1e-6
    gmres_restart: int = 60
    gmres_maxiter: int = 300
    # accepted for vasp_tpu's configurations; no effect, since the K3
    # kernel needs no chunking
    jac_chunk: Optional[int] = None
    # "f32": Newton's element Jacobians in float32 (inexact Newton with
    # float64 residuals)
    jac_dtype: Optional[str] = None
    # "f32": the whole Krylov space in float32
    krylov_dtype: Optional[str] = None
    residual_dtype: Optional[str] = None
    ruiz_sweeps: int = 4
    precond: str = "banded"
    banded_factor_dtype: Optional[str] = None
    # GMRES forcing: "fixed" solves every direction to gmres_tol; "ew" is
    # Eisenstat-Walker choice 2, eta = gamma (r_k / r_{k-1})^2 clipped into
    # [gmres_tol, ew_max] with the over-solve floor 0.1 atol / r_k
    forcing: str = "fixed"
    ew_gamma: float = 0.9
    ew_max: float = 1e-2
    chain_anchor: bool = False
    jac_carry: bool = False
    # "extrapolate" starts Newton from 2 U_n - U_{n-1} on consecutive steps
    predictor: str = "none"

    def __post_init__(self):
        if self.banded_factor_dtype not in (None, "hybrid", "bf16", "f32"):
            raise ValueError(
                f"banded_factor_dtype={self.banded_factor_dtype!r}: "
                "expected None (auto), 'hybrid', 'bf16', or 'f32'")
        if self.residual_dtype in ("f32", "mixed", "f32f"):
            not_ported(f"residual_dtype={self.residual_dtype!r}", 7)
        if self.jac_carry:
            not_ported("jac_carry", 7)
        if self.banded_factor_dtype in ("hybrid", "bf16"):
            not_ported(f"banded_factor_dtype={self.banded_factor_dtype!r}", 9)
        if self.precond == "ras":
            not_ported("precond='ras'", 14)
        if self.precond != "banded":
            raise ValueError(f"precond={self.precond!r}: expected 'banded'")
        if self.chain_anchor:
            not_ported("chain_anchor", 14)


class IterativeStepper:
    """Ruiz + banded-preconditioned GMRES Newton, one timestep per
    ``step`` call.

    ``timings`` accumulates wall seconds per phase, each ended by a device
    synchronize on a card: rebuild phases (rebuild_jacobians, ruiz,
    assemble, factorize, hg, probe) and per-iteration phases (jacobians,
    residual, gmres, and inside gmres its matvec and precond shares).
    ``setup`` holds the one-time host seconds (pattern, rcm, plan),
    ``rebuilds`` the rebuild count, ``gmres_inner`` the GMRES inner
    iterations over the run and ``history`` one record per step (Newton
    iterations, GMRES inner iterations, rebuilds)."""

    def __init__(self, system, bc_set, options: StepOptions,
                 recompute_tstep=20):
        opt = options
        self.asm = system.assembler
        self.opt = opt
        self.device = system.device
        self.ndof = self.asm.ndof
        mask_np = np.asarray(bc_set.mask)
        self.mask = bc_set.mask_on(self.device)
        self.recompute_tstep = int(recompute_tstep)
        self._jdtype = torch.float32 if opt.jac_dtype == "f32" \
            else torch.float64
        self._last_rebuild = -(10 ** 9)
        self._pinv = None
        self._dr = self._dc = None
        self._last_rel = 0.0
        self._pred_prev = None
        self._pred_tstep = None
        self.timings = defaultdict(float)
        self.setup = {}
        self.rebuilds = 0
        self.gmres_inner = 0
        self.history = []

        block_dofs = [b.dofs.cpu().numpy() for b in self.asm.blocks]
        tic = time.perf_counter()
        self._bpat = banded_mod.build_banded_pattern(
            block_dofs, self.ndof, timings=self.setup)
        self.setup["pattern"] = time.perf_counter() - tic
        self._check_memory()
        tic = time.perf_counter()
        plans = banded_mod.build_banded_assembly_plan(
            block_dofs, self._bpat, mask_np)
        self.setup["plan"] = time.perf_counter() - tic
        self._plans = banded_mod.plans_to_device(plans, self.device)
        self._diag_flat = torch.as_tensor(
            banded_mod.identity_diag_slots(self._bpat, mask_np),
            device=self.device)
        self._apply = banded_mod.make_banded_apply(self._bpat, self.device)

    def _check_memory(self):
        """The full-f32 layout holds C/D/B and Sinv/H/G at once (the probe
        reads all six), beside two sets of f32 element matrices and a few
        c x c temporaries of the scan. Raise where the card cannot."""
        if self.device.type != "cuda":
            return
        pat = self._bpat
        jac = sum(4 * 64 * 64 * b.dofs.shape[0] for b in self.asm.blocks)
        need = 6 * pat.factor_bytes + 2 * jac + 8 * 4 * pat.c * pat.c
        free, _ = torch.cuda.mem_get_info(self.device)
        if need > free:
            not_ported(
                f"the banded preconditioner at c={pat.c}, nb={pat.nb} needs "
                f"{need / 2**30:.1f} GiB of device memory with "
                f"{free / 2**30:.1f} GiB free; its low-memory layouts are",
                9)

    @contextmanager
    def _timed(self, phase):
        tic = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings[phase] += time.perf_counter() - tic

    # -------------- preconditioner --------------
    def _rebuild(self, U, U0, tstep):
        # free the previous factors before assembling new ones
        self._pinv = None
        asm, mask = self.asm, self.mask
        with self._timed("rebuild_jacobians"):
            jacs = asm.element_jacobians(U, U0, dtype=torch.float32)
        with self._timed("ruiz"):
            dr, dc = ruiz_scales(asm.blocks, jacs, mask, self.ndof,
                                 sweeps=self.opt.ruiz_sweeps)
            jf = scale_element_jacobians(asm.blocks, jacs, dr, dc)
            del jacs
        with self._timed("assemble"):
            Cm, Dm, Bm = banded_mod.assemble_banded_planned(
                jf, self._plans, self._bpat, self._diag_flat)
            del jf
        with self._timed("factorize"):
            Sinv = banded_mod.schur_scan(Cm, Dm, Bm)
        with self._timed("hg"):
            H, G = banded_mod.hg_factors(Sinv, Cm, Bm)
        with self._timed("probe"):
            self._last_rel = banded_mod.probe_rel(Cm, Dm, Bm, Sinv, H, G)
        self._dr, self._dc = dr.to(torch.float64), dc.to(torch.float64)
        self._pinv = (Sinv, H, G)
        self._last_rebuild = tstep
        self.rebuilds += 1

    # -------------- Newton --------------
    def _residual(self, U, U0, load):
        with self._timed("residual"):
            R = self.asm.residual(U, U0) + load
            R = torch.where(self.mask, 0.0, R)
            return R, float(torch.linalg.norm(R))

    def _jacobians(self, U, U0, dtype):
        with self._timed("jacobians"):
            return self.asm.element_jacobians(U, U0, dtype=dtype)

    def _direction(self, R, jacs, eta, exact):
        """dx = Dc y with y the GMRES solution of the equilibrated system."""
        opt, mask, asm = self.opt, self.mask, self.asm
        wdt = torch.float32 if (opt.krylov_dtype == "f32" and not exact) \
            else torch.float64
        dr, dc = self._dr, self._dc
        drw, dcw = dr.to(wdt), dc.to(wdt)

        def matvec(x):
            with self._timed("matvec"):
                t = dcw * torch.where(mask, 0.0, x)
                y = asm.matvec(jacs, t).to(wdt)
                return torch.where(mask, x, drw * y)

        def precond(r):
            with self._timed("precond"):
                return self._apply(*self._pinv, r)

        Rs = (dr * R).to(wdt)
        # the exact variant gets a tighter tolerance and 5x the cycles
        gtol = min(opt.gmres_tol, 1e-5) if exact else opt.gmres_tol
        if opt.forcing == "ew" and not exact:
            gtol = eta
        gcyc = max(1, opt.gmres_maxiter // opt.gmres_restart)
        if exact:
            gcyc *= 5
        with self._timed("gmres"):
            y, info = gmres(matvec, Rs, M=precond, restart=opt.gmres_restart,
                            cycles=gcyc, tol=gtol)
        self.gmres_inner += info[2]
        return dc * y.to(torch.float64)

    def _newton(self, U0, Ustart, bcv, load, it_cap, exact=False):
        """Damped Newton from Ustart (bc values imposed) on the residual of
        the step from U0. Returns (U, stats) for the best state seen,
        stats = iterations, residual (best), r0, stalled. exact=True:
        float64 Jacobians and float64 GMRES with the exact tier's
        tolerance and cycles."""
        opt = self.opt
        jdt = torch.float64 if exact else self._jdtype
        rec = max(1, int(opt.recompute))
        U = torch.where(self.mask, bcv, Ustart)
        R, rnorm = self._residual(U, U0, load)
        r0 = rnorm
        r0_safe = r0 if r0 > 0 else 1.0
        Ub, rb = U, rnorm
        stall, it, eta = 0, 0, opt.gmres_tol
        # a stall is a residual not decreasing; the exact variant counts
        # only near-zero progress as one
        sthr = 0.98 if exact else 0.9
        jacs = self._jacobians(U, U0, jdt) if rec > 1 else None
        while (it < it_cap and rnorm > opt.atol
               and rnorm / r0_safe > opt.rtol and stall < 2):
            if rec == 1 or (it > 0 and it % rec == 0):
                jacs = self._jacobians(U, U0, jdt)
            dx = self._direction(R, jacs, eta, exact)
            # full step first; the halving search only when it fails
            cands = []
            for k in range(4):
                Ut = U - opt.lmbda * (0.5 ** k) * dx
                cands.append((Ut, *self._residual(Ut, U0, load)))
                if k == 0 and np.isfinite(cands[0][2]) \
                        and cands[0][2] < rnorm:
                    break
            rs = [r if np.isfinite(r) else np.inf for _, _, r in cands]
            U, R, _ = cands[int(np.argmin(rs))]
            rn = min(rs)
            stall = stall + 1 if rn > sthr * rnorm else 0
            if rn < rb:
                Ub, rb = U, rn
            # Eisenstat-Walker forcing term of the next direction
            eta = float(np.clip(
                max(opt.ew_gamma * (rn / max(rnorm, 1e-300)) ** 2,
                    0.1 * opt.atol / max(rn, 1e-300)),
                opt.gmres_tol, opt.ew_max))
            rnorm = rn
            it += 1
        return Ub, dict(iterations=it, residual=rb, r0=r0,
                        stalled=stall >= 2)

    # -------------- public --------------
    def step(self, U0, bc_values, load, tstep):
        """One timestep from U0; returns (U, stats)."""
        inner0, rebuilds0 = self.gmres_inner, self.rebuilds
        fresh = False
        if (self._pinv is None
                or tstep - self._last_rebuild >= self.recompute_tstep):
            self._rebuild(torch.where(self.mask, bc_values, U0), U0, tstep)
            fresh = True
        Ustart = U0
        if (self.opt.predictor == "extrapolate"
                and self._pred_prev is not None
                and tstep == self._pred_tstep + 1):
            Ustart = U0 + (U0 - self._pred_prev)
        self._pred_prev, self._pred_tstep = U0, tstep
        U, stats = self._newton(U0, Ustart, bc_values, load,
                                self.opt.max_it)
        converged = (stats["residual"] <= self.opt.atol
                     or stats["residual"] <= self.opt.rtol
                     * max(stats["r0"], 1e-300))
        if not converged and self._last_rel > REL_MAX:
            not_ported(
                f"the f64 factor escalation (Newton stalled at timestep "
                f"{tstep} under banded factors with probe rel "
                f"{self._last_rel:.1e})", 9)
        if not converged and not fresh:
            # stall-triggered rebuild: a preconditioner frozen since an
            # earlier step degrades GMRES on load-jump steps; rebuild at the
            # best mid-Newton state and continue from it
            self._rebuild(U, U0, tstep)
            it0 = stats["iterations"]
            U, stats = self._newton(U0, U, bc_values, load,
                                    self.opt.max_it)
            stats["iterations"] += it0
        self.history.append(dict(
            tstep=tstep, iterations=stats["iterations"],
            gmres_inner=self.gmres_inner - inner0,
            rebuilds=self.rebuilds - rebuilds0))
        return U, stats


class IterativeNewtonSolver:
    """The Newton-Krylov solver the driver calls for linear_solver in
    ("gmres", "iterative", "ras"), with NewtonSolver's solve() contract
    and one contract line per step."""

    def __init__(self, system, bc_set, step_options: StepOptions,
                 recompute_tstep: int = 20, verbose: bool = True,
                 raise_on_fail: bool = True):
        self.stepper = IterativeStepper(system, bc_set, step_options,
                                        recompute_tstep=recompute_tstep)
        self.bc = bc_set
        self.opt = step_options
        self.verbose = verbose
        self.raise_on_fail = raise_on_fail

    @property
    def timings(self):
        return self.stepper.timings

    @property
    def rebuilds(self):
        return self.stepper.rebuilds

    def solve(self, U, U0, t, tstep, load=None):
        del U  # the step starts from the previous state
        dev = self.stepper.device
        if load is None:
            load = torch.zeros(self.stepper.ndof, dtype=torch.float64,
                               device=dev)
        bcv = torch.as_tensor(self.bc.values_at(t), dtype=torch.float64,
                              device=dev)
        U1, stats = self.stepper.step(U0, bcv, load, tstep)
        it = int(stats["iterations"])
        res = float(stats["residual"])
        r0 = float(stats["r0"])
        rel = res / (r0 if r0 > 0 else 1.0)
        converged = res <= self.opt.atol or rel <= self.opt.rtol
        if self.verbose:
            print(f"Newton iteration {it}: r (atol) = {res:.3e} "
                  f"(tol = {self.opt.atol:.3e}), r (rel) = {rel:.3e} "
                  f"(tol = {self.opt.rtol:.3e})")
            if not converged:
                print(f"WARNING: Newton did not converge at timestep "
                      f"{tstep} (residual {res:.3e})")
        if not converged and self.raise_on_fail:
            raise RuntimeError(
                f"Newton failed at t={t} (tstep {tstep}): residual {res:.3e}"
                f" rel {rel:.3e} after {it} iterations")
        return U1, dict(iterations=it, residual=res, rel=rel,
                        converged=converged)
