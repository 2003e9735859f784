"""Newton-Krylov timestepper of the iterative path (banded preconditioner).

Counterpart of vasp_tpu.fem.timestepper: ``StepOptions``,
``IterativeStepper`` with precond="banded" in its full-f32 factor layout
and its precision ladder, and ``IterativeNewtonSolver``. Each Newton
iteration builds element Jacobians (float32 by default, K3), solves the
Ruiz-equilibrated system (Dr J Dc) y = Dr R by right-preconditioned GMRES
(K5) whose operator is the element matvec (K4) and whose preconditioner is
the banded two-scan apply (K6), and takes a full-step-first line search on
the residual (K1, K2). A rebuild (every ``recompute_tstep`` steps, or on a
stall) refreshes the preconditioner: float32 Jacobians -> Ruiz scales and
element rescale (K7) -> banded assembly (K8) -> Schur scan, H/G and probe
(K9, K10), or the float64 Schur scan (K11) once a step has escalated.

Hybrid residual precisions (``residual_dtype``): "f32" evaluates the
residual with float32 element work (K1/K2 f32) while the norm is above
``endgame_factor * atol`` and in float64 below it, "mixed" likewise with
the fine residual float32 on the fluid and float64 on the solid, "f32f"
with a float32 fine residual too; accumulation is float64 in every case.
``step`` then climbs vasp_tpu's ladder, tier by tier: the certification of
a coarse exit that claims convergence, the reactive float64 factor
escalation under probe-flagged factors (K11), the coarse-phase stall retry
with fine residuals, the exact tier (float64 Jacobians and GMRES), the
rebuild-at-current-state exact retry and the stall-triggered rebuild.
Each tier prints vasp_tpu's line for it and is recorded in ``history``.

With biharmonic lifting (``system.lift``) the correction term (K16,
kernels/lifting.py) enters every residual variant, always on the float64
U, and the Krylov matvec, on the Krylov vector in its own dtype. Ruiz and
the banded factors see only the element Jacobians, which carry the
correction's Laplace surrogate (fem/biharmonic.py), as in vasp_tpu.

The Newton loop is a host loop of device calls: the residual norm, the
line-search acceptance, the stall count and GMRES's early exit are read
on the host as they are needed. vasp_tpu's TPU workarounds are not ported:
the 8-iteration dispatch chunking (so iteration counts and ``jac_carry``
ages agree with vasp_tpu for Newton calls of at most 8 iterations), the
block_until_ready barriers, the remote-worker gate on the last ladder tier
(the port always takes it, as vasp_tpu does on the CPU) and the 7 GiB
lowmem switch; the factor layout is checked against the card's free memory
instead.

Refused, each with the ROADMAP.md item that will port it: the jet
Taylor-delta endgame (residual_dtype="f32" with delta_endgame=True) and
chain_anchor (item 14), bf16/hybrid factor storage and the lowmem layouts
(item 9), precond="ras" (item 14).
"""
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vasp_tpu_torch.fem import banded as banded_mod
from vasp_tpu_torch.fem.biharmonic import correction_apply
from vasp_tpu_torch.fem.krylov import gmres
from vasp_tpu_torch.fem.scaling import ruiz_scales, scale_element_jacobians

# probe solve quality above which a Newton stall takes the f64 factor
# escalation (vasp_tpu's VASP_BANDED_RELMAX default)
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
    # None (float64), or the hybrid "f32", "mixed", "f32f" (module doc)
    residual_dtype: Optional[str] = None
    ruiz_sweeps: int = 4
    precond: str = "banded"
    banded_factor_dtype: Optional[str] = None
    # accepted for vasp_tpu's configurations; the RAS preconditioner that
    # reads them is not ported
    n_subdomains: Optional[int] = None
    overlap: int = 2
    # hybrid residuals: fine (exact-grade) residuals once the norm is
    # within endgame_factor * atol
    endgame_factor: float = 30.0
    # the jet Taylor-delta endgame of residual_dtype="f32" (not ported;
    # "mixed" and "f32f" never use it)
    delta_endgame: bool = True
    # GMRES forcing: "fixed" solves every direction to gmres_tol; "ew" is
    # Eisenstat-Walker choice 2, eta = gamma (r_k / r_{k-1})^2 clipped into
    # [gmres_tol, ew_max] with the over-solve floor 0.1 atol / r_k
    forcing: str = "fixed"
    ew_gamma: float = 0.9
    ew_max: float = 1e-2
    chain_anchor: bool = False
    chain_reanchor: int = 1
    # carry element Jacobians across steps on the `recompute` cadence
    # (chord Newton, turtleFSI's recompute semantic); kept only on a
    # converged exit, dropped by a rebuild
    jac_carry: bool = False
    # "extrapolate" starts Newton from 2 U_n - U_{n-1} on consecutive steps
    predictor: str = "none"

    def __post_init__(self):
        if self.banded_factor_dtype not in (None, "hybrid", "bf16", "f32"):
            raise ValueError(
                f"banded_factor_dtype={self.banded_factor_dtype!r}: "
                "expected None (auto), 'hybrid', 'bf16', or 'f32'")
        if self.residual_dtype not in (None, "f32", "mixed", "f32f"):
            raise ValueError(
                f"residual_dtype={self.residual_dtype!r}: expected None, "
                "'f32', 'mixed' or 'f32f'")
        if self.residual_dtype == "f32" and self.delta_endgame:
            not_ported("residual_dtype='f32' with delta_endgame=True (the "
                       "jet Taylor-delta endgame)", 14)
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
    ``rebuilds`` the rebuild count, ``gmres_inner`` and ``gmres_cycles``
    the GMRES inner iterations and restart cycles over the run and
    ``history`` one record per step (Newton iterations, GMRES inner
    iterations and cycles, rebuilds, the ladder tiers taken after the
    first Newton call)."""

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
        self._lift = getattr(system, "lift", None)
        self._jdtype = torch.float32 if opt.jac_dtype == "f32" \
            else torch.float64
        self._last_rebuild = -(10 ** 9)
        self._pinv = None
        self._dr = self._dc = None
        self._last_rel = 0.0
        # set by the reactive escalation: every later rebuild runs K11
        self._banded_f64 = False
        self._jac_carry = None  # (element Jacobians, iteration age)
        self._pred_prev = None
        self._pred_tstep = None
        self.timings = defaultdict(float)
        self.setup = {}
        self.rebuilds = 0
        self.gmres_inner = 0
        self.gmres_cycles = 0
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
        reads all six), beside two sets of f32 element matrices, a few
        c x c f32 temporaries of the scan and the four c x c f64 ones of
        the escalation tier's scan (K11). Raise where the card cannot."""
        if self.device.type != "cuda":
            return
        pat = self._bpat
        # each block's (K, n, n) f32 matrices at its own local size n
        jac = sum(4 * b.dofs.shape[1] ** 2 * b.dofs.shape[0]
                  for b in self.asm.blocks)
        need = (6 * pat.factor_bytes + 2 * jac + 8 * 4 * pat.c * pat.c
                + 4 * 8 * pat.c * pat.c)
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
        # free the previous factors before assembling new ones; a carried
        # Jacobian goes too (vasp_tpu drops it at every rebuild)
        self._pinv = None
        self._jac_carry = None
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
            scan = (banded_mod.schur_scan_f64 if self._banded_f64
                    else banded_mod.schur_scan)
            Sinv = scan(Cm, Dm, Bm)
        with self._timed("hg"):
            H, G = banded_mod.hg_factors(Sinv, Cm, Bm)
        if not self._banded_f64:
            # vasp_tpu probes only the float32 recursion's factors
            with self._timed("probe"):
                self._last_rel = banded_mod.probe_rel(Cm, Dm, Bm, Sinv, H, G)
        self._dr, self._dc = dr.to(torch.float64), dc.to(torch.float64)
        self._pinv = (Sinv, H, G)
        self._last_rebuild = tstep
        self.rebuilds += 1

    # -------------- Newton --------------
    def _residual(self, U, U0, load, dtype=None):
        with self._timed("residual"):
            R = self.asm.residual(U, U0, dtype) + load
            if self._lift is not None:
                R = R + correction_apply(self._lift, U)
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
                if self._lift is not None:
                    y = y + correction_apply(self._lift, t).to(wdt)
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
        self.gmres_cycles += info[1]
        return dc * y.to(torch.float64)

    def _newton(self, U0, Ustart, bcv, load, it_cap, fine_start=False,
                exact=False):
        """Damped Newton from Ustart (bc values imposed) on the residual of
        the step from U0. Returns (U, stats) for the best state seen,
        stats = iterations, residual (best), r0, stalled, fine (the last
        iteration's residual was fine-grade), rfine (the best state's was).

        Hybrid residual precisions: coarse (float32 element work) residuals
        until the norm is within endgame_factor * atol, fine ones from then
        on (float32 under f32f, mixed under mixed, float64 under f32);
        fine_start=True takes fine ones from the first evaluation.
        exact=True: float64 Jacobians and float64 GMRES with the exact
        tier's tolerance and cycles, its fine residuals raw float64."""
        opt = self.opt
        jdt = torch.float64 if exact else self._jdtype
        rec = max(1, int(opt.recompute))
        hybrid = opt.residual_dtype in ("f32", "mixed", "f32f")
        fine_dt = None if exact else {"mixed": "mixed", "f32f": torch.float32
                                      }.get(opt.residual_dtype)
        endgame = opt.endgame_factor * opt.atol

        def residual(U, fine):
            if not hybrid:
                return self._residual(U, U0, load)
            return self._residual(U, U0, load,
                                  fine_dt if fine else torch.float32)

        U = U1 = torch.where(self.mask, bcv, Ustart)
        R, rnorm = residual(U, fine_start)
        if hybrid and not fine_start and rnorm < endgame:
            # the ENDGAME refine of R0
            R, rnorm = residual(U, True)
        fine = not hybrid or fine_start or rnorm < endgame
        r0 = rnorm
        r0_safe = r0 if r0 > 0 else 1.0
        Ub, rb, rbfine = U, rnorm, fine
        stall, it, eta = 0, 0, opt.gmres_tol
        # a stall is a residual not decreasing; the exact variant counts
        # only near-zero progress as one
        sthr = 0.98 if exact else 0.9
        use_carry = opt.jac_carry and rec > 1 and not exact
        jacs, age = (self._jac_carry if use_carry and self._jac_carry
                     is not None else (None, 0))
        while (it < it_cap and rnorm > opt.atol
               and rnorm / r0_safe > opt.rtol and stall < 2):
            if rec == 1 or jacs is None or (it > 0 and (it + age) % rec == 0):
                jacs = self._jacobians(U, U0, jdt)
            dx = self._direction(R, jacs, eta, exact)
            fine = fine or rnorm < endgame
            # full step first; the halving search only when it fails
            cands = []
            for k in range(4):
                Ut = U - opt.lmbda * (0.5 ** k) * dx
                cands.append((Ut, *residual(Ut, fine)))
                if k == 0 and np.isfinite(cands[0][2]) \
                        and cands[0][2] < rnorm:
                    break
            rs = [r if np.isfinite(r) else np.inf for _, _, r in cands]
            U, R, _ = cands[int(np.argmin(rs))]
            rn = min(rs)
            stall = stall + 1 if rn > sthr * rnorm else 0
            if rn < rb:
                Ub, rb, rbfine = U, rn, fine
            # Eisenstat-Walker forcing term of the next direction
            eta = float(np.clip(
                max(opt.ew_gamma * (rn / max(rnorm, 1e-300)) ** 2,
                    0.1 * opt.atol / max(rn, 1e-300)),
                opt.gmres_tol, opt.ew_max))
            rnorm = rn
            it += 1
        if use_carry:
            self._jac_carry = self._carry(jacs, age, it, rb, r0, U1, U0)
        return Ub, dict(iterations=it, residual=rb, r0=r0,
                        stalled=stall >= 2, fine=fine,
                        rfine=rbfine or exact)

    def _carry(self, jacs, age, it, res, r0, U1, U0):
        """The Jacobian carry a Newton call of `it` iterations leaves: its
        last Jacobians and their age in iterations, counted unwrapped
        (vasp_tpu's rule: age since the last in-loop refresh, else the
        carried age plus it), or None where the call did not converge or
        the age reached `recompute`. A call of no iteration carries fresh
        Jacobians of its start state, as vasp_tpu's dispatch does."""
        opt = self.opt
        rec = max(1, int(opt.recompute))
        if not (res <= opt.atol or res <= opt.rtol * max(r0, 1e-300)):
            return None
        it_last = (it - 1 + age) // rec * rec - age
        age = it - it_last if 1 <= it_last <= it - 1 else age + it
        if age >= rec:
            return None
        if jacs is None:
            jacs = self._jacobians(U1, U0, self._jdtype)
        return jacs, age

    # -------------- public --------------
    def step(self, U0, bc_values, load, tstep):
        """One timestep from U0; returns (U, stats)."""
        inner0, cycles0 = self.gmres_inner, self.gmres_cycles
        rebuilds0 = self.rebuilds
        tiers = []
        U, stats = self._step_ladder(U0, bc_values, load, tstep, tiers)
        self.history.append(dict(
            tstep=tstep, iterations=stats["iterations"],
            gmres_inner=self.gmres_inner - inner0,
            gmres_cycles=self.gmres_cycles - cycles0,
            rebuilds=self.rebuilds - rebuilds0, tiers=tiers))
        return U, stats

    def _step_ladder(self, U0, bc_values, load, tstep, tiers):
        opt = self.opt
        fresh = False
        if (self._pinv is None
                or tstep - self._last_rebuild >= self.recompute_tstep):
            self._rebuild(torch.where(self.mask, bc_values, U0), U0, tstep)
            fresh = True
        Ustart = U0
        if (opt.predictor == "extrapolate"
                and self._pred_prev is not None
                and tstep == self._pred_tstep + 1):
            Ustart = U0 + (U0 - self._pred_prev)
        self._pred_prev, self._pred_tstep = U0, tstep
        U, stats = self._newton(U0, Ustart, bc_values, load, opt.max_it)
        r0 = stats["r0"]

        def converged():
            return (stats["residual"] <= opt.atol
                    or stats["residual"] <= opt.rtol * max(r0, 1e-300))

        def again(tier, fine_start, exact=False):
            """Newton from the best state so far, its iterations added."""
            nonlocal r0
            tiers.append(tier)
            it0 = stats["iterations"]
            U1, st = self._newton(U0, U, bc_values, load, opt.max_it,
                                  fine_start, exact)
            st["iterations"] += it0
            r0 = max(r0, st["r0"])
            return U1, st

        coarse32 = opt.residual_dtype in ("f32", "mixed")
        if converged() and coarse32 and not stats["fine"]:
            # a coarse exit claims convergence: certify it with fine
            # residuals (exits at once when the claim holds)
            U, stats = again("certify", True)
        if (not converged() and not self._banded_f64
                and self._last_rel > REL_MAX):
            # reactive factor escalation: Newton stalled under factors the
            # probe had flagged; every later rebuild runs K11
            print("Newton: stall under probe-flagged banded factors "
                  f"(solve quality {self._last_rel:.1e}) - escalating to "
                  "f64 factorization", flush=True)
            self._banded_f64 = True
            self._rebuild(U, U0, tstep)
            fresh = True
            U, stats = again("f64_factors", stats["fine"])
        if (not converged()
                and ((coarse32 and not stats["fine"])
                     or opt.residual_dtype == "f32f")):
            # coarse-phase stall at the float32 residual floor: retry with
            # fine residuals from the first evaluation (f32f: its fine
            # tier is float32-grade too, so any unconverged exit)
            print("Newton: coarse-phase stall at the f32 residual floor "
                  f"({stats['residual']:.3e}) - retrying with exact "
                  "residuals", flush=True)
            res_pre = stats["residual"]
            U, stats = again("fine_retry", True)
            if not converged() and stats["residual"] > 0.9 * res_pre:
                # the float32 direction is the floor: float64 Jacobians
                # and GMRES, then a fresh preconditioner at this state
                print("Newton: stall persists with exact residuals "
                      f"({stats['residual']:.3e}) - escalating to f64 "
                      "Jacobians", flush=True)
                U, stats = again("exact", True, exact=True)
                if not converged():
                    print("Newton: rebuilding preconditioner at the current "
                          "state for the exact retry", flush=True)
                    self._rebuild(U, U0, tstep)
                    U, stats = again("exact_rebuild", True, exact=True)
                return U, stats
        if not converged() and not fresh:
            # stall-triggered rebuild: a preconditioner frozen since an
            # earlier step degrades GMRES on load-jump steps; rebuild at the
            # best mid-Newton state and continue from it
            self._rebuild(U, U0, tstep)
            U, stats = again("stall_rebuild", stats["fine"])
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
