"""Newton-Krylov timesteppers of the iterative path.

Counterpart of vasp_tpu.fem.timestepper: ``StepOptions``, ``make_step_fn``
(one Newton solve per call, preconditioned by Ruiz scales and the 6x6
node-block inverses, K17; float64 element Jacobians every iteration; the
single-device body of vasp_tpu's sharded step), ``IterativeStepper`` with precond="banded" in each factor layout or
precond="ras", its precision ladder, and ``IterativeNewtonSolver``. Each Newton
iteration builds element Jacobians (float32 by default, K3), solves the
Ruiz-equilibrated system (Dr J Dc) y = Dr R by right-preconditioned GMRES
(K5) whose operator is the element matvec (K4) and whose preconditioner is
the banded two-scan apply (K6, or K12 in the Sinv-only layouts) or the
RAS apply (K18), and takes a full-step-first line search on the residual
(K1, K2). A rebuild (every ``recompute_tstep`` steps, or on a stall)
refreshes the preconditioner. Banded: float32 Jacobians -> Ruiz scales and
element rescale (K7) -> banded assembly (K8) -> Schur scan (K9, or the
float64 one, K11, once a step has escalated) -> the layout's factors. RAS:
float64 Jacobians and Ruiz scales (K7 in float64) -> the scaled CSR on the
host -> the subdomain pattern (once) and local blocks on the host -> their
float64 inverses on the device (fem/ras.py).

Banded factor layouts (fem/banded.py banded_layout, read once at
construction from the device's free memory, ``device_free_bytes``): the
full layout (Sinv/H/G in float32, or bf16 with banded_factor_dtype="bf16";
probed, K10), or where it does not fit vasp_tpu's low-memory layouts: the
hybrid one (float32 Sinv, bf16 H/G; assemble, scan, free D, form H, free
C, form G, free B; no probe) and the Sinv-only ones (Sinv in bf16 or
float32 beside bf16 C/B, the folded apply K12; D freed after the scan).
vasp_tpu donates buffers between these phases; the port frees them with
``del``.

Hybrid residual precisions (``residual_dtype``): "f32" evaluates the
residual with float32 element work (K1/K2 f32) while the norm is above
``endgame_factor * atol`` and in float64 below it, "mixed" likewise with
the fine residual float32 on the fluid and float64 on the solid, "f32f"
with a float32 fine residual too; accumulation is float64 in every case.
Under "f32" with ``delta_endgame`` (the default) the fine residuals are
vasp_tpu's Taylor-delta endgame: the first fine evaluation of a Newton call
is raw float64 and its accepted (U, R) the anchor, every later one R(anchor)
plus the order-3 float32 jet delta along U - anchor (K13,
Assembler.residual_delta) and the lifting correction of U - anchor. The
exact tier keeps raw residuals. ``chain_anchor`` carries the anchor across
steps: each step's anchor (its start state and residual) is the previous
step's exit residual advanced by one two-argument delta
(Assembler.residual_delta2, K13's delta2) or, every ``chain_reanchor``
steps and wherever the chain breaks, one raw float64 residual; its fine
residuals are all deltas from that anchor.
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
ages agree with vasp_tpu for Newton calls of at most 8 iterations; the
delta endgame keeps the bound it puts on an anchor's age: after every
NEWTON_CHUNK iterations of one call the port re-anchors with a raw
float64 residual at the current state, as vasp_tpu's next chunk does), the
block_until_ready barriers, the remote-worker gate on the last ladder tier
(the port always takes it, as vasp_tpu does on the CPU), and the 7 GiB
lowmem switch and 11 GiB escalation gate, which the device's free memory
replaces: the reactive escalation (under the full layouts) and, under a
low-memory layout, the exact-stall tier take the float64 factor tier where
banded_layout found it fits, and the float64-Jacobian
tier where those Jacobians fit in the memory free when it is reached
(vasp_tpu skips that tier at low-memory scale).
"""
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vasp_tpu_torch.fem import banded as banded_mod
from vasp_tpu_torch.fem import ras as ras_mod
from vasp_tpu_torch.fem.biharmonic import correction_apply
from vasp_tpu_torch.fem.krylov import gmres
from vasp_tpu_torch.fem.scaling import (
    apply_node_block,
    build_node_block,
    ruiz_scales,
    scale_element_jacobians,
)

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
    # "banded" (fem/banded.py) or "ras" (fem/ras.py)
    precond: str = "banded"
    # banded factor storage (fem/banded.py banded_layout): None (auto),
    # "hybrid", "bf16" or "f32"
    banded_factor_dtype: Optional[str] = None
    # RAS: subdomains (default: ~1500 dofs each) and overlap layers
    n_subdomains: Optional[int] = None
    overlap: int = 2
    # hybrid residuals: fine (exact-grade) residuals once the norm is
    # within endgame_factor * atol
    endgame_factor: float = 30.0
    # the jet Taylor-delta endgame of residual_dtype="f32" (module doc;
    # "mixed" and "f32f" never use it)
    delta_endgame: bool = True
    # GMRES forcing: "fixed" solves every direction to gmres_tol; "ew" is
    # Eisenstat-Walker choice 2, eta = gamma (r_k / r_{k-1})^2 clipped into
    # [gmres_tol, ew_max] with the over-solve floor 0.1 atol / r_k
    forcing: str = "fixed"
    ew_gamma: float = 0.9
    ew_max: float = 1e-2
    # the cross-step anchor chain (residual_dtype="f32" with
    # delta_endgame only): one raw float64 anchor every chain_reanchor
    # steps, the others advanced from the previous step's exit by one
    # two-argument delta (1: raw, chained, raw, ...)
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
        if self.precond not in ("banded", "ras"):
            raise ValueError(f"precond={self.precond!r}: expected 'banded' "
                             "or 'ras'")


def _backtrack_update(U, dx, residual_norm_fn, lmbda, n_halvings=4):
    """Damped Newton update: the candidates U - lmbda 2^-k dx, k < n_halvings,
    and the one with the smallest residual norm (a NaN norm is rejected; the
    first candidate where every norm is inf or NaN)."""
    best_U, best_r = None, None
    for k in range(n_halvings):
        Ut = U - lmbda * (0.5 ** k) * dx
        rt = residual_norm_fn(Ut)
        rt = np.inf if np.isnan(rt) else rt
        if best_r is None or rt < best_r:
            best_U, best_r = Ut, rt
    return best_U, best_r


def _damped_update(U, dx, residual_norm_fn, rnorm_prev, lmbda,
                   n_halvings=4):
    """Full-step-first line search: the full step where its residual is
    finite and below rnorm_prev, else the halving search."""
    Ufull = U - lmbda * dx
    rfull = residual_norm_fn(Ufull)
    if np.isfinite(rfull) and rfull < rnorm_prev:
        return Ufull, rfull
    return _backtrack_update(U, dx, residual_norm_fn, lmbda, n_halvings)


def make_step_fn(assembler, bc_mask, options: StepOptions, layout=None,
                 reduce_fn=None, reduce_max_fn=None):
    """step(U0, bc_values, load) -> (U, stats): one Newton solve from U0
    with bc_values imposed, stats = iterations, residual (the final raw
    residual norm) and r0 (the first one).

    Counterpart of vasp_tpu.fem.timestepper.make_step_fn, its lax.while_loop
    a host loop. Preconditioner: Ruiz scales (K7, options.ruiz_sweeps) of
    the step-start float64 element Jacobians and the node-block inverses of
    the scaled ones (K17); every Newton iteration builds fresh float64
    Jacobians (K3, true Newton) and solves the equilibrated system with
    right-preconditioned GMRES (K5; cycles = max(1, gmres_maxiter //
    gmres_restart)) over the element matvec (K4), then takes the
    full-step-first line search (K1/K2). Convergence is read on the raw
    residual norm (atol, rtol), at most max_it iterations. layout: (n_p2,
    off_p) of the DVP dof layout, inferred from the first cell block if
    omitted; reduce_fn / reduce_max_fn: cross-rank sum and max for the
    sharded path (None on one device)."""
    opt = options
    ndof = assembler.ndof
    dev = assembler.blocks[0].dofs.device
    mask = torch.as_tensor(np.asarray(bc_mask), dtype=torch.bool,
                           device=dev) if not torch.is_tensor(bc_mask) \
        else bc_mask.to(dev)
    red = reduce_fn if reduce_fn is not None else (lambda x: x)
    if layout is not None:
        n_p2, off_p = layout
    else:
        # v-dof indices live in [3 n2, 6 n2): max local-v column = 6 n2 - 1
        n_p2 = (int(assembler.blocks[0].dofs[:, 30:60].max()) + 1) // 6
        off_p = 6 * n_p2

    def step(U0, bc_values, load):
        U1 = torch.where(mask, bc_values.to(U0), U0)
        # the preconditioner from the step-start state; the matvecs' true
        # Jacobian is recomputed every Newton iteration
        jacs0 = assembler.element_jacobians(U1, U0)
        dr, dc = ruiz_scales(assembler.blocks, jacs0, mask, ndof,
                             sweeps=opt.ruiz_sweeps,
                             reduce_max=reduce_max_fn)
        jacs_s = scale_element_jacobians(assembler.blocks, jacs0, dr, dc)
        del jacs0
        pinv = build_node_block(assembler.blocks, jacs_s, mask, n_p2, off_p,
                                ndof, reduce_fn=reduce_fn)
        del jacs_s

        def residual_raw(U):
            R = red(assembler.residual(U, U0)) + load
            return torch.where(mask, 0.0, R)

        def rnorm(U):
            return float(torch.linalg.norm(residual_raw(U)))

        def precond(r):
            return apply_node_block(pinv, r, n_p2, off_p)

        def newton_update(U):
            jacs = assembler.element_jacobians(U, U0)

            def matvec(x):
                t = dc * torch.where(mask, 0.0, x)
                y = red(assembler.matvec(jacs, t))
                return torch.where(mask, x, dr * y)

            Rs = dr * residual_raw(U)
            y, _ = gmres(matvec, Rs, M=precond, restart=opt.gmres_restart,
                         cycles=max(1, opt.gmres_maxiter // opt.gmres_restart),
                         tol=opt.gmres_tol)
            return dc * y

        r0 = rnorm(U1)
        r0_safe = r0 if r0 > 0 else 1.0
        U, it, rn = U1, 0, r0
        while it < opt.max_it and rn > opt.atol and rn / r0_safe > opt.rtol:
            dx = newton_update(U)
            U, rn = _damped_update(U, dx, rnorm, rn, opt.lmbda)
            it += 1
        return U, dict(iterations=it, residual=rn, r0=r0)

    return step


class IterativeStepper:
    """Ruiz + banded- or RAS-preconditioned GMRES Newton, one timestep per
    ``step`` call.

    ``timings`` accumulates wall seconds per phase, each ended by a device
    synchronize on a card: rebuild phases (rebuild_jacobians, ruiz; banded:
    assemble, factorize, hg, cast, probe; RAS: ras_pattern, ras_extract,
    ras_invert) and per-iteration phases (jacobians, residual, gmres, and
    inside gmres its matvec and precond shares; delta, the K13 Taylor
    deltas of the endgame and the chain). ``setup`` holds the
    one-time host seconds (banded: pattern, rcm, plan), ``layout`` the
    banded layout chosen (fem/banded.py BandedLayout; None under RAS),
    ``rebuilds`` the rebuild count, ``gmres_inner`` and ``gmres_cycles``
    the GMRES inner iterations and restart cycles over the run, ``deltas``
    the fine residuals evaluated as Taylor deltas over the run, and
    ``history`` one record per step (Newton iterations, GMRES inner
    iterations and cycles, rebuilds, the ladder tiers taken after the
    first Newton call, whether its last residual was fine-grade, its
    Taylor-delta residuals, and under chain_anchor how its anchor was
    made, "raw" or "chained")."""

    def __init__(self, system, bc_set, options: StepOptions,
                 recompute_tstep=20):
        opt = options
        self.asm = system.assembler
        self.space = system.space
        self.opt = opt
        self.device = system.device
        self.ndof = self.asm.ndof
        self._mask_np = np.asarray(bc_set.mask)
        self.mask = bc_set.mask_on(self.device)
        self.recompute_tstep = int(recompute_tstep)
        self._lift = getattr(system, "lift", None)
        self._jdtype = torch.float32 if opt.jac_dtype == "f32" \
            else torch.float64
        self._last_rebuild = -(10 ** 9)
        self._pinv = None
        self._dr = self._dc = None
        self._last_rel = 0.0
        # set by an escalation: every later rebuild runs K11
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
        self.deltas = 0
        self.layout = None
        self._block_sizes = [tuple(b.dofs.shape) for b in self.asm.blocks]
        # the cross-step anchor chain: this step's anchor (U1, R), the
        # previous step's exit, and the links since the last raw anchor
        self._chain_on = (opt.chain_anchor and opt.residual_dtype == "f32"
                          and opt.delta_endgame)
        self._anc = None
        self._chain_prev = None
        self._chain_age = 10 ** 9  # the first step takes a raw anchor
        if opt.precond == "ras":
            self._n_sub = opt.n_subdomains or max(2, self.ndof // 1500)
            # the subdomain pattern and its apply, built at the first rebuild
            self._apply = None
            return

        block_dofs = [b.dofs.cpu().numpy() for b in self.asm.blocks]
        tic = time.perf_counter()
        self._bpat = banded_mod.build_banded_pattern(
            block_dofs, self.ndof, timings=self.setup)
        self.setup["pattern"] = time.perf_counter() - tic
        free = banded_mod.device_free_bytes(self.device)
        self.layout = banded_mod.banded_layout(
            self._bpat, self._block_sizes, free, opt.banded_factor_dtype)
        lay = self.layout
        print(f"banded preconditioner: {lay.layout} layout at c="
              f"{self._bpat.c}, nb={self._bpat.nb}: needs "
              f"{lay.bytes / 2**30:.2f} GiB (the full layout "
              f"{lay.full_bytes / 2**30:.2f} GiB) with "
              f"{free / 2**30:.2f} GiB free; f64 factor tier "
              f"{'fits' if lay.f64_fits else 'does not fit'} "
              f"({lay.f64_bytes / 2**30:.2f} GiB)", flush=True)
        tic = time.perf_counter()
        plans = banded_mod.build_banded_assembly_plan(
            block_dofs, self._bpat, self._mask_np)
        self.setup["plan"] = time.perf_counter() - tic
        self._plans = banded_mod.plans_to_device(plans, self.device)
        self._diag_flat = torch.as_tensor(
            banded_mod.identity_diag_slots(self._bpat, self._mask_np),
            device=self.device)
        if lay.layout in ("bf16", "f32"):
            self._apply = banded_mod.make_banded_apply_lowmem(self._bpat,
                                                              self.device)
        else:
            self._apply = banded_mod.make_banded_apply(self._bpat,
                                                       self.device)

    @property
    def lowmem(self):
        """A low-memory banded layout holds the factors."""
        return self.layout is not None and self.layout.layout != "full"

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
        if self.opt.precond == "ras":
            self._pinv = self._rebuild_ras(U, U0)
        else:
            self._pinv = self._rebuild_banded(U, U0)
        self._last_rebuild = tstep
        self.rebuilds += 1

    def _rebuild_banded(self, U, U0):
        """The factors of the layout. The tensors each phase leaves behind
        are freed with del as soon as the next phase is done with them."""
        asm, mask, layout = self.asm, self.mask, self.layout.layout
        with self._timed("rebuild_jacobians"):
            jacs = asm.element_jacobians(U, U0, dtype=torch.float32)
        with self._timed("ruiz"):
            dr, dc = ruiz_scales(asm.blocks, jacs, mask, self.ndof,
                                 sweeps=self.opt.ruiz_sweeps)
            jf = scale_element_jacobians(asm.blocks, jacs, dr, dc)
            del jacs
        self._dr, self._dc = dr.to(torch.float64), dc.to(torch.float64)
        with self._timed("assemble"):
            Cm, Dm, Bm = banded_mod.assemble_banded_planned(
                jf, self._plans, self._bpat, self._diag_flat)
            del jf
        with self._timed("factorize"):
            if self._banded_f64:
                Sinv = banded_mod.schur_scan_f64(Cm, Dm, Bm)
            else:
                bf16 = (layout == "bf16"
                        or self.opt.banded_factor_dtype == "bf16")
                Sinv = banded_mod.schur_scan(
                    Cm, Dm, Bm, torch.bfloat16 if bf16 else torch.float32)
        if layout == "full":
            with self._timed("hg"):
                H, G = banded_mod.hg_factors(Sinv, Cm, Bm)
            if not self._banded_f64:
                # vasp_tpu probes only the float32 recursion's factors
                with self._timed("probe"):
                    self._last_rel = banded_mod.probe_rel(Cm, Dm, Bm, Sinv,
                                                          H, G)
            return Sinv, H, G
        del Dm
        if layout == "hybrid":
            with self._timed("hg"):
                H = banded_mod.sinv_times(Sinv, Cm, torch.bfloat16)
                del Cm
                G = banded_mod.sinv_times(Sinv, Bm, torch.bfloat16)
                del Bm
            return Sinv, H, G
        # Sinv-only: C and B in bf16 for the folded apply (K12)
        with self._timed("cast"):
            Cm = Cm.to(torch.bfloat16)
            Bm = Bm.to(torch.bfloat16)
        return Sinv, Cm, Bm

    def _rebuild_ras(self, U, U0):
        """float64 element Jacobians and Ruiz scales, the scaled CSR on the
        host, the pattern (at the first rebuild), the local blocks and
        their inverses in the Jacobian dtype."""
        import scipy.sparse as sp

        asm = self.asm
        with self._timed("rebuild_jacobians"):
            jacs = asm.element_jacobians(U, U0)
        with self._timed("ruiz"):
            dr, dc = ruiz_scales(asm.blocks, jacs, self.mask, self.ndof,
                                 sweeps=self.opt.ruiz_sweeps)
        self._dr, self._dc = dr, dc
        with self._timed("ras_extract"):
            A = asm.to_csr(jacs, bc_mask=self._mask_np)
            del jacs
            A_s = (sp.diags(dr.cpu().numpy()) @ A
                   @ sp.diags(dc.cpu().numpy())).tocsr()
        if self._apply is None:
            with self._timed("ras_pattern"):
                pat = ras_mod.build_pattern_auto(
                    (abs(A_s) + abs(A_s.T)).tocsr(), self.ndof, self._n_sub,
                    overlap=self.opt.overlap, coords=self._dof_coords())
                self._ras_pattern = pat
                self._apply = ras_mod.make_apply(pat, self.device)
            print(f"RAS preconditioner: S={pat.n_subdomains} subdomains of "
                  f"m={pat.local_size} local dofs ({self._n_sub} subdomains "
                  f"at overlap {self.opt.overlap} asked)", flush=True)
        with self._timed("ras_extract"):
            blocks = ras_mod.extract_local_blocks(A_s, self._ras_pattern,
                                                  self._mask_np)
        with self._timed("ras_invert"):
            return (ras_mod.invert_blocks(blocks, self._jdtype, self.device),)

    def _dof_coords(self):
        """(ndof, 3) coordinates of every mixed dof: d and v components at
        their P2 node, p at its vertex (compact spatial subdomains keep
        every field of a location together, which the saddle-point local
        solves need)."""
        sp_ = self.space
        xy2 = np.asarray(sp_.p2_coords)
        dv = np.repeat(xy2, 3, axis=0)  # dof = 3*node + comp layout
        return np.concatenate([dv, dv, xy2[: sp_.n_p1]], axis=0)

    def _f64_jacobians_fit(self):
        """The exact tier's float64 element Jacobians and float64 Krylov
        basis fit in the device memory free now."""
        need = (banded_mod.element_jacobian_bytes(self._block_sizes, 8)
                + 8 * (self.opt.gmres_restart + 1) * self.ndof)
        return need <= banded_mod.device_free_bytes(self.device)

    # -------------- Newton --------------
    def _residual(self, U, U0, load, dtype=None):
        with self._timed("residual"):
            R = self.asm.residual(U, U0, dtype) + load
            if self._lift is not None:
                R = R + correction_apply(self._lift, U)
            R = torch.where(self.mask, 0.0, R)
            return R, float(torch.linalg.norm(R))

    def _delta(self, U, A, RA, U0):
        """The fine residual of U from the exact anchor (A, RA) of the step
        from U0: RA plus the K13 Taylor delta along U - A and the lifting
        correction of U - A, masked; (R, its norm)."""
        self.deltas += 1
        with self._timed("delta"):
            d = self.asm.residual_delta(U, A, U0)
            if self._lift is not None:
                d = d + correction_apply(self._lift, U - A)
            R = torch.where(self.mask, 0.0, RA + d)
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
        iteration's residual was fine-grade), rfine (the best state's was)
        and R (the best state's residual vector: the anchor chain goes on
        from it).

        Hybrid residual precisions: coarse (float32 element work) residuals
        until the norm is within endgame_factor * atol, fine ones from then
        on (float32 under f32f, mixed under mixed, float64 under f32);
        fine_start=True takes fine ones from the first evaluation. Under
        f32 with delta_endgame the first fine residual is raw float64 and
        anchors the later ones, which are Taylor deltas from it, the anchor
        renewed raw after every NEWTON_CHUNK iterations; under the anchor
        chain every fine residual is a delta from the step's anchor.
        exact=True: float64 Jacobians and float64 GMRES with the exact
        tier's tolerance and cycles, its fine residuals raw float64."""
        opt = self.opt
        jdt = torch.float64 if exact else self._jdtype
        rec = max(1, int(opt.recompute))
        hybrid = opt.residual_dtype in ("f32", "mixed", "f32f")
        fine_dt = None if exact else {"mixed": "mixed", "f32f": torch.float32
                                      }.get(opt.residual_dtype)
        endgame = opt.endgame_factor * opt.atol
        use_delta = (hybrid and opt.delta_endgame and not exact
                     and fine_dt is None)
        chained = self._chain_on and not exact
        # the in-loop anchor of the delta endgame: (state, residual) or None
        anchor = None

        def residual(U, fine):
            if not hybrid:
                return self._residual(U, U0, load)
            if not fine:
                return self._residual(U, U0, load, torch.float32)
            if fine_dt is not None:
                return self._residual(U, U0, load, fine_dt)
            if chained:
                return self._delta(U, *self._anc, U0)
            if use_delta and anchor is not None:
                return self._delta(U, *anchor, U0)
            return self._residual(U, U0, load)

        U = U1 = torch.where(self.mask, bcv, Ustart)
        R, rnorm = residual(U, fine_start)
        if hybrid and not fine_start and rnorm < endgame:
            # the ENDGAME refine of R0
            R, rnorm = residual(U, True)
        fine = not hybrid or fine_start or rnorm < endgame
        if use_delta and not chained and fine:
            # R0 is raw float64 here: (U1, R0) is an exact anchor
            anchor = (U, R)
        r0 = rnorm
        r0_safe = r0 if r0 > 0 else 1.0
        Ub, Rb, rb, rbfine = U, R, rnorm, fine
        stall, it, eta = 0, 0, opt.gmres_tol
        # a stall is a residual not decreasing; the exact variant counts
        # only near-zero progress as one
        sthr = 0.98 if exact else 0.9
        use_carry = opt.jac_carry and rec > 1 and not exact
        jacs, age = (self._jac_carry if use_carry and self._jac_carry
                     is not None else (None, 0))

        def going():
            return (it < it_cap and rnorm > opt.atol
                    and rnorm / r0_safe > opt.rtol and stall < 2)

        while going():
            if (anchor is not None and it > 0
                    and it % self.NEWTON_CHUNK == 0):
                # vasp_tpu's next dispatch chunk starts from a raw float64
                # residual, which renews the anchor: its age stays bounded
                R, rnorm = self._residual(U, U0, load)
                anchor = (U, R)
                if Ub is U:
                    Rb, rb = R, rnorm
                if not going():
                    break
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
            if use_delta and not chained and fine and anchor is None:
                # the first fine residual of the call was raw: anchor there
                anchor = (U, R)
            stall = stall + 1 if rn > sthr * rnorm else 0
            if rn < rb:
                Ub, Rb, rb, rbfine = U, R, rn, fine
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
                        rfine=rbfine or exact, R=Rb)

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
    # vasp_tpu's per-dispatch Newton bound, kept here only as the delta
    # endgame's re-anchoring period
    NEWTON_CHUNK = 8

    def step(self, U0, bc_values, load, tstep):
        """One timestep from U0; returns (U, stats)."""
        inner0, cycles0 = self.gmres_inner, self.gmres_cycles
        rebuilds0, deltas0 = self.rebuilds, self.deltas
        tiers = []
        anchor = (self._setup_anchor(U0, bc_values, load, tstep)
                  if self._chain_on else None)
        U, stats = self._step_ladder(U0, bc_values, load, tstep, tiers)
        if self._chain_on:
            # the exit pair, from which the next step's anchor may chain
            self._chain_prev = dict(tstep=tstep, U=U, R=stats["R"], U0=U0,
                                    load=load, grade=bool(stats["rfine"]))
        self.history.append(dict(
            tstep=tstep, iterations=stats["iterations"],
            gmres_inner=self.gmres_inner - inner0,
            gmres_cycles=self.gmres_cycles - cycles0,
            rebuilds=self.rebuilds - rebuilds0, tiers=tiers,
            fine=bool(stats["fine"]), deltas=self.deltas - deltas0,
            anchor=anchor))
        return U, stats

    def _setup_anchor(self, U0, bc_values, load, tstep):
        """This step's exact anchor (U1, R(U1)) under the anchor chain:
        advanced from the previous step's exit (U_exit, R_exit) by one
        two-argument Taylor delta where the chain holds (the previous step
        was tstep - 1, its exit is this step's U0 and fine-grade, and fewer
        than chain_reanchor links since the last raw anchor), as
        R_exit + mask0(load - load_prev + residual_delta2(U1, U_exit,
        U_exit, U0_prev) + lift(U1 - U_exit)); else one raw float64
        residual. Returns "chained" or "raw"."""
        U1 = torch.where(self.mask, bc_values, U0)
        prev = self._chain_prev
        if (prev is not None and prev["tstep"] == tstep - 1
                and prev["grade"] and prev["U"] is U0
                and self._chain_age < self.opt.chain_reanchor):
            with self._timed("delta"):
                d = self.asm.residual_delta2(U1, prev["U"], prev["U"],
                                             prev["U0"])
                corr = load - prev["load"] + d
                if self._lift is not None:
                    corr = corr + correction_apply(self._lift, U1 - prev["U"])
                R = prev["R"] + torch.where(self.mask, 0.0, corr)
            self._chain_age += 1
            kind = "chained"
        else:
            R, _ = self._residual(U1, U0, load)
            self._chain_age = 0
            kind = "raw"
        self._anc = (U1, R)
        return kind

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
        if (not converged() and not self.lowmem and not self._banded_f64
                and self._last_rel > REL_MAX and self.layout.f64_fits):
            # reactive factor escalation: Newton stalled under factors the
            # probe had flagged; every later rebuild runs K11 (banded only:
            # RAS takes no probe; the low-memory layouts take none either),
            # where its float32 factors fit (6 F, where the bf16 full
            # layout holds 4.5 F)
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
                if self.lowmem:
                    if self.layout.f64_fits and not self._banded_f64:
                        # a stall that survives exact residuals is the
                        # broken-float32-factor signature where no probe
                        # was taken: the float64 factor tier first
                        print("Newton: stall persists with exact residuals "
                              f"({stats['residual']:.3e}) - escalating to "
                              "f64 factorization (small-bandwidth lowmem)",
                              flush=True)
                        self._banded_f64 = True
                        res_pre2 = stats["residual"]
                        self._rebuild(U, U0, tstep)
                        U, stats = again("f64_factors", True)
                        if converged():
                            return U, stats
                        if stats["residual"] > 0.5 * res_pre2:
                            # the factors were not the floor: no float64
                            # rebuilds for the rest of the run
                            self._banded_f64 = False
                    if not self._f64_jacobians_fit():
                        print("Newton: stall persists with exact residuals "
                              f"({stats['residual']:.3e}); f64-Jacobian "
                              "escalation skipped (problem too large for "
                              "f64 jacfwd)", flush=True)
                        return U, stats
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
    ("gmres", "iterative", "ras"; the preconditioner is StepOptions.precond,
    the config key "precond"), with NewtonSolver's solve() contract and one
    contract line per step. world > 1 (the process group's ranks, each
    calling the solver alike) takes vasp_tpu's sharded path,
    parallel/banded_shard.py's ShardedBandedStepper with the banded
    preconditioner whatever precond says, shard_algo its algorithm and
    spike_refine the SPIKE apply's refinement passes."""

    def __init__(self, system, bc_set, step_options: StepOptions,
                 recompute_tstep: int = 20, verbose: bool = True,
                 raise_on_fail: bool = True, world: int = 1,
                 shard_algo: str = "chain", spike_refine: int = 2):
        if world > 1:
            from vasp_tpu_torch.parallel.banded_shard import (
                ShardedBandedStepper,
            )

            if getattr(system, "lift", None) is not None:
                raise NotImplementedError(
                    "biharmonic lifting is not supported on the sharded "
                    "path yet; use extrapolation=laplace/elastic or run "
                    "single-device")
            self.stepper = ShardedBandedStepper(
                system, bc_set, step_options,
                recompute_tstep=recompute_tstep, algo=shard_algo,
                spike_refine=spike_refine)
        else:
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
