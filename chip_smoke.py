#!/usr/bin/env python3
"""Smoke run of vasp_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. Device: needs torch.cuda; prints the card's name and power limit and
   builds the CUDA kernels from csrc/ (one nvcc per source, in parallel;
   build seconds, ptxas register and spill report); the SASS of the
   float32 residual instances (the fluid with Laplace, elastic and no mesh
   lifting, the solid in St.Venant-Kirchhoff and in Mooney-Rivlin, and
   the Robin facet term) and of the float32 biharmonic lifting correction
   (K16) must hold no float64 arithmetic, and K13's Jet3 instances none
   but the du (and du0) differences taken before their rounding.
2. Kernel vs plain on the card at the 20,832-cell tube (184,845 dofs):
   every kernel against its plain torch version on the same inputs, each
   timed with CUDA events beside its plain version, its bound (bytes over
   3.35 TB/s or operations over the peak of their type, the larger; the
   element kernels' bytes count the entries their block touches) and a
   one-call torch yardstick where one exists (cuSPARSE's SpMV of the same
   matrix for the element matvec, scatter_reduce_ "amax" of the gathered
   |dr A dc| for K7's sweep, index_add_ of the gathered in-band entries
   for K8). Tolerances, each with its reason:
   - float64 outputs (K1, K2, K3, K4 f64, K19): 1e-12 relative; the f64
     atomics' order varies, nothing else;
   - float32 element residuals (K1/K2 f32): as accurate as the plain
     version, ||R_kernel - R_plain|| <= 2 ||R_plain - R_f64|| + 1e-14
     ||R_f64||; both are float32 element work summed in float64, in other
     orders;
   - float32 Jacobians (K3 f32): 2e-7 per cell block; both sides round
     float64 values that agree to 1e-12 once, so they are at most one
     float32 ulp apart;
   - float32 element products (K4 f32): 1e-5 relative; 64-term float32
     row sums in another order than torch's;
   - K7 (Ruiz sweep and scale) and K8 (banded assembly): exact; max is
     exact, the products are the same two float32 multiplies, and the
     banded sums run in plan order on both sides (K8's plain version runs
     on the host here, since torch's index_add_ on the card sums by
     atomics);
   - K6 (banded apply): as accurate as the plain version, i.e. its
     distance to the same scans in float64 at most twice the plain
     version's plus 1e-6; both sum c-term float32 dot products, in other
     orders, through 2 nb - 1 scan steps.
   The Schur scan (K9, cuBLAS/cuSOLVER through torch), H/G and the probe
   (K10) are timed on the same factors, and beside them the escalation
   tier's float64 scan (K11, torch in float64), whose factors must probe
   no worse than K9's; its first two blocks against the same recursion on
   the host, 1e-5 relative (float32 roundings of float64 inverses from
   cuSOLVER and LAPACK).
   Then, at the 20,832-cell aneurysm tube (1,984 Robin facets on marker
   33): the Robin facet residual (K14, f64 1e-12, f32 by the K1/K2 f32
   rule) and its Jacobians (f64 1e-12, f32 2e-7 per block), K4 at the
   facet blocks' 36 local dofs in its four dtype instances (the K4
   tolerances; cuSPARSE's SpMV of the facet matrix as a yardstick), K7 at
   36 (exact), and the DG0 projection of det(I + grad d) (K19c, 1e-12) on
   a displacement with strains ~1e-2. The facet kernels' bounds count the
   bytes of the entries the facet blocks touch, not whole vectors.
   Then, at the 20,832-cell predeform tube (-p predeform's generated
   tube at n_theta=16, n_z=62), the Mooney-Rivlin solid's K2 (f64 1e-12,
   f32 by the K1/K2 f32 rule: the float32 instance held to the plain
   float32 version's distance from float64, no looser) and K3 (f64
   1e-12, f32 2e-7 per block), on a displacement with strains ~1e-2 so
   that the log1p and cofactor terms count; once with the predeform
   wall's constants and once with the AVF vein's (the "vein" variant).
   Then, back at the 20,832-cell tube, the fluid's elastic-lifting and
   no-lifting instances of K1/K3 (the rules of K1/K3 above), the
   pressure stabilization (p_stab=0.1) on the Laplace and on the elastic
   instance and the solid's gravity ([0, 0, -9.81]) as variants of the
   instances they run in (the same checks and times),
   and the biharmonic lifting correction (K16) on the tube's bc1 tables
   (beta = 1, 14,880 fluid cells) in float64 (1e-12) and float32 (as
   accurate as the plain version: its distance to the float64
   correction of the same input at most twice the plain version's plus
   1e-14 of it), with cuSPARSE's SpMV of the correction's assembled CSR
   as the yardstick. Then, on K9's factors at the 20,832-cell tube, K6 in
   its hybrid (f32 Sinv, bf16 H/G) and all-bf16 storage instances and K12
   (the folded apply of the Sinv-only layouts, bf16 C/B) with bf16 and
   with f32 Sinv, each by K6's rule against the float64 scans on the same
   widened factors, the probe of the bf16 factors, and K7's float64
   sweep (exact; at 36 local dofs too).
3. Path parity: the tiny cylinder of tests/conftest.py run on the CPU
   (plain versions; the CPU sides of this phase run in
   CPU_REFERENCE_PROCESSES processes of their own at CPU_REFERENCE_THREADS
   torch threads each, started after phase 2, so that they overlap only
   this phase's card runs and phase 2's times are taken on an idle host)
   and on the card
   (kernels), on the LU path (U within
   1e-8 relative), on the Newton-Krylov path (linear_solver="gmres"; U
   within 3e-5 relative: one inexact Newton step per time step, its
   direction solved to gmres_tol = 1e-6, with float32 sums in other
   orders) and on the bench configuration (f32f residuals, float32 Krylov,
   gmres_tol = 1e-3; U within 3e-2 relative: 30 x gmres_tol as on the
   gmres path, by the same argument): the same Newton iteration counts
   and ladder tiers. Then two forced ladder runs on a small tube of
   bench.py's physics, each from factors damaged before its first step
   (every Sinv entry scaled by 1 + 5 u, so that every tier fires for a
   reason that does not depend on rounding): under a flagged probe at
   atol 1e-8 (the K11 escalation), and with f32f at atol 1e-11, under
   the float32 residual floor (the fine retry, the exact tier and the
   rebuild-at-current-state retry); the same tiers and Newton counts on
   the CPU and the card, U within 1e-5 relative (the escalation run ends
   on float32 GMRES directions at a residual near 5e-10; measured 6e-7).
   The launch counters are reset before the card's forced runs and read
   after them: the ladder's own path. Then the tiny aneurysm of
   tests/test_torch_driver_aneurysm.py (Robin facet blocks) on the LU
   path (U within 1e-8 relative; counters reset just before the card's
   run and read just after: the f64 Robin kernels' path; then those two
   kernels against their plain versions on that run's facet block, rule
   and final state, 1e-12) and on the bench configuration (U within
   3e-2), the same Newton counts. Then, on the LU path (U within 1e-8,
   the same Newton counts; counters reset just before the card's run and
   read just after: the f64 Mooney-Rivlin kernels' path), the tiny
   predeform of tests/test_driver_predeform.py (theta=1, lmbda=0.5, its
   raise_on_fail=False) and the tiny AVF of tests/test_torch_driver_avf.py
   (tests/test_driver_avf.py's cut to 2 steps and 1,536 cells, whose host
   splu takes minutes at its own size). Then the lifting options of the
   tiny cylinder, cut to one step, on the LU path (U within 1e-8, the
   same Newton counts):
   biharmonic lifting at its defaults (bc1, beta = 1); elastic lifting
   with p_stab=0.1 and gravity [0, 0, -9.81] in one run; and no lifting
   (extrapolation="no_extrapolation", through a problem file that holds
   every fluid-only d dof at 0), also on the bench configuration (its 3
   steps, U within 3e-2); counters reset just before each card run and read just after
   (the f64 elastic and no-lifting instances' paths, and the float32
   no-lifting ones').
   Then IterativeStepper on the forced ladder's small tube, one ramped
   step on the CPU and on the card with the tests' options (float64
   residuals, gmres_tol 1e-8): the hybrid, bf16 and f32 Sinv-only layouts
   (fem/banded.py device_free_bytes reading one byte short of the full
   layout's peak on both), the full layout in bf16, and RAS with float64
   inverses at vasp_tpu's other defaults; the same layout and storage,
   Newton counts and tiers, U within 3e-5 relative; counters reset just
   before each card run and read just after (the paths of K6's storage
   instances, K12 and K18's float64 instance).
4. The LU path: driver.main on -p cylinder at a 2,520-cell tube (a
   cylinder of 10 layers; its host splu takes under a minute on a
   CPU core, where the 11,088-cell tube's took 700 s), 5 steps of dt=1e-3,
   launch counters reset just before and read just after; every step
   must converge, U must be finite and every kernel of the path must
   have launched.
5. The Newton-Krylov path at size: driver.main on -p cylinder with
   linear_solver="gmres" at the 20,832-cell tube, 5 steps of dt=1e-3 (one
   preconditioner rebuild), counters reset just before and read just
   after; every step must converge, U must be finite and on the card, and
   every kernel of the path must have launched. Prints s/step, Newton
   and GMRES inner iterations per step, the rebuild and per-iteration
   time splits, GMRES's bound per direction (K5: its matvecs and applies
   at the K4 and K6 bounds plus the bytes of its CGS2 projections, spread
   as evenly over the restart cycles as the counts allow), the probe,
   peak device memory and the one-time host setup (pattern, RCM,
   assembly plan). Then one more step under torch.profiler: the device's
   busy share of that step's wall time (the sum of device time over the
   step's kernels and copies, which run on one stream) and its five
   costliest device functions.
6. The bench configuration through the driver: -p cylinder at the
   20,832-cell tube, 5 steps, with bench.py's options as config keys
   (linear_solver="gmres", residual_dtype="f32f", krylov_dtype="f32",
   gmres_tol=1e-3, gmres_restart=60, gmres_maxiter=120, jac_recompute=2,
   atol=rtol=1e-6, max_it=12); the same checks and lines as phase 5.
7. The bench tube of bench.py (the stenosed 20,832-cell tube, quadrature
   degree 3, its Dirichlet sets, the 150x interface load ramped over 6
   steps) through the port's IterativeStepper with the same options, 6
   ramp steps and 3 more; counters reset just before and read just after;
   every step must converge; the same lines as phase 5.
8. The models: driver.main on -p offset_stenosis (its FSI sphere over the
   throat, fsi_region=[0, 0, 0.012, 0.01]) and -p aneurysm at 20,832
   cells (generated_mesh_params n_theta=16, n_r_fluid=3, n_r_solid=1,
   n_z=62) on the bench configuration, 5 steps of dt=1e-3; the checks and
   lines of phase 5, every step's minimum Jacobian positive, and the last
   step's probe and minimum-Jacobian lines. The stenosis runs through a
   problem file whose post_solve keeps each step's state on the card for
   phase 10 (no second run, no HDF5).
9. The Mooney-Rivlin models, counters reset just before each run and read
   just after, the checks and lines of phase 5:
   - -p predeform at 20,832 cells on the bench configuration with the
     config's max_it=50 (lmbda=0.5 halves the residual per iteration) and
     its ramps shifted so that pressure is on within the run (t_end_v =
     t_start_p = 0.02, t_end_p = 0.72: production's 0.7 s ramp at its
     dt = 0.01), 5 steps, raise_on_fail=False: vasp_tpu on the CPU does
     not converge on these options either (a 1,440-cell tube: step 2
     climbs every ladder tier and ends at 1.194e-6 > atol 1e-6,
     tests/diag_predeform_bench_options.py), so a step may end
     unconverged, and must then end below 5e-5, the atol
     tests/test_driver_predeform.py holds this theta=1 MR inflation to;
     the ladder tiers printed; the final minimum Jacobian positive and
     the wall moved outward;
   - the prestress chain in memory: the vertex coordinates minus the
     final displacement (postprocessing/mesh_stages.predeform_mesh's
     arithmetic; the card's machine has no h5py), 5 re-inflation steps on
     that mesh through the driver (a problem file); the minimum Jacobian
     positive, the wall outward, |d'|/|d| in 0.3-3
     (tests/test_driver_predeform.py's bar);
   - -p avf on its generated Y mesh at 22,656 cells (17,664 if the card's
     memory check refuses the banded preconditioner, with the reason
     printed), 5 steps of dt=1e-4 with its ramps shortened so that flow
     and pressure are on within them (inflow over 1e-3 s, pressure over
     2e-4-1.2e-3 s; its own 0.2 s ramps leave 5 steps at rest); every
     step's minimum Jacobian positive, the last step's probe and
     minimum-Jacobian lines.
   The chain's problem file keeps each step's state, as phase 8's does.
10. Postprocessing (K20a-c), counters reset just before the card's pass
   and read just after: phase 8's stenosis series (St.Venant-Kirchhoff)
   and phase 9's chain series (Mooney-Rivlin) postprocessed in memory
   through the port's functions (the hemodynamic indices and WSS series,
   the stress/strain fields with their largest eigenvalues, the band-pass
   strain amplitudes, the PSD and spectrogram of |v| at up to 10,000 fluid
   nodes), on the card and on the CPU: every output within 1e-12 of its
   scale; within 1e-10 the eigenvalues and the band-pass amplitudes (acos
   near r = +-1 turns a rounding change of r into ~1e-8 of p) and OSI,
   RRT and ECAP (the mean WSS vector cancels over a reversing series, and
   RRT is its inverse); every K20 kernel launched. Then the WSS series
   and the stress/strain fields again on 2 gloo ranks sharing the card
   (the timestep-sharded pass, parallel/steps.py, started by
   bootstrap.spawn_world, each rank's counters reset just before its pass
   and read just after): within 1e-13 of the one-rank pass's scale
   (TOL_SHARDED_POST), K20a and K20b launched on each rank. Then each K20
   kernel against its plain version at production shapes, timed: K20a on a
   seeded 951-step velocity series (-p offset_stenosis's T = 0.951 s at
   dt = 1e-3) at the stenosis tube, with the host part (the loads' copy
   and the boundary-mass splu solves) timed apart; K20b in SVK at that
   tube and in Mooney-Rivlin at the chain's, on seeded 951-step
   displacements; its eigenvalue entry on the (23,808 points, 951 steps)
   strain tensors; K20c on a 10,000 x 951 spectrogram at the CLIs'
   windowing (NFFT 256, nfft 512, 11 frames; cuFFT's rfft of the frames
   timed beside it) and the PSD as a variant.
11. Mesh lifting at full width, counters reset just before each run and
   read just after, every step converged, the lines of phase 5, launches
   and peak memory:
   - 11a: -p aneurysm at 20,832 cells with biharmonic lifting (bc2,
     biharmonic_beta=1e-2: tests/test_biharmonic.py's Krylov case) on the
     bench configuration, 5 steps of dt=1e-3 (K16 in float64 in every
     residual, in float32 in every matvec);
   - 11b: -p cylinder on the 2,520-cell tube of phase 4 with biharmonic
     lifting at its defaults (bc1, beta = 1) on the LU path, 3 steps; the
     host splu seconds beside phase 4's (the correction's 2-ring stencil
     adds fill);
   - 11c: -p cylinder at 20,832 cells with elastic lifting on the bench
     configuration, 5 steps (the float32 elastic instances of K1/K3).

12. The banded layouts and RAS at full width, counters reset just before
   each run and read just after, every step converged, the lines of
   phase 5 or 7, the layout chosen with its bytes and the peak memory:
   - 12a: phase 6's bench configuration with a ballast allocation made
     before the system is built that leaves the card's free memory midway
     between the hybrid layout's need and the full one's: the hybrid
     layout (K6 hybrid in every apply); GMRES inner iterations beside
     phase 6's;
   - 12b: phase 7's bench tube through IterativeStepper with
     banded_factor_dtype="bf16" and a ballast midway between the bf16
     Sinv-only layout's need and the full bf16 one's: K12 in every apply;
   - 12c: the same without a ballast: the full layout in bf16, probed
     (the reactive escalation prints if it fires);
   - 12d: RAS at vasp_tpu's defaults. At the 20,832-cell cylinder the
     subdomain pattern alone (the float64 rebuild Jacobians, Ruiz and the
     scaled CSR, then build_pattern at vasp_tpu's first try and at overlap
     1 against its budget; the retries run on far past it) and, as an
     extra measurement, K18 against its plain version on the overlap-1
     pattern with seeded inverses; then two converging steps on the small
     tube of phase 3, the largest generated tube on which RAS converges in
     either package, and K18 (f32, and f64 on the same inverses widened)
     against its plain version at that run's pattern and inverses: the
     kernels line's K18 records.

13. NewtonSolver's Krylov branch (K22) and make_step_fn (K17), counters
   reset just before each run and read just after:
   - 13a: driver.main on -p cylinder at the 20,832-cell tube with
     linear_solver="krylov" (element-block additive Schwarz and GMRES at
     vasp_tpu's defaults: gmres_tol 1e-4, restart 50, 400 restarts), one
     step, max_it=2 (each solve spends its 400 restarts, ~25 s),
     raise_on_fail=False: Newton iterations, GMRES
     restarts and Arnoldi iterations, the rebuild by phase (float64
     Jacobians, K22's build, the inverses) and the per-iteration costs.
     The branch may stall (its element blocks are singular where a
     block's pressure rows or mesh lifting carry no equation, in vasp_tpu
     too: tests/diag_newton_krylov.py); a stall is a finding, and the
     phase fails only on non-finite values, a kernel mismatch or a
     missing launch;
   - 13b: make_step_fn at the 20,832-cell tube (bench.py's physics
     without the stenosis, the 150x interface load), one step at
     StepOptions' defaults: iterations, residual and r0 (the same rule on
     stalls);
   - 13c: at that tube's shapes (its float64 Jacobians at a seeded
     state, both 64-wide cell blocks), K22's build, apply and divide,
     K7's float64 scale and K17's extract, invert and apply against their
     plain versions, float64 to 1e-12 relative (K7 exact; K17's inverse
     per node, against its largest entry), each timed beside its bound
     and plain version, with torch.linalg.inv of K22's modified blocks
     (the branch's inverse) and of K17's node blocks, cuSPARSE's SpMV of
     the assembled Schwarz operator, torch.div (K22's divide, also timed
     with the divide replayed from a CUDA graph), torch.bmm and, for
     K17's extract, index_add_ of the cells' pre-gathered 6x6 node blocks
     (K8's convention) as yardsticks; and fem/preconditioner.py's build
     (K22 at eps 1e-8,
     float32 inverses) equal to the same on the plain K22.
   Phase 3 also runs, on the CPU and on the card, the Krylov branch on a
   transient flow in a rigid pipe (tests/test_torch_schwarz.py's case
   and GMRES options: gmres_tol 1e-8, 10 restarts; U within 1e-10) and
   make_step_fn on its small tube at tests/test_sharded_step.py's step
   options with atol and rtol 2e-11 (STEP_FN_OPTS; U within 1e-8): the
   same Newton counts, each converged.

14. The Taylor-delta endgame (K13) and the cross-step anchor chain,
   counters reset just before each run and read just after, each step's
   raw float64 residual norm at its exit state printed beside the
   reported one (jet's derivative convention: the delta's second- and
   third-order terms count 2x and 6x, so a fine residual built on it is
   not R64 at its state; ROADMAP.md queue 3):
   - 14a: -p cylinder at the 20,832-cell tube with bench.py's options and
     residual_dtype="f32" (delta_endgame at its default), 5 steps: Newton
     and GMRES counts, fine flags, tiers and K13's launches per step;
     every step converged, and every Taylor-delta residual a step took
     launched K13 on both cell blocks (so K13 ran on every step that went
     on past its raw anchor, and on no other);
   - 14b: the same with chain_anchor=True, 4 steps: K13's delta2 launched
     once a cell block at each chained anchor and never at a raw one, at
     least one chained step;
   - 14c: K13 against its plain version (three nested torch.func.jvp) at
     the 20,832-cell tube's fluid (Laplace) and SVK blocks, the predeform
     tube's Mooney-Rivlin wall (strains ~1e-2) and the aneurysm tube's
     Robin facets (K14's float32 residual of du), each as delta and
     delta2, at seeded states with du and du0 at 1e-3 of their scales:
     the float32 rule in the max norm, max|D_kernel - D_plain| <= 2
     max|D_plain - D_f64| + 1e-12 max|D_f64| (D_f64 the same series in
     float64). Each timed beside its plain version, the raw float64
     residual of the same block at the same state (the work K13 stands in
     for) and its bound: the bytes of the entries it touches, and the
     operations of the kernel's own Taylor arithmetic, counted by
     dispatching the float32 cell once and weighting each op by what
     Jet3 does for it where a series flows through (count_ops; the
     nested-jvp plain version does several times that work);
   - 14d: the tiny aneurysm and tiny predeform of phase 3 on the anchor
     chain, 3 steps each (the facet route's and the Mooney-Rivlin
     instances' path; the predeform may stall, as on the bench options in
     phase 9, and then fails only on non-finite values or a missing
     launch).

15. The sharded Newton-Krylov path (K21, SPIKE K21f included):
   - 15a (run within phase 2, on its K9 factors at the 20,832-cell tube
     split into two spans of 21 blocks, as two ranks hold them): K21a's
     zero-carry and true-carry passes on each span against their plain
     versions, and the two ranks' chain and Thomas applies composed in
     one process against their plain compositions and against K6's
     single-device apply, each by K6's rule against the float64 scans;
     each single stage, with and without its carry, at three seeds,
     within TOL_CARRY_STAGE_RATIO times its plain version's distance to
     float64 (the ratio read off tests/diag_carry_stages.py); the
     compositions' probes beside K6's; the chain apply of rank 1 of 2
     (three stages and a carry update) timed beside its bound (Sinv + H
     + G of its span and the c x c Tb) and plain version, rank 0's, an
     interior rank's (five stages, two updates: Sinv + 2H + 2G + Tf + Tb)
     and rank 1's Thomas apply (three stages) likewise, and the chain's
     carry update beside torch.addmv;
   - 15b: vasp-tpu-torch-run -p cylinder at 20,832 cells on phase 5's
     configuration with n_devices=2 and dist_backend=gloo, both ranks on
     this card (their exchanges gloo all-reduces of CUDA tensors), 3
     steps, started as the console script starts it (driver.main spawns
     the ranks), each rank's counters reset just before its time loop
     and read just after it (the launches of the kernels line are the
     ranks' sums); the same Newton counts as phase 5's first 3 steps and
     U within 3e-5 relative of its step-3 state (phase 5 and 6 keep
     their states per step through a problem file); per rank Newton and
     GMRES counts, the rebuild by part, s/step, peak memory and K21a's
     launches, and K21d, the all-reduces' seconds (the card synchronized
     around each) and bytes a GMRES iteration. With two cards or more the
     same on nccl, one card a rank (a machine of one card does not make
     it);
   - 15c (run within phase 2, on its C/D/B at the 20,832-cell tube split
     into two spans of 21 blocks, the two ranks composed in this process
     as threads with a summing all-reduce): SPIKE's factorization of both
     ranks (timed); K21f-a (the refinement's residual) on rank 1's span
     by K6's rule against the float64 residual, timed beside its bound
     (C + D + B of the span), its plain version and one torch.bmm of the
     stacked blocks; the two-rank SPIKE apply through the kernels against
     the same apply through the plain versions, refine 0 and 2: its probe
     at most twice the plain apply's plus 1e-6, each apply timed beside
     the bound of both ranks' reads;
   - 15d: 15b's run with shard_algo="spike" (2 refinement passes): every
     step converged, U within 3e-5 relative of phase 5's step 3, the same
     lines, K21a and K21f-a launched on each rank.

Phases 3-15 run with HDF5 output off (save_step=0, checkpoint_step=0)
and, but for 15b, on one device (n_devices=1), so the smoke needs no h5py
on the GPU host and shards nothing on a machine of several cards; the CPU
tests hold the output files.

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL_F64 = 1e-12
TOL_JAC_F32 = 2e-7
TOL_MATVEC_F32 = 1e-5
TOL_PATH_LU = 1e-8
TOL_PATH_GMRES = 3e-5
TOL_PATH_F32F = 3e-2
TOL_LADDER = 1e-5
# phase 3's new cases: the Krylov branch on the rigid pipe, both sides
# converged to atol 1e-10 of the discrete solution
# (tests/test_torch_schwarz.py's bound); make_step_fn converged to 1e-10
# with GMRES at 1e-9 (tests/test_torch_node_block.py's bound)
TOL_PATH_PIPE = 1e-10
TOL_PATH_STEP_FN = 1e-8
# K21a's single stages: the kernel's distance to the float64 stage at most
# this many times the plain version's (plus 1e-6); tests/diag_carry_stages.py's
# 480 readings on an H100 need at most 2.29 (tests/test_torch_kernels_cuda.py)
TOL_CARRY_STAGE_RATIO = 4.0
# phase 10's 2-rank pass against its one-rank pass, relative to each
# field's scale: the same kernels on the same steps (K20a's float64
# atomics sum in a varying order)
TOL_SHARDED_POST = 1e-13
# H100 SXM: HBM3 rate, f32 and f64 peaks without the tensor cores, and the
# f64 tensor-core peak that cuBLAS's DGEMM can reach (NVIDIA H100 SXM data
# sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK = {"f64": 34e12, "f32": 67e12, "f64_tensor": 67e12}
FULL_MESH = dict(r_inner=0.002, r_outer=0.0026, length=0.04, n_theta=16,
                 n_r_fluid=3, n_r_solid=1, n_z=62)  # 20,832 cells
# 10 layers of the 11,088-cell tube's cross-section: 2,520 cells
LU_MESH = dict(r_inner=0.002, r_outer=0.0026, length=0.04 * 10 / 44,
               n_theta=12, n_r_fluid=3, n_r_solid=1, n_z=10)
# every driver run's keys: HDF5 output off, so no h5py is needed (the CPU
# tests cover the Visualization/Checkpoint files), and one device (with
# n_devices unset, a run on a machine of several cards shards over all)
RUN_KEYS = dict(save_step=0, checkpoint_step=0, n_devices=1)
# the cylinder overrides of tests/conftest.py (cylinder_run)
TINY = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=3,
            atol=1e-7, rtol=1e-7, recompute=5, recompute_tstep=1,
            verbose=True, **RUN_KEYS)
# bench.py's options of the Newton-Krylov path (bench.py:102-162) as
# config keys, and as StepOptions
BENCH_CFG = dict(linear_solver="gmres", residual_dtype="f32f",
                 krylov_dtype="f32", gmres_tol=1e-3, gmres_restart=60,
                 gmres_maxiter=120, jac_recompute=2, atol=1e-6, rtol=1e-6,
                 max_it=12)
BENCH_STEP = dict(atol=1e-6, rtol=1e-6, max_it=12, recompute=2,
                  gmres_tol=1e-3, gmres_restart=60, gmres_maxiter=120,
                  jac_chunk=8192, overlap=2, jac_dtype="f32",
                  krylov_dtype="f32", residual_dtype="f32f")
# the generated meshes of the models at the 20,832-cell tube's topology
MODEL_MESH = dict(n_theta=16, n_r_fluid=3, n_r_solid=1, n_z=62)
# the tiny aneurysm of tests/test_torch_driver_aneurysm.py
TINY_ANEURYSM = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=2,
                     atol=1e-6, rtol=1e-6, recompute=5, recompute_tstep=1,
                     generated_mesh_params=dict(n_theta=8, n_z=8),
                     verbose=True, **RUN_KEYS)
# the tiny predeform of tests/test_driver_predeform.py:21-56 (its
# raise_on_fail=False and atol 5e-5 included: the theta=1 MR inflation's
# slow tail at its squeezed increments)
TINY_PREDEFORM = dict(
    T=0.03, dt=0.01, mesh_path=None, quadrature_degree=2, atol=5e-5,
    rtol=1e-4, raise_on_fail=False, recompute=1, recompute_tstep=1,
    t_start_v=0.0, t_end_v=0.01, t_start_p=0.01, t_end_p=0.05,
    v_max_final=0.05, P_final=400.0, verbose=True,
    generated_mesh_params=dict(n_theta=8, n_z=4), **RUN_KEYS)
# the tiny AVF of tests/test_torch_driver_avf.py: tests/test_driver_avf.py's
# cut to 2 steps and n_z=4 (1,536 cells), whose host splu takes minutes
# at n_z=8
TINY_AVF = dict(T=0.0002, dt=0.0001, mesh_path=None, patient_data_path=None,
                quadrature_degree=2, atol=1e-6, rtol=1e-6, recompute=5,
                recompute_tstep=1, vel_t_ramp=0.0002, p_t_ramp_start=0.0001,
                p_t_ramp_end=0.0003,
                generated_mesh_params=dict(n_theta=8, n_z=4), verbose=True,
                **RUN_KEYS)
# phase 9: predeform on the bench configuration with the config's max_it
# (lmbda=0.5 halves the residual per iteration, so 12 cannot reach 1e-6)
# and its ramps shifted so that pressure is on within the run:
# production's 0.7 s pressure ramp at production's dt = 0.01. On these
# options vasp_tpu on the CPU does not converge either (a 1,440-cell tube:
# step 2 climbs every ladder tier and ends at 1.194e-6 > atol,
# tests/diag_predeform_bench_options.py), so a step may end unconverged
# here: it must end below PREDEFORM_FLOOR, the atol
# tests/test_driver_predeform.py holds this theta=1 MR inflation's slow
# tail to
PREDEFORM_CFG = dict(BENCH_CFG, max_it=50, t_end_v=0.02, t_start_p=0.02,
                     t_end_p=0.72, raise_on_fail=False)
PREDEFORM_FLOOR = 5e-5
# phase 9: avf on the bench configuration with its ramps shortened so that
# flow and pressure are on within 5 steps of dt = 1e-4 (its own 0.2 s
# ramps leave those steps at rest: no Newton iteration, no solve):
# inflow over 10 steps, pressure from step 2 over 10 steps
AVF_CFG = dict(BENCH_CFG, vel_t_ramp=1e-3, p_t_ramp_start=2e-4,
               p_t_ramp_end=1.2e-3)
# the AVF's generated Y mesh: 22,656 cells (13,824 fluid, 5,755 artery,
# 3,077 vein); 17,664 cells if the card's memory check refuses the first
AVF_MESH = dict(m=8, n_parent=16, n_daughter=20)
AVF_MESH_SMALL = dict(m=8, n_parent=12, n_daughter=16)
# the AVF vein's wall (vasp_tpu/models/avf.py:70-72): the second MR
# parameter set phase 2 launches
_MU_VEIN = 3e6 / (2 * (1 + 0.45))
VEIN = {"material_model": "MooneyRivlin", "rho_s": 1.0e3, "mu_s": _MU_VEIN,
        "lambda_s": 0.45 * 2.0 * _MU_VEIN / (1.0 - 2.0 * 0.45),
        "C01": 0.003e6, "C10": 0.0, "C11": 0.538e6}
# the lifting and body-force options: elastic lifting with the pressure
# stabilization and solid gravity (phase 3's tiny LU run, phase 2's
# variants), biharmonic lifting at its defaults (bc1, beta = 1: phase 3,
# 11b) and on tests/test_biharmonic.py's Krylov case (bc2, beta = 1e-2:
# 11a)
P_STAB = 0.1
GRAVITY = [0.0, 0.0, -9.81]
ELASTIC = dict(extrapolation="elastic", p_stab=P_STAB, gravity=GRAVITY)
BIHARMONIC = dict(extrapolation="biharmonic")
# the tiny cylinder cut to 1 step for the lifting options' LU parity runs
# (each LU step refactorizes on the host); the no-lifting Krylov run keeps
# TINY's 3 steps, which the f32f bound was set on (after 2 steps the state
# is smaller and the same inexact directions differ by 1.7e-2 relative
# between two CPU thread counts, after 3 by 6.9e-3)
TINY_LIFT = dict(TINY, T=0.001)
BIHARMONIC_KRYLOV = dict(extrapolation="biharmonic",
                         extrapolation_sub_type="bc2", biharmonic_beta=1e-2)
# a problem file: -p cylinder without mesh lifting, its fluid mesh held
# (every fluid-only d dof at 0: without lifting those rows have no
# equation)
NO_LIFT = "no_lift_cylinder"
NO_LIFT_PROBLEM = '''"""-p cylinder, extrapolation="no_extrapolation", fluid-only d at 0 (chip_smoke.py phase 3)."""
import numpy as np

from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.models.cylinder import (  # noqa: F401
    get_mesh_domain_and_boundaries, post_solve, pre_solve)
from vasp_tpu_torch.models.cylinder import create_bcs as _create_bcs
from vasp_tpu_torch.models.cylinder import set_problem_parameters as _parameters


def set_problem_parameters(default_variables, **namespace):
    _parameters(default_variables)
    default_variables.update(extrapolation="no_extrapolation")
    return default_variables


def create_bcs(space, mesh, dx_s_id, **namespace):
    out = _create_bcs(space=space, mesh=mesh, dx_s_id=dx_s_id, **namespace)
    solid = np.unique(space.cell_dofs_p2[mesh.cell_markers == dx_s_id])
    fluid_only = np.setdiff1d(np.arange(space.n_p2), solid)
    out["bcs"].append(DirichletBC(space.field_dofs("d", fluid_only), 0.0))
    return out
'''
# phase 3's and 12d's IterativeStepper runs on the small tube (one ramped
# step in phase 3, two in 12d): (path, StepOptions, the free bytes the stepper reads: "full" one
# byte short of the full layout's peak for its banded_factor_dtype, None
# the card's own, the layout it must take or None for RAS). The banded
# layouts on the tests' options (float64 residuals, gmres_tol 1e-8); RAS at
# vasp_tpu's defaults, with float64 Jacobians (so float64 inverses) in
# phase 3, float32 in 12d: the largest generated tube on which it
# converges there (from 11,489 dofs on, GMRES spends its 300 iterations
# and Newton stalls, in the port and in vasp_tpu; tests/diag_ras_cylinder.py)
_LAYOUT_STEP = dict(atol=1e-9, rtol=1e-9, max_it=10, gmres_tol=1e-8,
                    gmres_restart=60, gmres_maxiter=600, jac_dtype="f32")
STEPPER_RUNS = (
    ("hybrid_tiny", _LAYOUT_STEP, "full", "hybrid"),
    ("sinv_bf16_tiny", dict(_LAYOUT_STEP, banded_factor_dtype="bf16"), "full",
     "bf16"),
    ("sinv_f32_tiny", dict(_LAYOUT_STEP, banded_factor_dtype="f32"), "full",
     "f32"),
    ("full_bf16_tiny", dict(_LAYOUT_STEP, banded_factor_dtype="bf16"), None,
     "full"),
    ("ras_f64_tiny", dict(precond="ras", jac_dtype="f64"), None, None),
)
RAS_SMALL = ("ras_small", dict(precond="ras", jac_dtype="f32"), None, None)
# phase 13a: NewtonSolver's Krylov branch at vasp_tpu's defaults (gmres_tol
# 1e-4, restart 50, 400 restarts), one step; it may stall (its Schwarz
# blocks are singular where a block's pressure rows or lifting carry no
# equation; tests/diag_newton_krylov.py), which is a finding, not a failure
# max_it=2: each Newton iteration's solve spends its 400 restarts (~25 s
# at 20,832 cells), and the phase has to fit the smoke's clock
NEWTON_KRYLOV = dict(linear_solver="krylov", max_it=2, raise_on_fail=False)
# phase 3's Krylov-branch parity case: a transient flow in a rigid pipe
# (tests/test_torch_schwarz.py), on which the branch converges, with that
# test's GMRES options
PIPE_SOLVE = dict(gmres_tol=1e-8, gmres_maxiter=10, max_it=8)
# the processes that run phase 3's CPU sides beside its card runs, and
# the torch threads of each (the card's host keeps the other cores); each
# process takes the next unclaimed job of cpu_reference_jobs
CPU_REFERENCE_PROCESSES = 3
CPU_REFERENCE_THREADS = 2
# phase 3's make_step_fn parity case: tests/test_sharded_step.py's step
# options (at StepOptions' defaults the node-block GMRES reaches 1e-6 in
# none of its 300 iterations on the small tube and Newton stalls at
# 0.73 r0 after 10 iterations; with these it converges in 4) with atol and
# rtol at 2e-11, not 1e-10: the third Newton residual, which GMRES's
# rounding (the atomics' order on the card) moves between 6.5e-11 and
# 5.0e-10 from run to run, straddled 1e-10 and decided the count (the
# CPU took 4, the card 3 in one run). The fourth lands on the float64
# residual's floor, 1.2e-12 to 6.2e-12; 2e-11 sits 3x from both ranges
STEP_FN_OPTS = dict(atol=2e-11, rtol=2e-11, max_it=6, gmres_tol=1e-9,
                    gmres_restart=120, gmres_maxiter=1200)
# a small tube (bench.py's physics) for the forced ladder runs
LADDER_MESH = dict(r_inner=0.002, r_outer=0.0026, length=0.008, n_theta=8,
                   n_r_fluid=2, n_r_solid=1, n_z=5)
CSRC = "vasp_tpu_torch/csrc/"
# kernel -> (source, the vasp_tpu device code it replaces, the path whose
# run reports its launches)
REPLACES = {
    "fluid_residual": (CSRC + "element_kernels.cu",
                       "vasp_tpu/fem/forms.py:86", "gmres"),
    "solid_residual": (CSRC + "element_kernels.cu",
                       "vasp_tpu/fem/forms.py:205", "gmres"),
    "fluid_residual_f32": (CSRC + "element_kernels.cu",
                           "vasp_tpu/fem/forms.py:86 via "
                           "vasp_tpu/fem/assembly.py:83 (dtype=float32)",
                           "f32f"),
    "solid_residual_f32": (CSRC + "element_kernels.cu",
                           "vasp_tpu/fem/forms.py:205 via "
                           "vasp_tpu/fem/assembly.py:83 (dtype=float32)",
                           "f32f"),
    "fluid_jacobian": (CSRC + "element_kernels.cu",
                       "vasp_tpu/fem/assembly.py:92", "lu"),
    "solid_jacobian": (CSRC + "element_kernels.cu",
                       "vasp_tpu/fem/assembly.py:92", "lu"),
    "fluid_jacobian_f32": (CSRC + "element_kernels.cu",
                           "vasp_tpu/fem/assembly.py:92", "gmres"),
    "solid_jacobian_f32": (CSRC + "element_kernels.cu",
                           "vasp_tpu/fem/assembly.py:92", "gmres"),
    "dg0_project_speed": (CSRC + "measures.cu",
                          "vasp_tpu/fem/measures.py:103", "gmres"),
    "integrate_p2_dot_n": (CSRC + "measures.cu",
                           "vasp_tpu/fem/measures.py:88", "gmres"),
    "elem_matvec": (CSRC + "matvec.cu", "vasp_tpu/fem/assembly.py:354",
                    "gmres"),
    "ruiz_sweep": (CSRC + "ruiz.cu", "vasp_tpu/fem/scaling.py:31", "gmres"),
    "ruiz_scale": (CSRC + "ruiz.cu", "vasp_tpu/fem/scaling.py:71", "gmres"),
    "banded_assemble": (CSRC + "banded.cu", "vasp_tpu/fem/banded.py:224",
                        "gmres"),
    "banded_apply": (CSRC + "banded.cu", "vasp_tpu/fem/banded.py:651",
                     "gmres"),
    "banded_factorize_f64": ("vasp_tpu_torch/fem/banded.py",
                             "vasp_tpu/fem/banded.py:576", "ladder"),
    "robin_residual": (CSRC + "facet_kernels.cu",
                       "vasp_tpu/fem/forms.py:252 via "
                       "vasp_tpu/fem/assembly.py:116", "aneurysm_lu"),
    "robin_residual_f32": (CSRC + "facet_kernels.cu",
                           "vasp_tpu/fem/forms.py:252 via "
                           "vasp_tpu/fem/assembly.py:116 (dtype=float32)",
                           "aneurysm"),
    "robin_jacobian": (CSRC + "facet_kernels.cu",
                       "vasp_tpu/fem/assembly.py:122", "aneurysm_lu"),
    "robin_jacobian_f32": (CSRC + "facet_kernels.cu",
                           "vasp_tpu/fem/assembly.py:122", "aneurysm"),
    "elem_matvec_36": (CSRC + "matvec.cu", "vasp_tpu/fem/assembly.py:354",
                       "aneurysm"),
    "ruiz_sweep_36": (CSRC + "ruiz.cu", "vasp_tpu/fem/scaling.py:31",
                      "aneurysm"),
    "ruiz_scale_36": (CSRC + "ruiz.cu", "vasp_tpu/fem/scaling.py:71",
                      "aneurysm"),
    "dg0_project_jacobian": (CSRC + "measures.cu",
                             "vasp_tpu/fem/measures.py:116", "aneurysm"),
    "solid_residual_mr": (CSRC + "element_kernels.cu",
                          "vasp_tpu/fem/forms.py:205 with "
                          "vasp_tpu/fem/kinematics.py:80 (MooneyRivlin)",
                          "predeform_lu"),
    "solid_residual_mr_f32": (CSRC + "element_kernels.cu",
                              "vasp_tpu/fem/forms.py:205 with "
                              "vasp_tpu/fem/kinematics.py:80 via "
                              "vasp_tpu/fem/assembly.py:83 (dtype=float32)",
                              "predeform"),
    "solid_jacobian_mr": (CSRC + "element_kernels.cu",
                          "vasp_tpu/fem/assembly.py:92 (MooneyRivlin)",
                          "predeform_lu"),
    "solid_jacobian_mr_f32": (CSRC + "element_kernels.cu",
                              "vasp_tpu/fem/assembly.py:92 (MooneyRivlin)",
                              "predeform"),
    "wss_load": (CSRC + "postproc.cu",
                 "vasp_tpu/postprocessing/fields/hemodynamics.py:143",
                 "postproc"),
    "stress_strain_svk": (CSRC + "postproc.cu",
                          "vasp_tpu/postprocessing/fields/stress_strain.py"
                          ":166 with :112 and vasp_tpu/fem/kinematics.py:133",
                          "postproc"),
    "stress_strain_mr": (CSRC + "postproc.cu",
                         "vasp_tpu/postprocessing/fields/stress_strain.py"
                         ":166 with :112 and vasp_tpu/fem/kinematics.py:133 "
                         "(MooneyRivlin)", "postproc"),
    "max_eig": (CSRC + "postproc.cu",
                "vasp_tpu/fem/kinematics.py:133 via "
                "vasp_tpu/postprocessing/spectral/hi_pass_viz.py:205",
                "postproc"),
    "spectral_power": (CSRC + "postproc.cu",
                       "vasp_tpu/postprocessing/spectral/core.py:34 and :57",
                       "postproc"),
    "fluid_residual_elastic": (CSRC + "element_kernels.cu",
                               "vasp_tpu/fem/forms.py:191 (elastic lifting)",
                               "elastic_lu"),
    "fluid_residual_elastic_f32": (CSRC + "element_kernels.cu",
                                   "vasp_tpu/fem/forms.py:191 (elastic "
                                   "lifting) via vasp_tpu/fem/assembly.py:83 "
                                   "(dtype=float32)", "elastic"),
    "fluid_jacobian_elastic": (CSRC + "element_kernels.cu",
                               "vasp_tpu/fem/assembly.py:92 (elastic "
                               "lifting)", "elastic_lu"),
    "fluid_jacobian_elastic_f32": (CSRC + "element_kernels.cu",
                                   "vasp_tpu/fem/assembly.py:92 (elastic "
                                   "lifting)", "elastic"),
    "fluid_residual_nolift": (CSRC + "element_kernels.cu",
                              "vasp_tpu/fem/forms.py:195 (no_extrapolation)",
                              "nolift_lu"),
    "fluid_residual_nolift_f32": (CSRC + "element_kernels.cu",
                                  "vasp_tpu/fem/forms.py:195 "
                                  "(no_extrapolation) via "
                                  "vasp_tpu/fem/assembly.py:83 "
                                  "(dtype=float32)", "nolift_f32f"),
    "fluid_jacobian_nolift": (CSRC + "element_kernels.cu",
                              "vasp_tpu/fem/assembly.py:92 "
                              "(no_extrapolation)", "nolift_lu"),
    "fluid_jacobian_nolift_f32": (CSRC + "element_kernels.cu",
                                  "vasp_tpu/fem/assembly.py:92 "
                                  "(no_extrapolation)", "nolift_f32f"),
    "lift_correction": (CSRC + "lifting.cu",
                        "vasp_tpu/fem/biharmonic.py:135", "biharmonic_krylov"),
    "lift_correction_f32": (CSRC + "lifting.cu",
                            "vasp_tpu/fem/biharmonic.py:135 (float32 "
                            "Krylov matvec)", "biharmonic_krylov"),
    "banded_apply_hybrid": (CSRC + "banded.cu",
                            "vasp_tpu/fem/banded.py:651 with the hybrid "
                            "factors of vasp_tpu/fem/timestepper.py:495",
                            "hybrid"),
    "banded_apply_bf16": (CSRC + "banded.cu",
                          "vasp_tpu/fem/banded.py:651 and :344 (bf16 "
                          "factors of :438)", "full_bf16"),
    "banded_apply_lowmem_bf16": (CSRC + "banded.cu",
                                 "vasp_tpu/fem/banded.py:617", "sinv_bf16"),
    "banded_apply_lowmem_f32": (CSRC + "banded.cu",
                                "vasp_tpu/fem/banded.py:617 (f32 Sinv)",
                                "sinv_f32_tiny"),
    "ruiz_sweep_f64": (CSRC + "ruiz.cu", "vasp_tpu/fem/scaling.py:31 "
                       "(float64, vasp_tpu/fem/timestepper.py:355)",
                       "ras_small"),
    "ras_apply_f32": (CSRC + "ras.cu", "vasp_tpu/fem/ras.py:196",
                      "ras_small"),
    "ras_apply": (CSRC + "ras.cu", "vasp_tpu/fem/ras.py:196 (float64 "
                  "inverses)", "ras_f64_tiny"),
    "schwarz_build": (CSRC + "schwarz.cu",
                      "vasp_tpu/fem/solver.py:153 (_build_schwarz)",
                      "newton_krylov"),
    "schwarz_apply": (CSRC + "schwarz.cu",
                      "vasp_tpu/fem/solver.py:177 (_precond)",
                      "newton_krylov"),
    "schwarz_divide": (CSRC + "schwarz.cu",
                       "vasp_tpu/fem/solver.py:185 (_precond's division by "
                       "the multiplicity)", "newton_krylov"),
    "ruiz_scale_f64": (CSRC + "ruiz.cu", "vasp_tpu/fem/scaling.py:71 "
                       "(float64, vasp_tpu/fem/timestepper.py:237)",
                       "step_fn"),
    "node_block_extract": (CSRC + "nodeblock.cu",
                           "vasp_tpu/fem/scaling.py:80 (build_node_block)",
                           "step_fn"),
    "node_block_invert": (CSRC + "nodeblock.cu",
                          "vasp_tpu/fem/scaling.py:106-118 with "
                          "vasp_tpu/fem/smallmat.py:42 (inv6)", "step_fn"),
    "node_block_apply": (CSRC + "nodeblock.cu",
                         "vasp_tpu/fem/scaling.py:121 (apply_node_block)",
                         "step_fn"),
    "fluid_delta": (CSRC + "delta_kernels.cu",
                    "vasp_tpu/fem/assembly.py:256 (residual_delta)",
                    "chain_anchor"),
    "solid_delta": (CSRC + "delta_kernels.cu",
                    "vasp_tpu/fem/assembly.py:256 (residual_delta)",
                    "chain_anchor"),
    "fluid_delta2": (CSRC + "delta_kernels.cu",
                     "vasp_tpu/fem/assembly.py:301 (residual_delta2)",
                     "chain_anchor"),
    "solid_delta2": (CSRC + "delta_kernels.cu",
                     "vasp_tpu/fem/assembly.py:301 (residual_delta2)",
                     "chain_anchor"),
    "solid_delta_mr": (CSRC + "delta_kernels.cu",
                       "vasp_tpu/fem/assembly.py:256 (residual_delta, "
                       "MooneyRivlin)", "predeform_chain"),
    "solid_delta2_mr": (CSRC + "delta_kernels.cu",
                        "vasp_tpu/fem/assembly.py:301 (residual_delta2, "
                        "MooneyRivlin)", "predeform_chain"),
    "robin_delta": (CSRC + "facet_kernels.cu",
                    "vasp_tpu/fem/assembly.py:256 (residual_delta, facet "
                    "blocks)", "aneurysm_chain"),
    "robin_delta2": (CSRC + "facet_kernels.cu",
                     "vasp_tpu/fem/assembly.py:301 (residual_delta2, facet "
                     "blocks)", "aneurysm_chain"),
    "banded_carry": (CSRC + "banded.cu",
                     "vasp_tpu/parallel/banded_shard.py:676 "
                     "(make_sharded_chain_apply) and :846 "
                     "(make_sharded_banded_apply)", "sharded"),
    "banded_carry_update": (CSRC + "banded.cu",
                            "vasp_tpu/parallel/banded_shard.py:724 (the "
                            "chain's carry update, wlast + Tf carry)",
                            "sharded"),
    "banded_tri_residual": (CSRC + "banded.cu",
                            "vasp_tpu/parallel/banded_shard.py:775-777 "
                            "(make_sharded_spike_apply's refinement "
                            "residual)", "sharded_spike"),
}
# the kernels each path's run must launch
_KRYLOV_FLUID = {"fluid_jacobian_f32", "elem_matvec", "ruiz_sweep",
                 "ruiz_scale", "banded_assemble", "banded_apply"}
_KRYLOV = _KRYLOV_FLUID | {"solid_jacobian_f32"}
# the Krylov path's kernels but the fluid's Jacobian (a run whose fluid
# block is an elastic or no-lifting one launches that instance's)
_KRYLOV_SOLID = _KRYLOV - {"fluid_jacobian_f32"}
_MEASURES = {"dg0_project_speed", "integrate_p2_dot_n"}
# the banded Krylov path without its apply, on the bench configuration
# through the driver (f32f residuals, measures), through IterativeStepper
# (phase 7's tube, f32f residuals) and on phase 3's small tube (float64
# residuals)
_BANDED = _KRYLOV - {"banded_apply"}
_F32F_BANDED = _BANDED | {"fluid_residual_f32", "solid_residual_f32"} \
    | _MEASURES
_STEPPER_BANDED = _BANDED | {"fluid_residual_f32", "solid_residual_f32"}
_TINY_BANDED = _BANDED | {"fluid_residual", "solid_residual"}
_RAS = {"fluid_residual", "solid_residual", "fluid_jacobian",
        "solid_jacobian", "fluid_jacobian_f32", "solid_jacobian_f32",
        "elem_matvec", "ruiz_sweep_f64", "ras_apply_f32"}
_ROBIN_F32 = {"robin_residual_f32", "robin_jacobian_f32", "elem_matvec_36",
              "ruiz_sweep_36", "ruiz_scale_36"}
_MR_LU = {"fluid_residual", "solid_residual_mr", "fluid_jacobian",
          "solid_jacobian_mr", "robin_residual", "robin_jacobian"} | _MEASURES
_MR_F32F = {"fluid_residual_f32", "solid_residual_mr_f32",
            "solid_jacobian_mr_f32"} | _KRYLOV_FLUID | _ROBIN_F32 | _MEASURES
_DELTA = {"fluid_residual_f32", "solid_residual_f32", "fluid_residual",
          "solid_residual", "fluid_delta", "solid_delta"} | _KRYLOV | _MEASURES
PATHS = {
    "lu": {"fluid_residual", "solid_residual", "fluid_jacobian",
           "solid_jacobian"} | _MEASURES,
    "gmres": {"fluid_residual", "solid_residual"} | _KRYLOV | _MEASURES,
    "f32f": {"fluid_residual_f32", "solid_residual_f32"} | _KRYLOV
    | _MEASURES,
    "bench": {"fluid_residual_f32", "solid_residual_f32"} | _KRYLOV,
    "ladder": {"banded_factorize_f64"},
    "aneurysm_lu": {"fluid_residual", "solid_residual", "fluid_jacobian",
                    "solid_jacobian", "robin_residual", "robin_jacobian",
                    "dg0_project_jacobian"} | _MEASURES,
    "stenosis": {"fluid_residual_f32", "solid_residual_f32",
                 "dg0_project_jacobian"} | _KRYLOV | _MEASURES,
    "aneurysm": {"fluid_residual_f32", "solid_residual_f32",
                 "dg0_project_jacobian"} | _ROBIN_F32 | _KRYLOV | _MEASURES,
    "predeform_lu": _MR_LU,
    "avf_lu": _MR_LU | {"dg0_project_jacobian"},
    "predeform": _MR_F32F,
    "chain": _MR_F32F,
    "avf": _MR_F32F | {"dg0_project_jacobian"},
    "postproc": {"wss_load", "stress_strain_svk", "stress_strain_mr",
                 "max_eig", "spectral_power"},
    "biharmonic_tiny_lu": {"fluid_residual", "solid_residual",
                           "fluid_jacobian", "solid_jacobian",
                           "lift_correction"} | _MEASURES,
    "elastic_lu": {"fluid_residual_elastic", "solid_residual",
                   "fluid_jacobian_elastic", "solid_jacobian"} | _MEASURES,
    "nolift_lu": {"fluid_residual_nolift", "solid_residual",
                  "fluid_jacobian_nolift", "solid_jacobian"} | _MEASURES,
    "nolift_f32f": {"fluid_residual_nolift_f32", "solid_residual_f32",
                    "fluid_jacobian_nolift_f32"} | _KRYLOV_SOLID | _MEASURES,
    "biharmonic_krylov": {"lift_correction", "lift_correction_f32",
                          "fluid_residual_f32", "solid_residual_f32",
                          "dg0_project_jacobian"} | _ROBIN_F32 | _KRYLOV
    | _MEASURES,
    "biharmonic_lu": {"lift_correction", "fluid_residual", "solid_residual",
                      "fluid_jacobian", "solid_jacobian"} | _MEASURES,
    "elastic": {"fluid_residual_elastic_f32", "solid_residual_f32",
                "fluid_jacobian_elastic_f32"} | _KRYLOV_SOLID | _MEASURES,
    # phase 12 and phase 3's layout runs: each banded layout's apply in
    # place of the full float32 one
    "hybrid": _F32F_BANDED | {"banded_apply_hybrid"},
    "sinv_bf16": _STEPPER_BANDED | {"banded_apply_lowmem_bf16"},
    "full_bf16": _STEPPER_BANDED | {"banded_apply_bf16"},
    "hybrid_tiny": _TINY_BANDED | {"banded_apply_hybrid"},
    "sinv_bf16_tiny": _TINY_BANDED | {"banded_apply_lowmem_bf16"},
    "sinv_f32_tiny": _TINY_BANDED | {"banded_apply_lowmem_f32"},
    "full_bf16_tiny": _TINY_BANDED | {"banded_apply_bf16"},
    # the RAS preconditioner: float64 rebuild Jacobians and scales
    "ras_small": _RAS,
    "ras_f64_tiny": {"fluid_residual", "solid_residual", "fluid_jacobian",
                     "solid_jacobian", "elem_matvec", "ruiz_sweep_f64",
                     "ras_apply"},
    # NewtonSolver's Krylov branch (K22) and make_step_fn (K17)
    "newton_krylov": {"fluid_residual", "solid_residual", "fluid_jacobian",
                      "solid_jacobian", "elem_matvec", "schwarz_build",
                      "schwarz_apply", "schwarz_divide"} | _MEASURES,
    "krylov_pipe": {"fluid_residual_nolift", "fluid_jacobian_nolift",
                    "elem_matvec", "schwarz_build", "schwarz_apply",
                    "schwarz_divide"},
    "step_fn": {"fluid_residual", "solid_residual", "fluid_jacobian",
                "solid_jacobian", "elem_matvec", "ruiz_sweep_f64",
                "ruiz_scale_f64", "node_block_extract", "node_block_invert",
                "node_block_apply"},
    # the Taylor-delta endgame (K13) and the anchor chain (K13's delta2):
    # float32 coarse residuals, raw float64 anchors, the deltas
    "delta_endgame": _DELTA,
    "chain_anchor": _DELTA | {"fluid_delta2", "solid_delta2"},
    "aneurysm_chain": _DELTA | _ROBIN_F32 | {"fluid_delta2", "solid_delta2",
                                             "robin_delta", "robin_delta2",
                                             "dg0_project_jacobian"},
    "predeform_chain": {"fluid_residual_f32", "solid_residual_mr_f32",
                        "solid_jacobian_mr_f32", "fluid_delta",
                        "fluid_delta2", "solid_delta_mr", "solid_delta2_mr"}
    | _KRYLOV_FLUID | _ROBIN_F32 | _MEASURES,
    # the sharded Newton-Krylov path (phase 15b), summed over its ranks:
    # K21a in place of K6
    "sharded": _TINY_BANDED | {"banded_carry", "banded_carry_update"}
    | _MEASURES,
    # SPIKE on it (phase 15d): K21a's stages and carry updates and the
    # refinement's residual K21f-a
    "sharded_spike": _TINY_BANDED | {"banded_carry", "banded_carry_update",
                                     "banded_tri_residual"} | _MEASURES,
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b):
    """(relative 2-norm error, max abs error) of a against b."""
    d = (a.double() - b.double()).abs()
    return float(d.norm() / b.double().norm()), float(d.max())


def cuda_ms(fn, reps):
    """Mean milliseconds per call over `reps` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_graph_ms(fn, reps):
    """Mean milliseconds per call of `reps` calls captured in one CUDA
    graph and replayed: the card's time for the work without the host's
    cost of each launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def cuda_ms_once(fn):
    """(fn's result, the milliseconds of that one call)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def bound(nbytes, ops, kind):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the peak of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def count_ops(fn, jets=()):
    """Arithmetic operations of one call of a plain torch function, counted
    by dispatching it: a matmul counts 2 m n k, a reduction the elements
    it reads, any other arithmetic op the elements it writes; views,
    copies, gathers and fills count nothing.

    jets: the tensors that carry an order-3 Taylor series, as K13's Jet3
    does (every tensor computed from them carries one too); an op with a
    series operand counts what Jet3 does for it: a sum or difference 4
    times with two series operands and once with one (only the value
    moves), a negation 4, a product 4 with one series operand and 16 with
    two (the Cauchy product's 10 multiplies and 6 adds), a quotient 4 by a
    plain divisor and 16 by a series (the recurrence's 4 divides, 6
    multiplies and 6 subtractions), log1p 12, a matmul 4 with one series
    operand and 10 with two (a jet multiply-add is 8 or 20 operations
    where a float's is 2), a reduction or any other op 4."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    import torch

    free = {"view", "_unsafe_view", "reshape", "expand", "permute", "t",
            "transpose", "unsqueeze", "squeeze", "select", "slice", "index",
            "index_select", "gather", "clone", "copy_", "_to_copy", "detach",
            "empty", "zeros", "zeros_like", "ones_like", "empty_like",
            "new_zeros", "new_empty", "cat", "stack", "lift_fresh", "alias",
            "as_strided", "scalar_tensor", "fill_", "full", "arange",
            "split", "unbind", "_reshape_alias", "new_empty_strided",
            "empty_strided", "zero_", "lift_fresh_copy", "index_put_",
            "index_put", "slice_scatter", "select_scatter", "eye", "ones",
            "new_ones", "movedim", "diagonal", "expand_copy",
            "unsqueeze_copy"}
    matmul = {"mm", "bmm", "addmm", "matmul", "baddbmm", "mv", "dot"}
    reduce = {"sum", "amax", "amin", "mean", "linalg_vector_norm", "norm",
              "prod", "max", "min"}
    sums = {"add", "sub", "rsub", "add_", "sub_"}
    quots = {"div", "div_", "reciprocal"}

    def jet_weight(name, js):
        k = sum(js)
        if k == 0:
            return 1
        if name in sums:
            return 4 if k == 2 else 1
        if name in ("mul", "mul_"):
            return 16 if k == 2 else 4
        if name in quots:
            return 16 if len(js) > 1 and js[1] else 4
        if name == "log1p":
            return 12
        if name in matmul:
            return 10 if k == 2 else 4
        return 4

    class Ops(TorchDispatchMode):
        n = 0
        series = {id(t): t for t in jets}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [a for a in tree_flatten(out)[0]
                    if isinstance(a, torch.Tensor)]
            js = [id(a) in self.series for a in ins]
            if any(js):
                self.series.update((id(o), o) for o in outs)
            if name in free:
                return out
            if name in matmul:
                base = 2 * max(o.numel() for o in outs) * ins[0].shape[-1]
            elif name in reduce:
                base = max(i.numel() for i in ins)
            else:
                base = max([o.numel() for o in outs] + [0])
            self.n += jet_weight(name, js) * base
            return out

    with Ops() as ops:
        fn()
    return ops.n


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    require((ROOT / "vasp_tpu_torch" / "csrc").is_dir(),
            f"no vasp_tpu_torch package beside {Path(__file__).name}; run "
            f"from the root of a checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(ROOT))
    from vasp_tpu_torch.kernels import build

    tic = time.perf_counter()
    build.library()
    print(f"[1] kernels ready in {time.perf_counter() - tic:.2f} s "
          f"(nvcc {build.BUILD_SECONDS['nvcc']:.2f} s; 0 = already built)")
    log = build.BUILD_DIR / "nvcc.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print("    " + line.strip())
    check_f32_residual_sass(build)


def check_f32_residual_sass(build):
    """The float32 residual instances (the fluid cells' K1 with Laplace,
    elastic and no mesh lifting, the solid cells' K2 in St.Venant-Kirchhoff
    and in Mooney-Rivlin, and the Robin facets' K14) and the float32
    biharmonic lifting correction (K16's three kernels) must do no float64
    arithmetic (a stray double literal, parameter or math call would
    promote their math): count the f64 arithmetic instructions in their
    SASS. Only the input roundings (F2F) and the float64 scatter
    (RED.ADD.F64) may touch f64. The same for K13's ten instances (the
    three fluid liftings and two solid materials, each as delta and
    delta2), whose only float64 arithmetic may be the differences du = U -
    A (and du0 = U0new - U0) taken before their rounding, as vasp_tpu takes
    them: at most 64 (128 for delta2) DADD and no other."""
    import re

    tool = Path("/usr/local/cuda/bin/cuobjdump")
    so = next(build.BUILD_DIR.glob("libvasp_tpu_torch_*.so"))
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    heads = [(f.split("\n", 1)[0], f) for f in sass.split("Function : ")[1:]]
    funcs = [f for h, f in heads
             if re.search(r"(residual|lift_\w+)_kernelIf", h)]
    require(len(funcs) == 9, f"found {len(funcs)} float32 residual and "
                             f"lifting instances in the SASS, expected 9")
    f64_ops = r"\b(?:DADD|DMUL|DFMA|DSETP|DMNMX|DSET)\b"
    for f in funcs:
        n = len(re.findall(f64_ops, f))
        print(f"    SASS of {f.split(chr(10), 1)[0].strip()[:90]}: {n} "
              f"float64 arithmetic instructions")
        require(n == 0, "the float32 residual does float64 arithmetic")
    deltas = [(re.search(r"delta_kernelI.*?Lb([01])E", h), f)
              for h, f in heads if "delta_kernelI" in h]
    require(len(deltas) == 10 and all(m for m, _ in deltas),
            f"found {len(deltas)} K13 instances in the SASS, expected 10")
    for m, f in deltas:
        n = len(re.findall(f64_ops, f))
        n_add = len(re.findall(r"\bDADD\b", f))
        print(f"    SASS of {f.split(chr(10), 1)[0].strip()[:90]}: {n} "
              f"float64 arithmetic instructions, {n_add} of them DADD")
        require(n == n_add <= 64 * (1 + int(m.group(1))),
                "K13 does float64 arithmetic beyond its du differences")


def model_system(problem, mesh_params, device, **extra):
    """A model's system on its generated mesh and its Dirichlet set at
    t = 0, built through the model's own hooks."""
    from vasp_tpu_torch.run.config import default_variables
    from vasp_tpu_torch.run.driver import load_problem_module
    from vasp_tpu_torch.run.system import FSISystem

    mod = load_problem_module(problem)
    cfg = mod.set_problem_parameters(default_variables())
    cfg.update(device=device, mesh_path=None,
               generated_mesh_params=mesh_params, **extra)
    mesh = mod.get_mesh_domain_and_boundaries(**cfg)
    system = FSISystem(mesh, cfg)
    with redirect_stdout(io.StringIO()):
        bcs = mod.create_bcs(**dict(cfg, t=0.0, mesh=mesh, system=system,
                                    space=system.space))["bcs"]
    return system, system.make_bcset(bcs)


def build_system(mesh_params, device, seed, problem="cylinder"):
    """A model's system at the given size, its BCs, and two seeded
    states."""
    import numpy as np
    import torch

    system, bc = model_system(problem, mesh_params, device)
    # random states at the models' scales: wall displacement ~1 um,
    # velocity ~1 cm/s, pressure ~100 Pa
    rng = np.random.default_rng(seed)
    space = system.space
    scale = np.concatenate([np.full(3 * space.n_p2, 1e-6),
                            np.full(3 * space.n_p2, 1e-2),
                            np.full(space.n_p1, 1e2)])
    U = torch.as_tensor(rng.normal(size=space.ndof) * scale, device=device)
    U0 = torch.as_tensor(rng.normal(size=space.ndof) * scale, device=device)
    return system, bc, U, U0


def bench_tube(mesh_params, device, stenosis=True):
    """bench.py's build(): the FSI tube (stenosed by its radius profile
    unless stenosis=False), its physics at quadrature degree 3, its
    Dirichlet sets and its 150x interface load; (system, bc set, load)."""
    import numpy as np

    from vasp_tpu_torch.fem.dirichlet import DirichletBC
    from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
    from vasp_tpu_torch.run.system import FSISystem

    def profile(z):
        return 1.0 - 0.35 * np.exp(-((z - 0.012) / 0.004) ** 2)

    mesh = fsi_tube_mesh(**mesh_params,
                         radius_profile=profile if stenosis else None)
    E, nu = 1e6, 0.45
    mu_s = E / (2 * (1 + nu))
    system = FSISystem(mesh, dict(
        dt=0.001, theta=0.501, rho_f=1.0e3, mu_f=1.5e-3, dx_f_id=1,
        rho_s=1e3, mu_s=mu_s, lambda_s=nu * 2 * mu_s / (1 - 2 * nu),
        dx_s_id=2, material_model="StVenantKirchoff",
        extrapolation="laplace", extrapolation_sub_type="constant",
        quadrature_degree=3, device=device))
    space = system.space
    bcs = [DirichletBC(space.field_dofs("d", space.p2_dofs_on_facets(m)),
                       0.0) for m in (2, 3, 11)]
    bcs += [DirichletBC(space.field_dofs("v", space.p2_dofs_on_facets(m)),
                        0.0) for m in (2, 11)]
    return (system, system.make_bcset(bcs),
            150.0 * system.interface_pressure_load())


class Records(dict):
    def add(self, name, err, ms, plain_ms, work, tol, shape,
            library_ms=None, **extra):
        """err: (rel, max_abs); work: (bytes, operations, "f64"/"f32")."""
        rel, mx = err
        b_ms, by = bound(*work)
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        print(f"    {name:20s} {shape:>26s}  rel {rel:.3e}  max_abs "
              f"{mx:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({by}){lib}")
        require(rel <= tol, f"{name} disagrees with its plain version: "
                            f"rel {rel:.3e} > {tol:.1e}")
        self[name] = dict(max_abs_err=mx, rel_err=rel, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=library_ms, **extra)


def _per_block_rel(Ak, Ap):
    K = Ak.shape[0]
    d = (Ak.double() - Ap.double()).reshape(K, -1).norm(dim=1)
    return (float((d / Ap.double().reshape(K, -1).norm(dim=1)).max()),
            float((Ak.double() - Ap.double()).abs().max()))


def _sub_block(b, n):
    from dataclasses import replace

    return replace(b, dofs=b.dofs[:n], Jinv=b.Jinv[:n], detJ=b.detJ[:n],
                   vol=b.vol[:n],
                   rowmask=None if b.rowmask is None else b.rowmask[:n])


def element_block_records(records, b, U, U0, shape_tag=""):
    """K1/K2 (f64 and f32) and K3 (f64 and f32) of one cell block against
    their plain versions, recorded under the block's launch counters
    (fluid_/solid_, the solid's material tag, _f32). The bounds count the
    U, U0 and R entries the block touches, its tables, and the operations
    of the plain version counted on 32 of its cells."""
    import torch

    from vasp_tpu_torch.kernels import element

    def name(op, f32):
        return element.counter_name(b, op, f32)

    ndof = U.shape[0]
    K = b.dofs.shape[0]
    f32 = torch.float32
    sub = _sub_block(b, 32)
    res_ops = count_ops(lambda: element.residual_plain(
        sub, U, U0, torch.zeros_like(U))) * K / 32
    res32_ops = count_ops(lambda: element.residual_plain(
        sub, U, U0, torch.zeros_like(U), f32)) * K / 32
    jac_ops = count_ops(lambda: element.jacobian_plain(sub, U, U0)) * K / 32
    touched = int(torch.unique(b.dofs).numel())
    inputs = nbytes(b.dofs, b.Jinv, b.detJ, b.vol, b.rowmask) + 2 * 8 * touched
    shape = f"K={K}{shape_tag}"

    Rk = element.residual_cuda(b, U, U0, torch.zeros_like(U))
    Rp = element.residual_plain(b, U, U0, torch.zeros_like(U))
    R = torch.zeros_like(U)
    records.add(name("residual", False), rel_err(Rk, Rp),
                cuda_ms(lambda: element.residual_cuda(b, U, U0, R), 20),
                cuda_ms(lambda: element.residual_plain(b, U, U0, R), 3),
                (inputs + 8 * touched, res_ops, "f64"), TOL_F64,
                f"{shape} -> ({ndof},)")

    # float32 element work: as accurate as the plain version, whose
    # distance to the float64 residual sets the bound
    Rk32 = element.residual_cuda(b, U, U0, torch.zeros_like(U), f32)
    Rp32 = element.residual_plain(b, U, U0, torch.zeros_like(U), f32)
    floor = float((Rp32 - Rp).norm())
    tol32 = (2 * floor + 1e-14 * float(Rp.norm())) / float(Rp32.norm())
    records.add(name("residual", True), rel_err(Rk32, Rp32),
                cuda_ms(lambda: element.residual_cuda(b, U, U0, R, f32), 20),
                cuda_ms(lambda: element.residual_plain(b, U, U0, R, f32), 3),
                (inputs + 8 * touched, res32_ops, "f32"), tol32,
                f"{shape} f32 -> ({ndof},)",
                plain_rel_to_f64=floor / float(Rp.norm()),
                kernel_rel_to_f64=float((Rk32 - Rp).norm() / Rp.norm()))
    del Rk, Rp, Rk32, Rp32

    # the plain Jacobian (seconds at full width) is timed once, in the
    # call that makes the reference (count_ops ran it on 32 cells first);
    # its float32 record adds the cast
    Ap, plain_ms = cuda_ms_once(
        lambda: element.jacobian_plain(b, U, U0, chunk=128))
    for dt, f32_out, tol in ((torch.float64, False, TOL_F64),
                             (torch.float32, True, TOL_JAC_F32)):
        Ak = element.jacobian_cuda(b, U, U0, dt)
        err = _per_block_rel(Ak, Ap.to(dt))
        del Ak
        records.add(
            name("jacobian", f32_out), err,
            cuda_ms(lambda: element.jacobian_cuda(b, U, U0, dt), 5),
            plain_ms + (cuda_ms(lambda: Ap.to(dt), 3) if f32_out else 0.0),
            (inputs + K * 4096 * (4 if f32_out else 8), jac_ops, "f64"), tol,
            f"{shape} -> ({K},64,64) {dt}".replace("torch.", ""))
    del Ap


def phase_element_kernels(records, system, U, U0):
    """K1, K2, K3 (f64 and f32) and K19 against their plain versions."""
    import torch

    from vasp_tpu_torch.fem.measures import BoundaryMeasure
    from vasp_tpu_torch.fem.quadrature import tet_quadrature
    from vasp_tpu_torch.fem.shape import p2_tet
    from vasp_tpu_torch.kernels import measures as km

    for b in system.assembler.blocks:
        element_block_records(records, b, U, U0)

    space = system.space
    v = space.split(U)[1].contiguous()
    pts, wq = tet_quadrature(2)
    N2 = torch.as_tensor(p2_tet(pts)[0], device="cuda")
    wq = torch.as_tensor(wq, device="cuda")
    dofs = torch.as_tensor(space.cell_dofs_p2.astype("int64"), device="cuda")
    sk = km.dg0_project_speed_cuda(v, dofs, N2, wq)
    sp_ = km.dg0_project_speed_plain(v, dofs, N2, wq)
    records.add("dg0_project_speed", rel_err(sk, sp_),
                cuda_ms(lambda: km.dg0_project_speed_cuda(v, dofs, N2, wq), 50),
                cuda_ms(lambda: km.dg0_project_speed_plain(v, dofs, N2, wq),
                        50),
                (nbytes(v, dofs, N2, wq, sk),
                 count_ops(lambda: km.dg0_project_speed_plain(v, dofs, N2, wq)),
                 "f64"), TOL_F64, f"Nc={dofs.shape[0]}")

    inlet = BoundaryMeasure(space, system.cfg["inlet_id"])
    tabs = inlet.device_tables("cuda")
    fk = km.integrate_p2_dot_n_cuda(v, *tabs)
    fp = km.integrate_p2_dot_n_plain(v, *tabs)
    records.add("integrate_p2_dot_n", rel_err(fk.reshape(1), fp.reshape(1)),
                cuda_ms(lambda: km.integrate_p2_dot_n_cuda(v, *tabs), 50),
                cuda_ms(lambda: km.integrate_p2_dot_n_plain(v, *tabs), 50),
                (nbytes(v, *tabs) + 8,
                 count_ops(lambda: km.integrate_p2_dot_n_plain(v, *tabs)),
                 "f64"), TOL_F64, f"facets={tabs[0].shape[0]}")


def phase_iterative_kernels(records, system, bc):
    """K4, K7, K8 and K6 against their plain versions on the first rebuild's
    inputs (the state at t = dt from rest), and the torch K9/K10 times."""
    import gc

    import numpy as np
    import torch

    from vasp_tpu_torch.fem import banded as fb
    from vasp_tpu_torch.fem.scaling import ruiz_scales
    from vasp_tpu_torch.kernels import banded as kb
    from vasp_tpu_torch.kernels import matvec as km4
    from vasp_tpu_torch.kernels import scaling as ks

    asm = system.assembler
    blocks = asm.blocks
    ndof = asm.ndof
    mask = bc.mask_on("cuda")
    Z = system.zero_state()
    U1 = bc.apply(Z, 1e-3)
    jacs32 = asm.element_jacobians(U1, Z, dtype=torch.float32)
    K_all = sum(b.dofs.shape[0] for b in blocks)
    dof_bytes = nbytes(*(b.dofs for b in blocks))
    x64 = torch.as_tensor(np.random.default_rng(3).normal(size=ndof),
                          device="cuda")

    # ---- K4: the three dtype variants of the element matvec
    jacs64 = asm.element_jacobians(U1, Z)
    variants = {}
    for label, jacs, x, tol in (("f32_f64", jacs32, x64, TOL_MATVEC_F32),
                                ("f32_f32", jacs32, x64.float(),
                                 TOL_MATVEC_F32),
                                ("f64_f64", jacs64, x64, TOL_F64)):
        def run(fn, jacs=jacs, x=x):
            y = torch.zeros_like(x)
            for b, A in zip(blocks, jacs):
                fn(A, b.dofs, x, y)
            return y
        rel, mx = rel_err(run(km4.elem_matvec_cuda),
                          run(km4.elem_matvec_plain))
        require(rel <= tol, f"elem_matvec {label}: rel {rel:.3e}")
        variants[label] = dict(
            rel_err=rel, max_abs_err=mx,
            ms=cuda_ms(lambda: run(km4.elem_matvec_cuda), 50),
            plain_ms=cuda_ms(lambda: run(km4.elem_matvec_plain), 5))
        print(f"    elem_matvec {label}: rel {rel:.3e} max_abs {mx:.3e} "
              f"kernel {variants[label]['ms']:.4f} ms plain "
              f"{variants[label]['plain_ms']:.4f} ms")
    # ---- K7's float64 sweep (the RAS rebuild's) on the float64
    # Jacobians at seeded scales: exact
    rng = np.random.default_rng(9)
    dr64, dc64 = (torch.as_tensor(rng.uniform(0.5, 2.0, ndof), device="cuda")
                  for _ in range(2))
    o64 = [torch.zeros(ndof, dtype=torch.float64, device="cuda")
           for _ in range(4)]

    def sweep64(fn, a, b):
        for blk, A in zip(blocks, jacs64):
            fn(A, blk.dofs, dr64, dc64, mask, a, b)

    sweep64(ks.ruiz_sweep_cuda, o64[0], o64[1])
    sweep64(ks.ruiz_sweep_plain, o64[2], o64[3])
    records.add("ruiz_sweep_f64", max(rel_err(o64[0], o64[2]),
                                      rel_err(o64[1], o64[3])),
                cuda_ms(lambda: sweep64(ks.ruiz_sweep_cuda, o64[0], o64[1]),
                        20),
                cuda_ms(lambda: sweep64(ks.ruiz_sweep_plain, o64[2], o64[3]),
                        5),
                (nbytes(*jacs64, dr64, dc64, mask) + dof_bytes + 16 * ndof,
                 5 * 4096 * K_all, "f64"), 0.0, f"K={K_all}, one sweep f64")
    del jacs64, o64
    # yardstick: cuSPARSE SpMV of the same (f32) matrix assembled as CSR
    rows = torch.cat([b.dofs[:, :, None].expand(-1, 64, 64).reshape(-1)
                      for b in blocks])
    cols = torch.cat([b.dofs[:, None, :].expand(-1, 64, 64).reshape(-1)
                      for b in blocks])
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.cat([A.reshape(-1) for A in jacs32]),
        (ndof, ndof)).coalesce().to_sparse_csr()
    del rows, cols
    x32 = x64.float()[:, None]
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, x32), 50)
    print(f"    cuSPARSE SpMV of the assembled f32 matrix "
          f"({csr._nnz()} nonzeros): {lib_ms:.4f} ms")
    del csr
    main = variants["f32_f64"]
    records.add("elem_matvec", (main["rel_err"], main["max_abs_err"]),
                main["ms"], main["plain_ms"],
                (nbytes(*jacs32) + dof_bytes + 2 * 8 * ndof,
                 2 * 4096 * K_all, "f32"), TOL_MATVEC_F32,
                f"K={K_all} f32 A, f64 x", library_ms=lib_ms,
                variants=variants)

    # ---- K7: one sweep at the converged scales, and the element rescale
    dr, dc = ruiz_scales(blocks, jacs32, mask, ndof, sweeps=4)
    outs = [torch.zeros(ndof, dtype=torch.float32, device="cuda")
            for _ in range(4)]
    for b, A in zip(blocks, jacs32):
        ks.ruiz_sweep_cuda(A, b.dofs, dr, dc, mask, outs[0], outs[1])
        ks.ruiz_sweep_plain(A, b.dofs, dr, dc, mask, outs[2], outs[3])
    err = max(rel_err(outs[0], outs[2]), rel_err(outs[1], outs[3]))

    def sweep(fn):
        for b, A in zip(blocks, jacs32):
            fn(A, b.dofs, dr, dc, mask, outs[0], outs[1])

    # yardstick: torch's scatter_reduce_ ("amax") of the row and column
    # maxima of the gathered, masked |dr A_e dc| (the gather and products
    # made beforehand, not timed)
    rows_idx = torch.cat([b.dofs.reshape(-1) for b in blocks])
    row_vals, col_vals = [], []
    for b, A in zip(blocks, jacs32):
        As = torch.abs(dr[b.dofs][:, :, None] * A * dc[b.dofs][:, None, :])
        bcm = mask[b.dofs]
        As = torch.where(bcm[:, :, None] | bcm[:, None, :], 0.0, As)
        row_vals.append(As.amax(dim=2).reshape(-1))
        col_vals.append(As.amax(dim=1).reshape(-1))
        del As
    row_vals, col_vals = torch.cat(row_vals), torch.cat(col_vals)

    def lib_sweep():
        outs[2].scatter_reduce_(0, rows_idx, row_vals, "amax")
        outs[3].scatter_reduce_(0, rows_idx, col_vals, "amax")

    lib_ms = cuda_ms(lib_sweep, 20)
    del row_vals, col_vals, rows_idx
    records.add("ruiz_sweep", err, cuda_ms(lambda: sweep(ks.ruiz_sweep_cuda),
                                           20),
                cuda_ms(lambda: sweep(ks.ruiz_sweep_plain), 5),
                (nbytes(*jacs32, dr, dc, mask) + dof_bytes + 8 * ndof,
                 5 * 4096 * K_all, "f32"), 0.0,
                f"K={K_all}, one sweep", library_ms=lib_ms)
    jf = [ks.ruiz_scale_cuda(A, b.dofs, dr, dc) for b, A in zip(blocks, jacs32)]
    jfp = [ks.ruiz_scale_plain(A, b.dofs, dr, dc)
           for b, A in zip(blocks, jacs32)]
    err = max(rel_err(a, b) for a, b in zip(jf, jfp))
    del jfp
    records.add("ruiz_scale", err,
                cuda_ms(lambda: [ks.ruiz_scale_cuda(A, b.dofs, dr, dc)
                                 for b, A in zip(blocks, jacs32)], 20),
                cuda_ms(lambda: [ks.ruiz_scale_plain(A, b.dofs, dr, dc)
                                 for b, A in zip(blocks, jacs32)], 5),
                (2 * nbytes(*jacs32) + dof_bytes + nbytes(dr, dc),
                 2 * 4096 * K_all, "f32"), 0.0, f"K={K_all}")
    del jacs32

    # ---- host setup, then K8 against its plain version on the host
    block_dofs = [b.dofs.cpu().numpy() for b in blocks]
    setup = {}
    tic = time.perf_counter()
    pat = fb.build_banded_pattern(block_dofs, ndof, timings=setup)
    setup["pattern"] = time.perf_counter() - tic
    tic = time.perf_counter()
    plans_np = fb.build_banded_assembly_plan(block_dofs, pat, bc.mask)
    setup["plan"] = time.perf_counter() - tic
    nsrc = sum(p["src"].shape[0] for per_t in plans_np for p in per_t)
    print(f"    banded pattern: c={pat.c} nb={pat.nb}; host pattern "
          f"{setup['pattern']:.2f} s (RCM {setup['rcm']:.2f} s), plan "
          f"{setup['plan']:.2f} s, {nsrc} entries")
    plans = fb.plans_to_device(plans_np, "cuda")
    diag = torch.as_tensor(fb.identity_diag_slots(pat, bc.mask),
                           device="cuda")
    Ck, Dk, Bk = kb.assemble_cuda(jf, plans, pat.nb, pat.c, diag)
    host = kb.assemble_plain([A.cpu() for A in jf],
                             fb.plans_to_device(plans_np, "cpu"), pat.nb,
                             pat.c, diag.cpu())
    err = (0.0, 0.0)
    for k, p in zip((Ck, Dk, Bk), host):
        kc = k.cpu()
        err = max(err, rel_err(kc, p)) if not torch.equal(kc, p) else err
        del kc
    del host
    plan_bytes = sum(nbytes(p["src"], p["udst"], p["starts"])
                     for per_t in plans for p in per_t)
    # yardstick: torch's index_add_ of the gathered in-band entries into
    # C/D/B in one call (the gather made beforehand, not timed)
    cdb = torch.zeros(3 * pat.factor_bytes // 4, dtype=torch.float32,
                      device="cuda")
    n_slot = pat.nb * pat.c * pat.c
    dst = torch.cat([p["dst"].long() + t * n_slot for per_t in plans
                     for t, p in enumerate(per_t)])
    vals = torch.cat([A.reshape(-1)[p["src"].long()]
                      for A, per_t in zip(jf, plans) for p in per_t])
    lib_ms = cuda_ms(lambda: cdb.index_add_(0, dst, vals), 3)
    del cdb, dst, vals
    records.add("banded_assemble", err,
                cuda_ms(lambda: kb.assemble_cuda(jf, plans, pat.nb, pat.c,
                                                 diag), 3),
                cuda_ms(lambda: kb.assemble_plain(jf, plans, pat.nb, pat.c,
                                                  diag), 1),
                (nbytes(*jf) + plan_bytes + 3 * pat.factor_bytes
                 + nbytes(diag), nsrc, "f32"), 0.0,
                f"{nsrc} entries -> 3x({pat.nb},{pat.c},{pat.c})",
                library_ms=lib_ms)
    del jf

    # ---- K9, K10 (torch), then K6 against its plain version
    tic = time.perf_counter()
    Sinv = fb.schur_scan(Ck, Dk, Bk)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - tic
    tic = time.perf_counter()
    H, G = fb.hg_factors(Sinv, Ck, Bk)
    torch.cuda.synchronize()
    t_hg = time.perf_counter() - tic
    tic = time.perf_counter()
    probe = fb.probe_rel(Ck, Dk, Bk, Sinv, H, G)
    t_probe = time.perf_counter() - tic
    print(f"    Schur scan (K9, torch) {t_scan * 1e3:.1f} ms, H/G "
          f"{t_hg * 1e3:.1f} ms, probe (K10) {t_probe * 1e3:.1f} ms, probe "
          f"rel {probe:.3e}")
    require(math.isfinite(probe), "the probe of the banded factors is not "
                                  "finite")
    k11 = phase_k11(records, Ck, Dk, Bk, probe, pat)
    perm = torch.as_tensor(pat.perm, device="cuda")
    r = torch.where(mask, 0.0, x64)
    xk = kb.apply_cuda(Sinv, H, G, perm, r)
    xp = kb.apply_plain(Sinv, H, G, perm, r)
    rb = torch.zeros(pat.npad, dtype=torch.float64, device="cuda")
    rb[:ndof] = r[perm].float().double()
    x_ref = kb.solve_blocks_plain(Sinv.double(), H.double(), G.double(),
                                  rb.view(pat.nb, pat.c)).reshape(-1)
    ref = torch.empty_like(r)
    ref[perm] = x_ref[:ndof]
    del x_ref, rb
    dk, dp = rel_err(xk, ref)[0], rel_err(xp, ref)[0]
    print(f"    banded_apply vs the f64 scans: kernel {dk:.3e}, plain "
          f"{dp:.3e}")
    require(dk <= 2 * dp + 1e-6, f"banded_apply is less accurate than its "
                                 f"plain version: {dk:.3e} vs {dp:.3e}")
    records.add("banded_apply", rel_err(xk, xp),
                cuda_ms(lambda: kb.apply_cuda(Sinv, H, G, perm, r), 20),
                cuda_ms(lambda: kb.apply_plain(Sinv, H, G, perm, r), 3),
                (3 * pat.factor_bytes + nbytes(r, perm) + 8 * ndof,
                 6 * pat.nb * pat.c * pat.c, "f32"), math.inf,
                f"3x({pat.nb},{pat.c},{pat.c}) f32, r f64",
                f64_rel_kernel=dk, f64_rel_plain=dp)
    storage = phase_storage_kernels(records, Ck, Dk, Bk, Sinv, perm, r, pat)
    storage.update(phase_carry_kernels(records, Ck, Dk, Bk, Sinv, H, G, perm,
                                       r, pat, probe))
    del Sinv, H, G
    gc.collect()
    torch.cuda.empty_cache()
    storage.update(phase_spike_kernels(records, Ck, Dk, Bk, pat, probe))
    del Ck, Dk, Bk
    return dict(scan_ms=t_scan * 1e3, hg_ms=t_hg * 1e3,
                probe_ms=t_probe * 1e3, probe_rel=probe, setup=setup,
                c=pat.c, nb=pat.nb, **k11, **storage)


def phase_storage_kernels(records, Ck, Dk, Bk, Sinv, perm, r, pat):
    """K6 in its hybrid (f32 Sinv, bf16 H/G) and all-bf16 instances and K12
    (bf16 C/B) with bf16 and with f32 Sinv, on the factors of K9's scan as
    each layout stores them (the bf16 scan stores the same polished
    inverses rounded, so its Sinv is K9's rounded), against their plain
    versions by K6's rule: the distance to the same scans in float64 on
    the same widened factors at most twice the plain version's plus 1e-6.
    Each bound reads every factor once (K12's scans read Sinv twice: the
    bound with that second read is printed beside it)."""
    import torch

    from vasp_tpu_torch.fem import banded as fb
    from vasp_tpu_torch.kernels import banded as kb

    bf = torch.bfloat16
    nb, c, ndof = pat.nb, pat.c, pat.ndof
    rb = torch.zeros(pat.npad, dtype=torch.float64, device="cuda")
    rb[:ndof] = r[perm].float().double()
    out = {}

    def check(name, cuda, plain, solve, F, ops, tag):
        xk, xp = cuda(*F, perm, r), plain(*F, perm, r)
        x_ref = solve(*F, rb.view(nb, c)).reshape(-1)  # float64 arithmetic
        ref = torch.empty_like(r)
        ref[perm] = x_ref[:ndof]
        dk, dp = rel_err(xk, ref)[0], rel_err(xp, ref)[0]
        print(f"    {name} vs the f64 scans: kernel {dk:.3e}, plain {dp:.3e}")
        require(dk <= 2 * dp + 1e-6, f"{name} is less accurate than its "
                                     f"plain version: {dk:.3e} vs {dp:.3e}")
        records.add(name, rel_err(xk, xp),
                    cuda_ms(lambda: cuda(*F, perm, r), 20),
                    cuda_ms(lambda: plain(*F, perm, r), 3),
                    (nbytes(*F, r, perm) + 8 * ndof, ops, "f32"), math.inf,
                    f"({nb},{c},{c}) {tag}, r f64", f64_rel_kernel=dk,
                    f64_rel_plain=dp)

    k6 = (kb.apply_cuda, kb.apply_plain, kb.solve_blocks_plain)
    k12 = (kb.apply_lowmem_cuda, kb.apply_lowmem_plain,
           kb.solve_blocks_lowmem_plain)
    F = (Sinv, fb.sinv_times(Sinv, Ck, bf), fb.sinv_times(Sinv, Bk, bf))
    check("banded_apply_hybrid", *k6, F, 6 * nb * c * c, "f32 Sinv, bf16 H/G")
    S16 = Sinv.to(bf)
    F = (S16, fb.sinv_times(S16, Ck, bf), fb.sinv_times(S16, Bk, bf))
    out["probe_rel_bf16"] = fb.probe_rel(Ck, Dk, Bk, *F)
    print(f"    probe of the full layout's bf16 factors (K10 on K6 bf16): "
          f"{out['probe_rel_bf16']:.3e}")
    check("banded_apply_bf16", *k6, F, 6 * nb * c * c, "bf16 Sinv/H/G")
    del F
    C16, B16 = Ck.to(bf), Bk.to(bf)
    for name, S in (("banded_apply_lowmem_bf16", S16),
                    ("banded_apply_lowmem_f32", Sinv)):
        check(name, *k12, (S, C16, B16), 8 * nb * c * c,
              f"{str(S.dtype)[6:]} Sinv, bf16 C/B")
        reread = (nbytes(S, S, C16, B16, r, perm) + 8 * ndof) \
            / HBM_BYTES_PER_S * 1e3
        records[name]["bound_ms_sinv_read_twice"] = reread
        print(f"    {name}: bound with Sinv read twice {reread:.4f} ms")
    return out


def _two_span_apply(stage, update, spans, rb, chain):
    """The sharded apply of parallel/banded_shard.py for two ranks, run in
    one process: rank 0 holds spans[0], rank 1 spans[1] (each (Sinv, H, G,
    Tf, Tb)), their stages and carries in the order the two ranks run
    them; chain: make_sharded_chain_apply (every rank's zero-carry scans,
    the carry updates, the scans again), else make_sharded_banded_apply."""
    import torch

    m = spans[0][0].shape[0]
    F0, F1 = spans[0][:3], spans[1][:3]
    t0 = stage(*F0, "times", rb[:m])
    t1 = stage(*F1, "times", rb[m:])
    if chain:
        wz0 = stage(*F0, "forward", t0)
        stage(*F1, "forward", t1)  # rank 1's zero-carry scan
        w_in = update(spans[0][3], torch.zeros_like(wz0[-1]), wz0[-1])
    w0 = stage(*F0, "forward", t0)
    w1 = stage(*F1, "forward", t1, w_in if chain else w0[-1])
    if chain:
        stage(*F0, "backward", w0)  # rank 0's zero-carry scan
        xz1 = stage(*F1, "backward", w1)
        x_in = update(spans[1][4], torch.zeros_like(xz1[0]), xz1[0])
    x1 = stage(*F1, "backward", w1)
    x0 = stage(*F0, "backward", w0, x_in if chain else x1[0])
    return torch.cat([x0, x1])


def phase_carry_kernels(records, Ck, Dk, Bk, Sinv, H, G, perm, r, pat,
                        probe):
    """Phase 15a: K21a on phase 2's K9 factors at the 20,832-cell tube,
    split into two spans of nb/2 blocks as two ranks hold them: its
    zero-carry and true-carry passes on each span (a pass is the three
    stages, t = Sinv r, the forward and the backward scan), and the two
    ranks' chain and Thomas applies composed in this process, each by K6's
    rule (the distance to the same scans in float64 at most twice the
    plain version's plus 1e-6), the compositions against K6's
    single-device apply too; each single stage by carry_stage_checks.
    Timed on the second span: the chain apply of rank 1 of 2 (its three
    stages and carry update, as parallel/banded_shard.py runs them)
    beside its bound (Sinv + H + G and Tb read) and its plain version;
    likewise rank 0's, an interior rank's (Sinv + 2H + 2G, Tf and Tb) and
    rank 1's Thomas apply (Sinv + H + G); and the carry update (with
    torch.addmv as the yardstick); the probes of both compositions beside
    phase 2's."""
    import torch

    from vasp_tpu_torch.kernels import banded as kb
    from vasp_tpu_torch.parallel.banded_shard import (
        sharded_transfer_products,
    )

    nb, c, ndof = pat.nb, pat.c, pat.ndof
    m = nb // 2
    print(f"[15a] K21a on phase 2's factors split into two spans of {m} "
          f"blocks (c={c}):")
    spans = []
    for sl in (slice(0, m), slice(m, nb)):
        F = (Sinv[sl], H[sl], G[sl])
        spans.append(F + sharded_transfer_products(F[1], F[2]))
    rb = torch.zeros(pat.npad, dtype=torch.float32, device="cuda")
    rb[:ndof] = r[perm].float()
    rb = rb.view(nb, c)
    out = {}

    def k6_rule(name, xk, xp, ref):
        dk, dp = rel_err(xk, ref)[0], rel_err(xp, ref)[0]
        print(f"    {name} vs the f64 scans: kernel {dk:.3e}, plain {dp:.3e}")
        require(dk <= 2 * dp + 1e-6, f"{name} is less accurate than its "
                                     f"plain version: {dk:.3e} vs {dp:.3e}")
        return dk, dp

    # the passes of each span with its true carries (rank 0 receives x_in,
    # rank 1 w_in) and with none
    w_in = kb.solve_blocks_carry_plain(*spans[0][:3], rb[:m])[1]
    x_in = kb.solve_blocks_carry_plain(*spans[1][:3], rb[m:], w_in)[2]
    out["stage_ratio_max"] = carry_stage_checks(spans, w_in, x_in, c)
    for k, carries in ((0, (None, x_in)), (1, (w_in, None))):
        F, a = spans[k][:3], rb[k * m:(k + 1) * m]
        for label, cy in (("zero-carry", (None, None)), ("true-carry",
                                                          carries)):
            # a pass's outputs, x, w_last and x_first, as one vector
            xk, xp, ref = (torch.cat([o.reshape(-1) for o in outs])
                           for outs in (
                kb.solve_blocks_carry_cuda(*F, a, *cy),
                kb.solve_blocks_carry_plain(*F, a, *cy),
                kb.solve_blocks_carry_plain(
                    *F, a.double(), *(None if v is None else v.double()
                                      for v in cy))))
            k6_rule(f"span {k} {label} pass", xk, xp, ref)
    # float64 arithmetic on the float32 factors (bgemv widens each block
    # to the vector's type)
    x64 = kb.solve_blocks_plain(Sinv, H, G, rb.double())
    xk6 = kb.solve_blocks_cuda(Sinv, H, G, rb)
    b = torch.where(torch.arange(pat.npad, device="cuda") % 2 == 0, 1.0,
                    -1.0).view(nb, c)

    def probe_of(x):
        y = kb.bgemv(Dk, x)
        y[1:] += kb.bgemv(Ck[1:], x[:-1])
        y[:-1] += kb.bgemv(Bk[:-1], x[1:])
        return float(torch.linalg.norm(y - b) / torch.linalg.norm(b))

    for algo, chain in (("chain", True), ("thomas", False)):
        xk = _two_span_apply(kb.carry_stage_cuda, kb.carry_update_cuda,
                             spans, rb, chain)
        xp = _two_span_apply(kb.carry_stage_plain, kb.carry_update_plain,
                             spans, rb, chain)
        dk, _ = k6_rule(f"two-rank {algo} apply", xk, xp, x64)
        dk6 = rel_err(xk6, x64)[0]
        require(dk <= 2 * dk6 + 1e-6, f"the two-rank {algo} apply is less "
                                      f"accurate than K6's: {dk:.3e} vs "
                                      f"{dk6:.3e}")
        pr = probe_of(_two_span_apply(kb.carry_stage_cuda,
                                      kb.carry_update_cuda, spans, b, chain))
        print(f"    two-rank {algo} apply: K6 single-device {dk6:.3e} from "
              f"the f64 scans; probe {pr:.3e} (K6's {probe:.3e})")
        out[f"probe_rel_{algo}"] = pr
        out[f"f64_rel_{algo}"] = dk

    # one rank's applies, timed on the second span with the true carries:
    # the stages and carry updates that parallel/banded_shard.py runs on
    # rank 1 of 2 (the last rank), on rank 0 of 2 (the first) and on an
    # interior rank (from three ranks on), each bound by what it reads
    F1, a1 = spans[1], rb[m:]
    zero_in = torch.zeros(c, dtype=torch.float32, device="cuda")
    block_bytes = nbytes(F1[0]) // m

    def rank_apply(stage, update, first, last, chain=True):
        Fs, (Tf, Tb) = F1[:3], F1[3:]
        t = stage(*Fs, "times", a1)
        if not chain:
            w = stage(*Fs, "forward", t, None if first else w_in)
            return stage(*Fs, "backward", w, None if last else x_in)
        wz = stage(*Fs, "forward", t) if first or not last else None
        if not last:
            update(Tf, zero_in if first else w_in, wz[-1])
        w = wz if first else stage(*Fs, "forward", t, w_in)
        xz = stage(*Fs, "backward", w) if last or not first else None
        if not first:
            update(Tb, zero_in if last else x_in, xz[0])
        return xz if last else stage(*Fs, "backward", w, x_in)

    def timed(first, last, chain=True):
        xk = rank_apply(kb.carry_stage_cuda, kb.carry_update_cuda, first,
                        last, chain)
        xp = rank_apply(kb.carry_stage_plain, kb.carry_update_plain, first,
                        last, chain)
        ms = cuda_ms(lambda: rank_apply(kb.carry_stage_cuda,
                                        kb.carry_update_cuda, first, last,
                                        chain), 10)
        plain_ms = cuda_ms(lambda: rank_apply(kb.carry_stage_plain,
                                              kb.carry_update_plain, first,
                                              last, chain), 3)
        interior = chain and not (first or last)
        stages = 5 if interior else 3
        updates = 0 if not chain else 2 if interior else 1
        # each stage reads its m factor blocks once, each update one c x c
        work = ((stages * m + updates) * block_bytes + nbytes(a1, xk),
                2 * (stages * m + updates) * c * c, "f32")
        return xk, xp, ms, plain_ms, work

    xk, xp, ms, plain_ms, work = timed(False, True)
    records.add("banded_carry", rel_err(xk, xp), ms, plain_ms, work,
                math.inf, f"rank 1 of 2: 3 stages, ({m},{c},{c}) f32")
    for label, key, first, last, chain in (
            ("rank 0's chain apply (3 stages, 1 update)", "rank0", True,
             False, True),
            ("an interior rank's chain apply (5 stages, 2 updates)",
             "interior", False, False, True),
            ("rank 1's Thomas apply (3 stages)", "thomas", False, True,
             False)):
        _, _, ms, plain_ms, work = timed(first, last, chain)
        b_ms = bound(*work)[0]
        records["banded_carry"].update({f"{key}_ms": ms,
                                        f"{key}_plain_ms": plain_ms,
                                        f"{key}_bound_ms": b_ms})
        print(f"    {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms")
    Tf, v, a = F1[3], w_in, a1[0]
    uk, up = kb.carry_update_cuda(Tf, v, a), kb.carry_update_plain(Tf, v, a)
    k6_rule("carry update", uk, up, a.double() + Tf.double() @ v.double())
    records.add("banded_carry_update", rel_err(uk, up),
                cuda_ms(lambda: kb.carry_update_cuda(Tf, v, a), 50),
                cuda_ms(lambda: kb.carry_update_plain(Tf, v, a), 50),
                (nbytes(Tf, v, a, uk), 2 * c * c, "f32"), math.inf,
                f"({c},{c}) f32", library_ms=cuda_ms(
                    lambda: torch.addmv(a, Tf, v), 50))
    return out


def _test_helpers():
    """tests/_torch_dist.py (numpy and torch only): thread_ranks, which
    composes several ranks in this process (threads, each with a
    Collectives whose all-reduce sums the ranks' buffers), and
    plain_banded."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import _torch_dist

    return _torch_dist


def _spike_ranks(fn):
    """fn(comm) on two ranks composed in this process."""
    return _test_helpers().thread_ranks(2, fn)


def phase_spike_kernels(records, Ck, Dk, Bk, pat, probe):
    """Phase 15c: SPIKE (K21f) on phase 2's C/D/B at the 20,832-cell tube
    split into two ranks' spans of nb/2 blocks, the two ranks composed in
    this process (_spike_ranks): each rank's factorization (torch, timed);
    K21f-a on rank 1's span against its plain version by K6's rule (the
    distance to the float64 residual on the same float32 inputs at most
    twice the plain version's plus 1e-6), timed beside its bound (C + D +
    B of the span read), its plain version and one torch.bmm of the
    stacked blocks; the two-rank SPIKE apply through the kernels (K21a's
    stages, the carry updates, K21f-a) against the same apply through the
    plain versions with refine 0 and 2: its probe at most twice the plain
    apply's plus 1e-6 (the tolerance of tests/test_torch_kernels_cuda.py:
    the partitioned solve is not backward stable, so the two float32
    results part where the local inverses amplify rounding, and the probe
    is what a preconditioner is held to), each apply's time beside the
    bound of the bytes both ranks read."""
    import numpy as np
    import torch

    from vasp_tpu_torch.kernels import banded as kb
    from vasp_tpu_torch.parallel import banded_shard as bs

    nb, c, dev = pat.nb, pat.c, Dk.device
    require(nb % 2 == 0, f"15c needs an even block count, got {nb}")
    m = nb // 2
    spans = [tuple(M[sl] for M in (Ck, Dk, Bk))
             for sl in (slice(0, m), slice(m, nb))]
    plan = bs.ShardPlan(c=c, nb_loc=m, span=m * c, n=2, ndof=pat.ndof,
                        npad=pat.npad, perm=None, iperm=None)
    print(f"[15c] SPIKE on phase 2's C/D/B split into two spans of {m} "
          f"blocks (c={c}), the two ranks composed in this process:")
    out = {}
    for refine in (0, 2):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        factors = _spike_ranks(lambda comm: bs.sharded_factorize_spike(
            *spans[comm.rank], comm, refine=refine))
        torch.cuda.synchronize()
        fact_s = time.perf_counter() - tic

        def apply_all(rhs):
            return _spike_ranks(lambda comm: bs.make_sharded_spike_apply(
                plan, comm, refine)(factors[comm.rank], rhs[comm.rank]))

        def probes():
            return _spike_ranks(lambda comm: bs.sharded_probe_rel(
                *spans[comm.rank], factors[comm.rank],
                bs.make_sharded_spike_apply(plan, comm, refine), comm))

        rhs = [torch.as_tensor(np.random.default_rng((15, k)).normal(
            size=m * c), dtype=torch.float32, device=dev)
            for k in range(2)]
        pk = probes()
        xk = torch.cat(apply_all(rhs))
        ms = cuda_ms(lambda: apply_all(rhs), 5)
        with _test_helpers().plain_banded():
            pp = probes()
            xp = torch.cat(apply_all(rhs))
            plain_ms = cuda_ms(lambda: apply_all(rhs), 2)
        require(pk[0] == pk[1] and pp[0] == pp[1], f"15c: the ranks read "
                                                   f"other probes {pk} {pp}")
        require(pk[0] <= 2 * pp[0] + 1e-6,
                f"15c: the SPIKE apply (refine {refine}) through the kernels "
                f"probes {pk[0]:.3e}, through the plain versions "
                f"{pp[0]:.3e}")
        # the bytes both ranks read: rank 0's first local solve two stages
        # (Sinv, H), every other solve three, each refinement pass C + D + B
        block = 4 * c * c
        solves = (2 + 3) + (3 + 3)
        b_ms = bound((1 + refine) * solves * m * block
                     + refine * 2 * 3 * m * block, 0, "f32")[0]
        print(f"    refine {refine}: factorization {fact_s:.2f} s (both "
              f"ranks); probe {pk[0]:.3e} through the kernels, {pp[0]:.3e} "
              f"through the plain versions (K9's single-device {probe:.3e}); "
              f"kernel and plain applies {rel_err(xk, xp)[0]:.3e} apart; "
              f"apply {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms (bytes of both ranks)")
        out[f"spike{refine}"] = dict(probe=pk[0], probe_plain=pp[0],
                                     factorize_s=fact_s, apply_ms=ms,
                                     apply_plain_ms=plain_ms,
                                     apply_bound_ms=b_ms)
        del factors
    # K21f-a on rank 1's span: x and r seeded, rank 0's last row its x_{-1}
    Cs, Ds, Bs = spans[1]
    g = np.random.default_rng(151)
    x, r = (torch.as_tensor(g.normal(size=(m, c)), dtype=torch.float32,
                            device=dev) for _ in range(2))
    xprev = torch.as_tensor(g.normal(size=c), dtype=torch.float32,
                            device=dev)
    yk = kb.tri_residual_cuda(Cs, Ds, Bs, x, r, xprev)
    yp = kb.tri_residual_plain(Cs, Ds, Bs, x, r, xprev)
    ref = kb.tri_residual_plain(Cs, Ds, Bs, x.double(), r.double(),
                                xprev.double())
    dk, dp = rel_err(yk, ref)[0], rel_err(yp, ref)[0]
    del ref
    print(f"    banded_tri_residual vs float64: kernel {dk:.3e}, plain "
          f"{dp:.3e}")
    require(dk <= 2 * dp + 1e-6, f"banded_tri_residual is less accurate "
                                 f"than its plain version: {dk:.3e} vs "
                                 f"{dp:.3e}")
    ms = cuda_ms(lambda: kb.tri_residual_cuda(Cs, Ds, Bs, x, r, xprev), 20)
    plain_ms = cuda_ms(lambda: kb.tri_residual_plain(Cs, Ds, Bs, x, r,
                                                     xprev), 5)
    M3 = torch.cat([Cs, Ds, Bs])
    V3 = torch.cat([torch.cat([xprev[None], x[:-1]]), x,
                    torch.cat([x[1:], torch.zeros_like(x[:1])])])[..., None]
    lib_ms = cuda_ms(lambda: torch.bmm(M3, V3), 20)
    del M3, V3
    records.add("banded_tri_residual", rel_err(yk, yp), ms, plain_ms,
                (nbytes(Cs, Ds, Bs, x, r, xprev, yk), 6 * m * c * c, "f64"),
                math.inf, f"3x({m},{c},{c}) f32", library_ms=lib_ms,
                f64_rel_kernel=dk, f64_rel_plain=dp)
    return out


def carry_stage_checks(spans, w_in, x_in, c, seeds=3):
    """K21a's single stages on the two spans at seeded right-hand sides,
    each with and without its incoming carry: the kernel's distance to the
    same stage in float64 on the same float32 inputs at most
    TOL_CARRY_STAGE_RATIO times the plain version's plus 1e-6. Returns the
    largest ratio."""
    import numpy as np
    import torch

    from vasp_tpu_torch.kernels import banded as kb

    worst = {}
    for seed in range(seeds):
        for k, Fk in enumerate(s[:3] for s in spans):
            a = torch.as_tensor(np.random.default_rng((seed, k)).normal(
                size=tuple(Fk[0].shape[:2])), dtype=torch.float32,
                device="cuda")
            t = kb.carry_stage_plain(*Fk, "times", a)
            w = kb.carry_stage_plain(*Fk, "forward", t, w_in if k else None)
            for name, stage, inp, carry in (
                    ("times", "times", a, None),
                    ("forward", "forward", t, None),
                    ("forward+carry", "forward", t, w_in),
                    ("backward", "backward", w, None),
                    ("backward+carry", "backward", w, x_in)):
                ref = kb.carry_stage_plain(
                    *Fk, stage, inp.double(),
                    None if carry is None else carry.double())
                dk = rel_err(kb.carry_stage_cuda(*Fk, stage, inp, carry),
                             ref)[0]
                dp = rel_err(kb.carry_stage_plain(*Fk, stage, inp, carry),
                             ref)[0]
                require(dk <= TOL_CARRY_STAGE_RATIO * dp + 1e-6,
                        f"K21a's {name} stage (span {k}, seed {seed}) is "
                        f"less accurate than its plain version: {dk:.3e} "
                        f"vs {dp:.3e}")
                worst[name] = max(worst.get(name, 0.0),
                                  dk / max(dp, 1e-300))
    print("    single stages, largest kernel/plain ratio of the distances "
          "to float64 over both spans and " + f"{seeds} seeds: "
          + ", ".join(f"{n} {r:.3f}" for n, r in worst.items()))
    return max(worst.values())


def phase_k11(records, Ck, Dk, Bk, probe32, pat):
    """K11, the escalation tier's float64 Schur scan and its H/G, on the
    C/D/B of K9: timed once (it is seconds), its probe no worse than K9's,
    and its first two blocks held against the same recursion on the host
    (the recursion of block k reads blocks 0..k only)."""
    import torch

    from vasp_tpu_torch.fem import banded as fb

    torch.cuda.synchronize()
    tic = time.perf_counter()
    Sinv = fb.schur_scan_f64(Ck, Dk, Bk)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - tic
    tic = time.perf_counter()
    H, G = fb.hg_factors(Sinv, Ck, Bk)
    torch.cuda.synchronize()
    t_hg = time.perf_counter() - tic
    probe = fb.probe_rel(Ck, Dk, Bk, Sinv, H, G)
    del H, G
    print(f"    f64 Schur scan (K11, torch float64) {t_scan * 1e3:.1f} ms, "
          f"H/G {t_hg * 1e3:.1f} ms, probe rel {probe:.3e} (K9 "
          f"{probe32:.3e})")
    require(probe <= probe32, f"the f64 factors probe worse than the f32 "
                              f"ones: {probe:.3e} > {probe32:.3e}")
    host = fb.schur_scan_f64(Ck[:2].cpu(), Dk[:2].cpu(), Bk[:2].cpu())
    err = rel_err(Sinv[:2].cpu(), host)
    del Sinv, host
    c, nb = pat.c, pat.nb
    ms = (t_scan + t_hg) * 1e3
    # 6 c^3 float64 per block (C G, the LU inverse, Sinv B) on the f64
    # tensor cores, 4 c^3 float32 per block (H, G); each at 67 TFLOP/s
    records.add("banded_factorize_f64", err, ms, ms,
                (6 * pat.factor_bytes, 10 * c ** 3 * nb, "f64_tensor"),
                1e-5, f"3x({nb},{c},{c}) f32, f64 recursion",
                plain_is_kernel=True)
    return dict(scan64_ms=t_scan * 1e3, hg64_ms=t_hg * 1e3,
                probe64_rel=probe)


def phase_facet_kernels(records):
    """K14, K4 and K7 at the facet blocks' 36 local dofs, and K19c, against
    their plain versions at the 20,832-cell aneurysm tube."""
    import numpy as np
    import torch

    from vasp_tpu_torch.fem.assembly import FacetBlock
    from vasp_tpu_torch.fem.measures import cell_tables
    from vasp_tpu_torch.kernels import facet
    from vasp_tpu_torch.kernels import matvec as km4
    from vasp_tpu_torch.kernels import measures as km
    from vasp_tpu_torch.kernels import scaling as ks

    f32, f64 = torch.float32, torch.float64
    system, bc, U, _ = build_system(MODEL_MESH, "cuda", 1, "aneurysm")
    space = system.space
    ndof = space.ndof
    (fb,) = [b for b in system.assembler.blocks if isinstance(b, FacetBlock)]
    K = fb.dofs.shape[0]
    print(f"[2] aneurysm tube: {system.mesh.num_cells} cells, {ndof} dofs, "
          f"blocks " + ", ".join(f"{b.name}={b.dofs.shape[0]}"
                                 for b in system.assembler.blocks))
    rng = np.random.default_rng(2)
    R = torch.zeros_like(U)
    # the facet blocks touch a few thousand of the ndof entries: the bounds
    # count each entry they read once and each they write once
    n_all = int(torch.unique(fb.dofs).numel())
    n_v = int(torch.unique(fb.dofs[:, 18:]).numel())
    print(f"    facet blocks touch {n_all} entries ({n_v} velocity rows)")

    # ---- K14 residual: the facets' U entries read, their v rows written
    io_bytes = nbytes(fb.dofs, fb.area2) + 8 * (n_all + n_v)
    Rk = facet.residual_cuda(fb, U, torch.zeros_like(U))
    Rp = facet.residual_plain(fb, U, torch.zeros_like(U))
    records.add("robin_residual", rel_err(Rk, Rp),
                cuda_ms(lambda: facet.residual_cuda(fb, U, R), 50),
                cuda_ms(lambda: facet.residual_plain(fb, U, R), 10),
                (io_bytes, count_ops(lambda: facet.residual_plain(
                    fb, U, torch.zeros_like(U))), "f64"), TOL_F64,
                f"K={K} -> ({ndof},)")
    Rk32 = facet.residual_cuda(fb, U, torch.zeros_like(U), f32)
    Rp32 = facet.residual_plain(fb, U, torch.zeros_like(U), f32)
    floor = float((Rp32 - Rp).norm())
    records.add("robin_residual_f32", rel_err(Rk32, Rp32),
                cuda_ms(lambda: facet.residual_cuda(fb, U, R, f32), 50),
                cuda_ms(lambda: facet.residual_plain(fb, U, R, f32), 10),
                (io_bytes, count_ops(lambda: facet.residual_plain(
                    fb, U, torch.zeros_like(U), f32)), "f32"),
                (2 * floor + 1e-14 * float(Rp.norm())) / float(Rp32.norm()),
                f"K={K} f32 -> ({ndof},)",
                plain_rel_to_f64=floor / float(Rp.norm()),
                kernel_rel_to_f64=float((Rk32 - Rp).norm() / Rp.norm()))
    del Rk, Rp, Rk32, Rp32

    # ---- K14 Jacobians: the closed form's operations (M from the rule,
    # then the 216 nonzero products of each block); the output written
    Ap = facet.jacobian_plain(fb, U)
    nq = len(fb.kernel.tables_np[0])
    jac_ops = K * (36 * 3 * nq + 216)
    for dt, suffix, tol in ((f64, "", TOL_F64), (f32, "_f32", TOL_JAC_F32)):
        Ak = facet.jacobian_cuda(fb, U.device, dt)
        records.add(
            f"robin_jacobian{suffix}", _per_block_rel(Ak, Ap.to(dt)),
            cuda_ms(lambda: facet.jacobian_cuda(fb, U.device, dt), 50),
            cuda_ms(lambda: facet.jacobian_plain(fb, U).to(dt), 5),
            (nbytes(fb.area2, Ak), jac_ops, "f64"), tol,
            f"K={K} -> ({K},36,36) {dt}".replace("torch.", ""))
    del Ap

    # ---- K4 at 36: the four dtype instances; the main record is the
    # aneurysm's f32f path's (f32 A, f32 x; x read and y written on the
    # touched entries)
    A32 = facet.jacobian_cuda(fb, U.device, f32)
    A64 = facet.jacobian_cuda(fb, U.device, f64)
    x64 = torch.as_tensor(rng.normal(size=ndof), device="cuda")
    variants = {}
    for label, A, x, tol in (("f32_f64", A32, x64, TOL_MATVEC_F32),
                             ("f32_f32", A32, x64.float(), TOL_MATVEC_F32),
                             ("f64_f64", A64, x64, TOL_F64),
                             ("f64_f32", A64, x64.float(), TOL_MATVEC_F32)):
        def run(fn, A=A, x=x):
            y = torch.zeros_like(x)
            fn(A, fb.dofs, x, y)
            return y
        rel, mx = rel_err(run(km4.elem_matvec_cuda),
                          run(km4.elem_matvec_plain))
        require(rel <= tol, f"elem_matvec_36 {label}: rel {rel:.3e}")
        variants[label] = dict(
            rel_err=rel, max_abs_err=mx,
            ms=cuda_ms(lambda: run(km4.elem_matvec_cuda), 100),
            plain_ms=cuda_ms(lambda: run(km4.elem_matvec_plain), 20))
        print(f"    elem_matvec_36 {label}: rel {rel:.3e} max_abs {mx:.3e} "
              f"kernel {variants[label]['ms']:.4f} ms plain "
              f"{variants[label]['plain_ms']:.4f} ms")
    del A64
    csr = torch.sparse_coo_tensor(
        torch.stack([fb.dofs[:, :, None].expand(-1, 36, 36).reshape(-1),
                     fb.dofs[:, None, :].expand(-1, 36, 36).reshape(-1)]),
        A32.reshape(-1), (ndof, ndof)).coalesce().to_sparse_csr()
    x32 = x64.float()[:, None]
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, x32), 100)
    print(f"    cuSPARSE SpMV of the assembled f32 facet matrix "
          f"({csr._nnz()} nonzeros): {lib_ms:.4f} ms")
    del csr
    main = variants["f32_f32"]
    records.add("elem_matvec_36", (main["rel_err"], main["max_abs_err"]),
                main["ms"], main["plain_ms"],
                (nbytes(A32, fb.dofs) + 2 * 4 * n_all, 2 * 1296 * K, "f32"),
                TOL_MATVEC_F32, f"K={K} f32 A, f32 x", library_ms=lib_ms,
                variants=variants)

    # ---- K7 at 36: one sweep and the rescale, at seeded scales
    mask = bc.mask_on("cuda")
    dr, dc = (torch.as_tensor(rng.uniform(0.5, 2.0, ndof), dtype=f32,
                              device="cuda") for _ in range(2))
    outs = [torch.zeros(ndof, dtype=f32, device="cuda") for _ in range(4)]
    # on the touched entries: dr, dc and the mask read, the row and column
    # maxima written
    sweep_bytes = nbytes(A32, fb.dofs) + n_all * (4 + 4 + 4 + 4
                                                  + mask.element_size())
    ks.ruiz_sweep_cuda(A32, fb.dofs, dr, dc, mask, outs[0], outs[1])
    ks.ruiz_sweep_plain(A32, fb.dofs, dr, dc, mask, outs[2], outs[3])
    records.add("ruiz_sweep_36", max(rel_err(outs[0], outs[2]),
                                     rel_err(outs[1], outs[3])),
                cuda_ms(lambda: ks.ruiz_sweep_cuda(A32, fb.dofs, dr, dc, mask,
                                                   outs[0], outs[1]), 100),
                cuda_ms(lambda: ks.ruiz_sweep_plain(A32, fb.dofs, dr, dc,
                                                    mask, outs[2], outs[3]),
                        20),
                (sweep_bytes, 5 * 1296 * K, "f32"), 0.0, f"K={K}, one sweep")
    # the float64 instance at 36 (RAS on a Robin model): exact
    A64, dr64, dc64 = A32.double(), dr.double(), dc.double()
    o64 = [torch.zeros(ndof, dtype=torch.float64, device="cuda")
           for _ in range(4)]
    ks.ruiz_sweep_cuda(A64, fb.dofs, dr64, dc64, mask, o64[0], o64[1])
    ks.ruiz_sweep_plain(A64, fb.dofs, dr64, dc64, mask, o64[2], o64[3])
    require(torch.equal(o64[0], o64[2]) and torch.equal(o64[1], o64[3]),
            "ruiz_sweep_36_f64 disagrees with its plain version")
    records["ruiz_sweep_36"]["variants"] = {"f64": dict(
        rel_err=0.0, ms=cuda_ms(lambda: ks.ruiz_sweep_cuda(
            A64, fb.dofs, dr64, dc64, mask, o64[0], o64[1]), 100))}
    print(f"    ruiz_sweep_36_f64: exact, kernel "
          f"{records['ruiz_sweep_36']['variants']['f64']['ms']:.4f} ms")
    del A64, o64
    records.add("ruiz_scale_36",
                rel_err(ks.ruiz_scale_cuda(A32, fb.dofs, dr, dc),
                        ks.ruiz_scale_plain(A32, fb.dofs, dr, dc)),
                cuda_ms(lambda: ks.ruiz_scale_cuda(A32, fb.dofs, dr, dc), 100),
                cuda_ms(lambda: ks.ruiz_scale_plain(A32, fb.dofs, dr, dc), 20),
                (2 * nbytes(A32) + nbytes(fb.dofs) + 8 * n_all, 2 * 1296 * K,
                 "f32"), 0.0, f"K={K}")
    del A32

    # ---- K19c on a displacement with strains ~1e-2
    d = torch.as_tensor(1e-2 * system.mesh.hmin * rng.normal(
        size=(space.n_p2, 3)), device="cuda")
    tabs = cell_tables(space, d.device, 2)
    cell_dofs, Jinv, _, dN2, wq = tabs
    jk = km.dg0_project_jacobian_cuda(d, cell_dofs, Jinv, dN2, wq)
    jp = km.dg0_project_jacobian_plain(d, cell_dofs, Jinv, dN2, wq)
    print(f"    K19c input: max |J - 1| {float((jp - 1.0).abs().max()):.3e}")
    records.add("dg0_project_jacobian", rel_err(jk, jp),
                cuda_ms(lambda: km.dg0_project_jacobian_cuda(
                    d, cell_dofs, Jinv, dN2, wq), 50),
                cuda_ms(lambda: km.dg0_project_jacobian_plain(
                    d, cell_dofs, Jinv, dN2, wq), 20),
                (nbytes(d, cell_dofs, Jinv, dN2, wq, jk),
                 count_ops(lambda: km.dg0_project_jacobian_plain(
                     d, cell_dofs, Jinv, dN2, wq)), "f64"), TOL_F64,
                f"Nc={cell_dofs.shape[0]}")


def phase_mr_kernels(records):
    """K2 and K3 in Mooney-Rivlin (f64 and f32) against their plain
    versions at the 20,832-cell predeform tube, on a displacement with
    strains ~1e-2 (so that the log1p and cofactor terms count); then once
    more with the AVF vein's constants, kept as the records' "vein"
    variant, so that both MR parameter sets launch."""
    import dataclasses

    import numpy as np
    import torch

    from vasp_tpu_torch.fem.forms import make_solid_kernel
    from vasp_tpu_torch.fem.kinematics import E_

    system, _ = model_system("predeform", MODEL_MESH, "cuda")
    space = system.space
    (b,) = [b for b in system.assembler.blocks
            if b.kernel.kind == "solid"]
    rng = np.random.default_rng(4)
    scale = np.concatenate([np.full(3 * space.n_p2, 1e-2 * system.mesh.hmin),
                            np.full(3 * space.n_p2, 1e-2),
                            np.full(space.n_p1, 1e2)])
    U, U0 = (torch.as_tensor(rng.normal(size=space.ndof) * scale,
                             device="cuda") for _ in range(2))
    _, _, _, dN2 = (torch.as_tensor(a, device="cuda")
                    for a in b.kernel.tables_np)
    G = torch.einsum("qaj,kjl->kqal", dN2, b.Jinv)
    de = U[b.dofs[:, :30]].reshape(-1, 10, 3)
    E = E_(torch.einsum("kai,kqaj->kqij", de, G)).abs().amax(dim=(2, 3))
    print(f"[2] predeform tube: {system.mesh.num_cells} cells, {space.ndof} "
          f"dofs, blocks " + ", ".join(f"{x.name}={x.dofs.shape[0]}"
                                       for x in system.assembler.blocks)
          + f"; MR wall strains max |E| median {float(E.median()):.2e}, "
          f"max {float(E.max()):.2e}")
    element_block_records(records, b, U, U0, " MR")
    kern = b.kernel
    vein = dataclasses.replace(b, kernel=make_solid_kernel(
        VEIN, kern.dt, kern.theta, quad_degree=kern.quad_degree))
    sub = Records()
    element_block_records(sub, vein, U, U0, " MR vein")
    for name, r in sub.items():
        records[name]["variants"] = {"vein": r}


def phase_lifting_kernels(records, system, U, U0):
    """At the 20,832-cell tube: the fluid's elastic and no-lifting
    instances of K1/K3 against their plain versions (their own records),
    p_stab on the Laplace and the elastic instance and the solid's gravity
    (variants, by the same checks), and K16 in float64 and float32 on the tube's biharmonic
    tables (bc1, beta = 1) with cuSPARSE's SpMV of the correction's CSR
    as its yardstick."""
    import dataclasses

    import torch

    from vasp_tpu_torch.fem.biharmonic import build_biharmonic, correction_csr
    from vasp_tpu_torch.fem.forms import make_fluid_kernel, make_solid_kernel
    from vasp_tpu_torch.kernels import lifting

    (fluid,) = [b for b in system.assembler.blocks if b.kernel.kind == "fluid"]
    (solid,) = [b for b in system.assembler.blocks if b.kernel.kind == "solid"]
    fk, sk = fluid.kernel, solid.kernel

    def fluid_block(**kw):
        return dataclasses.replace(fluid, kernel=make_fluid_kernel(
            fk.rho_f, fk.mu_f, fk.dt, fk.theta, lift_sub=fk.lift_sub,
            lift_coeff=fk.lift_coeff, quad_degree=fk.quad_degree, **kw))

    element_block_records(records, fluid_block(lift="elastic"), U, U0,
                          " elastic")
    element_block_records(records, fluid_block(lift="no_extrapolation"), U,
                          U0, " nolift")
    # p_stab and gravity are parameters of existing instances: kept as
    # variants of those instances' records
    for variant, b in (
            ("p_stab", fluid_block(p_stab=P_STAB)),
            ("p_stab", fluid_block(lift="elastic", p_stab=P_STAB)),
            ("gravity", dataclasses.replace(solid, kernel=make_solid_kernel(
                sk.props, sk.dt, sk.theta, gravity=GRAVITY,
                quad_degree=sk.quad_degree)))):
        sub = Records()
        element_block_records(sub, b, U, U0, f" {variant}")
        for name, r in sub.items():
            records[name].setdefault("variants", {})[variant] = r

    space = system.space
    lift = build_biharmonic(system.mesh, space, [1], sub_type="bc1",
                            quad_degree=3, beta=1.0, device="cuda")
    K = lift["p2dofs"].shape[0]
    ndof, n_d = space.ndof, 3 * space.n_p2
    C = correction_csr(lift, ndof)
    print(f"[2] K16 on the tube's biharmonic tables (bc1, beta = 1): "
          f"{K} fluid cells, {space.n_p2} P2 nodes, the correction's CSR "
          f"{C.nnz} nonzeros")
    for dt, kind in ((torch.float64, "f64"), (torch.float32, "f32")):
        x = U.to(dt)
        name = lifting.counter_name(x)
        ck = lifting.correction_cuda(lift, x)
        cp = lifting.correction_plain(lift, x)
        tol = TOL_F64
        if dt == torch.float32:
            c64 = lifting.correction_plain(lift, x.double())
            tol = (2 * float((cp.double() - c64).norm())
                   + 1e-14 * float(c64.norm())) / float(cp.double().norm())
        Cs = torch.sparse_csr_tensor(
            torch.as_tensor(C.indptr, dtype=torch.int64),
            torch.as_tensor(C.indices, dtype=torch.int64),
            torch.as_tensor(C.data, dtype=dt), (ndof, ndof)).to("cuda")
        lib_ms = cuda_ms(lambda: torch.sparse.mm(Cs, x[:, None]), 50)
        lib_rel = rel_err(torch.sparse.mm(Cs, x[:, None])[:, 0], cp)[0]
        print(f"    cuSPARSE SpMV of the correction's {kind} CSR: "
              f"{lib_ms:.4f} ms, rel {lib_rel:.3e} from the plain version")
        del Cs
        work = (nbytes(lift["Ke"], lift["p2dofs"], lift["minv"],
                       lift["wfree"], lift["dmask"])
                + n_d * x.element_size() + nbytes(ck),
                count_ops(lambda: lifting.correction_plain(lift, x)), kind)
        records.add(name, rel_err(ck, cp),
                    cuda_ms(lambda: lifting.correction_cuda(lift, x), 100),
                    cuda_ms(lambda: lifting.correction_plain(lift, x), 20),
                    work, tol, f"K={K} {kind} -> ({ndof},)",
                    library_ms=lib_ms)


def phase_kernels():
    import torch

    system, bc, U, U0 = build_system(FULL_MESH, "cuda", seed=0)
    print(f"[2] system: {system.mesh.num_cells} cells, {system.space.ndof} "
          f"dofs, blocks " + ", ".join(
              f"{b.name}={b.dofs.shape[0]}" for b in system.assembler.blocks))
    records = Records()
    phase_element_kernels(records, system, U, U0)
    phase_lifting_kernels(records, system, U, U0)
    extra = phase_iterative_kernels(records, system, bc)
    del system, U, U0
    torch.cuda.empty_cache()
    phase_facet_kernels(records)
    torch.cuda.empty_cache()
    phase_mr_kernels(records)
    torch.cuda.empty_cache()
    return records, extra


def _run_quiet(overrides, problem="cylinder"):
    from vasp_tpu_torch.run.driver import run_simulation

    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run_simulation(problem, overrides=overrides)
    iters = [json.loads(line)["newton_iterations"] for line in
             (Path(overrides["folder"]) / "metrics.jsonl").read_text()
             .splitlines()]
    return ns, iters, buf.getvalue()


# the path parity runs of phase 3: (problem, its tiny run, label, config
# keys, tolerance on U, the path of PATHS whose launches the card's run
# reports or None): the f64 Robin, MR, elastic and no-lifting kernels and
# the float32 no-lifting ones launch on no other path
PARITY = (
    ("cylinder", TINY, "LU", {}, TOL_PATH_LU, None),
    ("cylinder", TINY, "gmres", dict(linear_solver="gmres"), TOL_PATH_GMRES,
     None),
    ("cylinder", TINY, "f32f", BENCH_CFG, TOL_PATH_F32F, None),
    ("aneurysm", TINY_ANEURYSM, "LU", {}, TOL_PATH_LU, "aneurysm_lu"),
    ("aneurysm", TINY_ANEURYSM, "f32f", BENCH_CFG, TOL_PATH_F32F, None),
    ("predeform", TINY_PREDEFORM, "LU", {}, TOL_PATH_LU, "predeform_lu"),
    ("avf", TINY_AVF, "LU", {}, TOL_PATH_LU, "avf_lu"),
    ("cylinder", TINY_LIFT, "biharmonic LU", BIHARMONIC, TOL_PATH_LU,
     "biharmonic_tiny_lu"),
    ("cylinder", TINY_LIFT, "elastic+p_stab+gravity LU", ELASTIC,
     TOL_PATH_LU, "elastic_lu"),
    (NO_LIFT, TINY_LIFT, "LU", {}, TOL_PATH_LU, "nolift_lu"),
    (NO_LIFT, TINY, "f32f", BENCH_CFG, TOL_PATH_F32F, "nolift_f32f"),
)


def _parity_tag(problem, label):
    return f"{problem}_{label}".replace(" ", "_").replace("+", "_")


def _parity_reference(tmp, problem, tiny, label, extra):
    """One PARITY run on the CPU: (U, Newton iterations per step, ladder
    tiers per step, cells, wall seconds)."""
    run_problem = str(tmp / f"{NO_LIFT}.py") if problem == NO_LIFT \
        else problem
    tic = time.perf_counter()
    ns, iters, _ = _run_quiet(dict(
        tiny, device="cpu", **extra,
        folder=str(tmp / f"tiny_cpu_{_parity_tag(problem, label)}")),
        run_problem)
    tiers = ([h["tiers"] for h in ns["solver"].stepper.history]
             if "linear_solver" in extra else [])
    return (ns["dvp_"]["n"], iters, tiers, ns["mesh"].num_cells,
            time.perf_counter() - tic)


def cpu_reference_jobs(tmp):
    """Phase 3's CPU sides as (key, job), the longest first (by the CPU
    walls that phase 3 prints): per PARITY run its _parity_reference, the
    forced ladder runs, each IterativeStepper run, the Krylov branch's
    pipe solve and make_step_fn's small-tube step."""
    parity = {_parity_tag(problem, label): (
        lambda p=problem, t=tiny, lb=label, e=extra:
        _parity_reference(tmp, p, t, lb, e))
        for problem, tiny, label, extra, _, _ in PARITY}
    jobs = [(key, parity.pop(key)) for key in (
        "cylinder_LU", "avf_LU", "predeform_LU", "cylinder_gmres",
        "cylinder_f32f")]
    jobs.append(("ladder", lambda: forced_ladder("cpu")))
    jobs += list(parity.items())
    jobs.append(("step_fn", lambda: step_fn_run("cpu", LADDER_MESH,
                                                STEP_FN_OPTS)[:2]))
    jobs += [(f"stepper_{i}", lambda spec=spec: stepper_runs(
        "cpu", [spec])[0][:6]) for i, spec in enumerate(STEPPER_RUNS)]
    jobs.append(("pipe", lambda: krylov_pipe_solve("cpu")))
    return jobs


def cpu_references(tmp):
    """The jobs of cpu_reference_jobs that this process claims, in order:
    a job is claimed by creating its claim file under `tmp`, which one
    process only can do; {key: result}."""
    import os

    ref = {}
    for key, job in cpu_reference_jobs(tmp):
        try:
            os.close(os.open(tmp / f"claim_{key}",
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            continue
        ref[key] = job()
    return ref


def start_cpu_references(tmp):
    """Start CPU_REFERENCE_PROCESSES processes of `python3 chip_smoke.py
    --cpu-reference <dir> <result file>` (phase 3's CPU sides, which they
    share out by claiming cpu_reference_jobs' jobs under <dir>); return
    [(process, result file, log file)]."""
    (tmp / f"{NO_LIFT}.py").write_text(NO_LIFT_PROBLEM)
    started = []
    for i in range(CPU_REFERENCE_PROCESSES):
        out = tmp / f"cpu_reference_{i}.pt"
        log = tmp / f"cpu_reference_{i}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--cpu-reference", str(tmp), str(out)],
                stdout=fh, stderr=subprocess.STDOUT)
        started.append((proc, out, log))
    return started


def stop_cpu_references(started):
    """Kill the CPU reference processes that still run."""
    for proc, _, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def wait_cpu_references(started):
    """The CPU references, once their processes have ended (each must end
    with 0): {key: result}, the stepper runs as ref["stepper"]."""
    import torch

    tic = time.perf_counter()
    ref = {}
    for proc, out, log in started:
        rc = proc.wait()
        if rc != 0:
            stop_cpu_references(started)
            require(False, f"the CPU reference runs failed ({rc}):\n"
                           f"{log.read_text()[-4000:]}")
        ref.update(torch.load(out, weights_only=False))
    print(f"[3] waited {time.perf_counter() - tic:.1f} s for the CPU "
          f"reference runs ({len(started)} processes)")
    ref["stepper"] = [ref.pop(f"stepper_{i}")
                      for i in range(len(STEPPER_RUNS))]
    return ref


def phase_parity(tmp, refs):
    """The path parity runs, the forced ladder runs, the IterativeStepper
    runs and the new paths' cases: every card run first, then each against
    its CPU reference (cpu_references, whose processes `refs` run beside
    them); returns the launches of the card runs that name a path
    (counters reset just before each)."""
    from vasp_tpu_torch.kernels import build

    # the no-lifting problem's file: start_cpu_references wrote it
    launches, cards = {}, {}
    for problem, tiny, label, extra, tol, path in PARITY:
        tag = _parity_tag(problem, label)
        run_problem = str(tmp / f"{NO_LIFT}.py") if problem == NO_LIFT \
            else problem
        build.reset_launch_counts()
        tic = time.perf_counter()
        ns_g, it_g, log = _run_quiet(dict(
            tiny, device="cuda", **extra,
            folder=str(tmp / f"tiny_{tag}")), run_problem)
        t_gpu = time.perf_counter() - tic
        if path is not None:
            launches[path] = dict(build.LAUNCHES)
            check_launches(path, launches[path])
            print(f"[3] tiny {problem}, {label} path: launches "
                  f"{launches[path]}")
        if (problem, label) == ("aneurysm", "LU"):
            check_robin_f64_at_path(ns_g)
        tiers = ([h["tiers"] for h in ns_g["solver"].stepper.history]
                 if "linear_solver" in extra else [])
        cards[tag] = (ns_g["dvp_"]["n"].cpu(), it_g, tiers,
                      log.count("Solved for timestep"), t_gpu)
        del ns_g
    build.reset_launch_counts()
    ladder = forced_ladder("cuda")
    launches["ladder"] = dict(build.LAUNCHES)
    steppers = []
    for spec in STEPPER_RUNS:
        build.reset_launch_counts()
        steppers.append(stepper_runs("cuda", [spec])[0][:6])
        launches[spec[0]] = dict(build.LAUNCHES)
    build.reset_launch_counts()
    pipe = krylov_pipe_solve("cuda")
    launches["krylov_pipe"] = dict(build.LAUNCHES)
    build.reset_launch_counts()
    step_fn = step_fn_run("cuda", LADDER_MESH, STEP_FN_OPTS)[:2]
    launches["step_fn_tiny"] = dict(build.LAUNCHES)

    ref = wait_cpu_references(refs)
    for problem, tiny, label, extra, tol, path in PARITY:
        name = f"tiny {problem}, {label} path"
        tag = _parity_tag(problem, label)
        Uc, it_c, tiers_c, cells, t_cpu = ref[tag]
        Ug, it_g, tiers_g, solved, t_gpu = cards[tag]
        rel = float((Ug - Uc).norm() / Uc.norm())
        steps = round(tiny["T"] / tiny["dt"])
        print(f"[3] {name} ({cells} cells, {steps} steps): "
              f"Newton iterations cpu {it_c} cuda {it_g}; ladder tiers cpu "
              f"{tiers_c} cuda {tiers_g}; U rel diff {rel:.3e}; wall cpu "
              f"{t_cpu:.1f} s (its own process), cuda {t_gpu:.1f} s")
        require(it_c == it_g, f"{name}: Newton iteration counts differ "
                              f"between the CPU plain path and the CUDA "
                              f"kernel path")
        require(tiers_c == tiers_g, f"{name}: ladder tiers differ")
        require(rel <= tol, f"{name}: U differs by {rel:.3e} relative "
                            f"(> {tol:.0e})")
        require(solved == steps, f"{name}: tiny run missed steps")
    check_forced_ladder(ref["ladder"], ladder, launches["ladder"])
    check_stepper_parity(ref["stepper"], steppers, launches)
    check_new_paths(ref, pipe, step_fn, launches)
    return launches


def check_robin_f64_at_path(ns):
    """The f64 Robin kernels launch only on the LU path, which is the tiny
    aneurysm's (its own rule, degree 2): hold them against their plain
    versions on that run's facet block and final state, after its launch
    counts were read."""
    import torch

    from vasp_tpu_torch.fem.assembly import FacetBlock
    from vasp_tpu_torch.kernels import facet

    U = ns["dvp_"]["n"]
    for fb in (b for b in ns["assembler"].blocks
               if isinstance(b, FacetBlock)):
        Rp = facet.residual_plain(fb, U, torch.zeros_like(U))
        require(float(Rp.norm()) > 0, "tiny aneurysm: zero Robin residual")
        rel_r, mx_r = rel_err(facet.residual_cuda(fb, U, torch.zeros_like(U)),
                              Rp)
        rel_j, mx_j = _per_block_rel(facet.jacobian_cuda(fb, U.device),
                                     facet.jacobian_plain(fb, U))
        print(f"[3] tiny aneurysm's Robin block (K={fb.dofs.shape[0]}, "
              f"{len(fb.kernel.tables_np[0])}-point rule) at its final "
              f"state: residual rel {rel_r:.3e} max_abs {mx_r:.3e}; "
              f"Jacobian per-block rel {rel_j:.3e} max_abs {mx_j:.3e}")
        require(rel_r <= TOL_F64 and rel_j <= TOL_F64,
                "tiny aneurysm: the f64 Robin kernels disagree with their "
                "plain versions at the path's shapes")


# the forced ladder runs of phase 3: (label, StepOptions, probe flagged,
# the tiers they must take)
LADDER_RUNS = (
    ("escalation", dict(atol=1e-8, rtol=1e-8, max_it=8, gmres_tol=1e-8,
                        gmres_restart=60, gmres_maxiter=60, jac_dtype="f32"),
     True, ["f64_factors"]),
    ("exact", dict(atol=1e-11, rtol=1e-11, max_it=8, gmres_tol=1e-8,
                   gmres_restart=60, gmres_maxiter=60, jac_dtype="f32",
                   krylov_dtype="f32", residual_dtype="f32f"),
     False, ["fine_retry", "exact", "exact_rebuild"]),
)


def forced_ladder(device):
    """The forced ladder runs on `device`: per run (tiers, Newton
    iterations, residual, U on the host)."""
    import numpy as np
    import torch

    from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

    system, bc, load = bench_tube(LADDER_MESH, device, stenosis=False)
    bcv = torch.as_tensor(bc.values_at(1e-3), device=device)
    U0 = system.zero_state()
    out = []
    for label, opts, flag, _ in LADDER_RUNS:
        st = IterativeStepper(system, bc, StepOptions(**opts),
                              recompute_tstep=1000)
        # the first step's factors, damaged; the probe flagged or not
        st._rebuild(torch.where(st.mask, bcv, U0), U0, 1)
        Sinv, H, G = st._pinv
        noise = np.random.default_rng(0).uniform(-1.0, 1.0, tuple(Sinv.shape))
        st._pinv = (Sinv * (1.0 + 5.0 * torch.as_tensor(
            noise, dtype=Sinv.dtype, device=device)), H, G)
        if flag:
            st._last_rel = 1e9
        with redirect_stdout(io.StringIO()):
            U, stats = st.step(U0, bcv, load, 1)
        out.append((st.history[-1]["tiers"], stats["iterations"],
                    stats["residual"], U.cpu()))
    return out


def check_forced_ladder(cpu, cuda, launches):
    """The forced ladder runs on the card (`cuda`, their launches) against
    their CPU references."""
    for (label, opts, _, want), c, g in zip(LADDER_RUNS, cpu, cuda):
        rel = float((g[3] - c[3]).norm() / c[3].norm())
        print(f"[3] forced ladder, {label}: tiers cpu {c[0]} cuda {g[0]}; "
              f"Newton iterations cpu {c[1]} cuda {g[1]}; residual cpu "
              f"{c[2]:.3e} cuda {g[2]:.3e}; U rel diff {rel:.3e}")
        require(c[0] == g[0] == want, f"forced ladder {label}: tiers "
                                      f"{c[0]} / {g[0]}, expected {want}")
        require(c[1] == g[1], f"forced ladder {label}: Newton iteration "
                              f"counts differ")
        require(g[2] <= opts["atol"], f"forced ladder {label}: not "
                                      f"converged")
        require(rel <= TOL_LADDER, f"forced ladder {label}: U differs by "
                                   f"{rel:.3e} relative")
    missing = [k for k in PATHS["ladder"] if launches[k] == 0]
    require(not missing, f"ladder: kernels never launched: {missing}")


def layout_needs(pattern, block_sizes):
    """Peak bytes of each banded layout (fem/banded.py banded_layout) of a
    pattern: the full float32 and bf16 layouts, the hybrid and the bf16
    Sinv-only one."""
    from vasp_tpu_torch.fem import banded as fb

    full32 = fb.banded_layout(pattern, block_sizes, math.inf, None)
    full16 = fb.banded_layout(pattern, block_sizes, math.inf, "bf16")
    return dict(
        full_f32=full32.bytes, full_bf16=full16.bytes,
        hybrid=fb.banded_layout(pattern, block_sizes, full32.bytes - 1,
                                None).bytes,
        sinv_bf16=fb.banded_layout(pattern, block_sizes, full16.bytes - 1,
                                   "bf16").bytes)


@contextmanager
def free_memory_reads(free):
    """fem/banded.py device_free_bytes reads `free` bytes (None: the
    device's own), on the CPU and on the card, inside the block."""
    from vasp_tpu_torch.fem import banded as fb

    real = fb.device_free_bytes
    if free is not None:
        fb.device_free_bytes = lambda device: free
    try:
        yield
    finally:
        fb.device_free_bytes = real


def stepper_runs(device, runs, steps=1):
    """IterativeStepper runs on the small tube (phase 3, 12d) on `device`,
    `steps` ramped steps each: per run (layout or None, preconditioner
    dtypes, Newton iterations per step, tiers per step, U on the host);
    each step must converge."""
    import torch

    from vasp_tpu_torch.fem import banded as fb
    from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

    system, bc, load = bench_tube(LADDER_MESH, device, stenosis=False)
    bcv = torch.as_tensor(bc.values_at(1e-3), device=device)
    sizes = [tuple(b.dofs.shape) for b in system.assembler.blocks]
    pat = fb.build_banded_pattern([b.dofs.cpu().numpy()
                                   for b in system.assembler.blocks],
                                  system.assembler.ndof)
    out = []
    for path, opts, free, _ in runs:
        opt = StepOptions(**opts)
        if free == "full":
            free = fb.banded_layout(pat, sizes, math.inf,
                                    opt.banded_factor_dtype).full_bytes - 1
        with free_memory_reads(free), redirect_stdout(io.StringIO()):
            st = IterativeStepper(system, bc, opt)
            U, newton = system.zero_state(), []
            for k in range(1, steps + 1):
                U, stats = st.step(U, bcv, (0.5 + 0.5 * k) * load, k)
                newton.append(stats["iterations"])
                require(stats["residual"] <= opt.atol
                        or stats["residual"] <= opt.rtol * stats["r0"],
                        f"{path} on {device}: step {k} did not converge "
                        f"({stats['residual']:.3e})")
        out.append((None if st.layout is None else st.layout.layout,
                    [F.dtype for F in st._pinv], newton,
                    [h["tiers"] for h in st.history], U.cpu(),
                    [h["gmres_inner"] for h in st.history], st))
    return out


def check_stepper_parity(cpu, cards, launches):
    """Phase 3's IterativeStepper runs on the small tube (`cards`, one per
    STEPPER_RUNS entry) against their CPU references: the hybrid, bf16 and
    f32 Sinv-only layouts (device_free_bytes reading one byte short of
    the full layout's peak on both), the full one in bf16, and RAS with
    float64 inverses; the same layout and storage, Newton counts and
    tiers, U within TOL_PATH_GMRES. The launches (counters reset just
    before each card run and read just after) cover the paths of K6's
    storage instances, K12 and K18's float64 instance."""
    for run, card, spec in zip(cpu, cards, STEPPER_RUNS):
        path, opts, free, want = spec
        rel = float((card[4] - run[4]).norm() / run[4].norm())
        print(f"[3] {path} ({opts}) on the {LADDER_MESH['n_z']}-layer tube: "
              f"layout {run[0]}, storage cpu {[str(d)[6:] for d in run[1]]} "
              f"cuda {[str(d)[6:] for d in card[1]]}; Newton cpu {run[2]} "
              f"cuda {card[2]}; GMRES inner cpu {run[5]} cuda {card[5]}; "
              f"tiers cpu {run[3]} cuda {card[3]}; U rel diff {rel:.3e}")
        require(run[0] == card[0] == want, f"{path}: layout {run[0]} / "
                                           f"{card[0]}, expected {want}")
        require(run[1] == card[1] and run[2] == card[2]
                and run[3] == card[3], f"{path}: storage, Newton counts or "
                                       f"tiers differ")
        require(rel <= TOL_PATH_GMRES, f"{path}: U differs by {rel:.3e}")
        check_launches(path, launches[path])


def run_main_path(tmp, label, mesh_params, problem="cylinder", T=0.005,
                  dt=0.001, floor=None, **cfg):
    """driver.main on -p `problem` (a model's name or a problem file) for
    T/dt steps (5 unless given), the launch counters reset just before
    and read just after. Every step must converge, or, with `floor`
    given, end with its residual at most `floor`."""
    import torch

    from vasp_tpu_torch.kernels import build
    from vasp_tpu_torch.run import driver

    cfg_path = tmp / f"{label}_config.json"
    cfg_path.write_text(json.dumps(dict(
        mesh_path=None, generated_mesh_params=mesh_params, **RUN_KEYS,
        **cfg)))
    folder = tmp / f"main_{label}"
    n_steps = round(T / dt)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    tic = time.perf_counter()
    ns = driver.main(["-p", problem, "-T", repr(T), "-dt", repr(dt),
                      "--folder", str(folder), "--config", str(cfg_path)],
                     return_namespace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(build.LAUNCHES)
    steps = [json.loads(line) for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    U = ns["dvp_"]["n"]
    require(U.is_cuda, f"{label}: the main path's state is not on the card")
    require(len(steps) == n_steps,
            f"{label}: {len(steps)} steps instead of {n_steps}")
    if floor is None:
        require(all(s["converged"] for s in steps),
                f"{label}: a step did not converge")
    else:
        res = ", ".join(f"{s['residual']:.3e}" for s in steps)
        print(f"    steps converged {[s['converged'] for s in steps]}, "
              f"residuals {res}")
        require(all(s["converged"] or s["residual"] <= floor for s in steps),
                f"{label}: a step ended above {floor:.0e} unconverged")
    require(bool(torch.isfinite(U).all()), f"{label}: U is not finite")
    check_launches(label, launches)
    secs = [s["cpu_time"] for s in steps]
    print(f"    {ns['mesh'].num_cells} cells, {ns['space'].ndof} dofs, "
          f"{n_steps} steps in {wall:.2f} s")
    print_steps(secs, [s["newton_iterations"] for s in steps])
    print(f"    launches {launches}")
    print(f"    peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return ns, launches


def check_launches(label, launches):
    missing = sorted(k for k in PATHS[label] if launches[k] == 0)
    require(not missing, f"{label}: kernels never launched on the path: "
                         f"{missing}")


def print_steps(secs, newton):
    mean = (f"; steps 2-{len(secs)} mean "
            f"{sum(secs[1:]) / (len(secs) - 1):.3f} s" if len(secs) > 1
            else "")
    print(f"    s/step {', '.join(f'{x:.3f}' for x in secs)}{mean}")
    print(f"    Newton iterations {newton}")


def phase_lu(tmp):
    """Phase 4; returns the launches and the host splu seconds."""
    print("[4] cylinder, LU path:")
    ns, launches = run_main_path(tmp, "lu", LU_MESH)
    timings = dict(ns["solver"].timings)
    print(f"    factorizations {ns['solver'].factorizations}; solver time "
          f"split (s): " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in sorted(timings.items())))
    return launches, timings["splu"]


def phase_lifting(tmp, records, lu_splu_s):
    """Phase 11: biharmonic lifting on the Krylov path (11a, -p aneurysm
    at 20,832 cells, bc2, beta = 1e-2, bench configuration) and on the LU
    path (11b, -p cylinder at 2,520 cells, bc1, beta = 1), elastic lifting
    on the bench configuration (11c, -p cylinder at 20,832 cells); each
    with the checks and lines of phase 5 (every step converged; a profiled
    step on the Krylov path)."""
    import gc

    import torch

    out = {}
    print("[11a] aneurysm, biharmonic lifting (bc2, biharmonic_beta=1e-2), "
          "bench configuration, 20,832 cells, 5 steps of dt=1e-3:")
    ns, out["biharmonic_krylov"] = run_main_path(
        tmp, "biharmonic_krylov", MODEL_MESH, problem="aneurysm",
        **BENCH_CFG, **BIHARMONIC_KRYLOV)
    out["k5_biharmonic_krylov"] = report_stepper(ns["solver"].stepper,
                                                 records)
    report_model_lines(ns, "aneurysm", 5)
    profile_one_step(ns)
    del ns
    gc.collect()
    torch.cuda.empty_cache()
    print("[11b] cylinder, biharmonic lifting (bc1, beta = 1), LU path, "
          "2,520 cells, 3 steps of dt=1e-3:")
    ns, out["biharmonic_lu"] = run_main_path(
        tmp, "biharmonic_lu", LU_MESH, T=0.003, **BIHARMONIC)
    solver = ns["solver"]
    timings = dict(solver.timings)
    print(f"    factorizations {solver.factorizations}; solver time split "
          f"(s): " + ", ".join(f"{k} {v:.3f}"
                               for k, v in sorted(timings.items())))
    A = solver.state.A_s
    print(f"    host splu {timings['splu']:.3f} s against phase 4's "
          f"{lu_splu_s:.3f} s (Laplace lifting); the factorized matrix has "
          f"{A.nnz} nonzeros, its biharmonic correction "
          f"{solver._lift_csr.nnz}")
    del ns, solver, A
    gc.collect()
    torch.cuda.empty_cache()
    print("[11c] cylinder, elastic lifting, bench configuration, 20,832 "
          "cells, 5 steps of dt=1e-3:")
    ns, out["elastic"] = run_main_path(
        tmp, "elastic", FULL_MESH, extrapolation="elastic", **BENCH_CFG)
    out["k5_elastic"] = report_stepper(ns["solver"].stepper, records)
    profile_one_step(ns)
    return out


def report_stepper(st, records):
    """The Krylov path's lines: GMRES counts, ladder tiers, the probe, the
    host setup, the time splits and GMRES's bound per direction (K5)."""
    hist = st.history
    print(f"    GMRES inner iterations per step "
          f"{[h['gmres_inner'] for h in hist]}, restart cycles "
          f"{[h['gmres_cycles'] for h in hist]}; rebuilds per step "
          f"{[h['rebuilds'] for h in hist]}; ladder tiers "
          f"{[h['tiers'] for h in hist]}; probe rel {st._last_rel:.3e}; "
          f"c={st._bpat.c} nb={st._bpat.nb}")
    print("    one-time host setup (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in st.setup.items()))
    t = st.timings
    rebuild = ("rebuild_jacobians", "ruiz", "assemble", "factorize", "hg",
               "probe")
    per_it = ("jacobians", "residual", "gmres", "matvec", "precond")
    print("    rebuild split (s): " + ", ".join(
        f"{k} {t[k]:.3f}" for k in rebuild))
    print("    per-iteration split, summed over the run (s): " + ", ".join(
        f"{k} {t[k]:.3f}" for k in per_it))
    # K5 per direction: 1 + 2 cycles + inner matvecs and cycles + inner
    # applies at the K4 and K6 bounds, plus the CGS2 projections (four
    # passes over V[:j+1] at inner step j, one over V[:j] per cycle's
    # update) with the inner steps spread evenly over the cycles
    dirs = sum(h["iterations"] for h in hist)
    inner = sum(h["gmres_inner"] for h in hist)
    cycles = sum(h["gmres_cycles"] for h in hist)
    es = 4 if st.opt.krylov_dtype == "f32" else 8
    q, extra = divmod(inner, max(cycles, 1))
    js = [q + 1] * extra + [q] * (max(cycles, 1) - extra)
    gemv = sum(4 * m * (m + 1) // 2 + m for m in js) * st.ndof * es
    k5 = ((dirs + 2 * cycles + inner) * records["elem_matvec"]["bound_ms"]
          + (inner + cycles) * records["banded_apply"]["bound_ms"]
          + gemv / HBM_BYTES_PER_S * 1e3) / max(dirs, 1)
    print(f"    GMRES (K5) per direction: {t['gmres'] / max(dirs, 1) * 1e3:.2f}"
          f" ms against a bound of {k5:.2f} ms ({dirs} directions, "
          f"{inner} inner iterations, {cycles} cycles)")
    return k5


def phase_krylov(tmp, records, label, title, **cfg):
    """driver.main on the Krylov path at the 20,832-cell tube (phases 5
    and 6) through CYLINDER_PROBLEM: the main-path checks, the stepper's
    lines, a profiled step. Returns the launches, GMRES's bound per
    direction, the layout needs and GMRES inner iterations, and the
    states the problem file kept with each step's Newton iterations."""
    print(title)
    path = tmp / f"{label}_problem.py"
    path.write_text(CYLINDER_PROBLEM.format())
    ns, launches = run_main_path(tmp, label, FULL_MESH, problem=str(path),
                                 **cfg)
    st = ns["solver"].stepper
    k5 = report_stepper(st, records)
    profile_one_step(ns)
    newton = [json.loads(line)["newton_iterations"] for line in
              (Path(ns["folder"]) / "metrics.jsonl").read_text()
              .splitlines()]
    return launches, k5, dict(layout_needs(st._bpat, st._block_sizes),
                              gmres_inner=[h["gmres_inner"]
                                           for h in st.history]), \
        [(U.cpu(), it) for (_, U), it in zip(ns["series"], newton)]


def phase_bench(records, label="bench", title=None, free=None, **opts):
    """bench.py's measure() on the port: the stenosed tube, 6 ramp steps
    and 3 more through IterativeStepper.step with bench.py's options
    (updated by `opts`), counters reset just before and read just after;
    with `free`, a ballast allocation made after the system is built
    leaves that many bytes free when the stepper reads them. Returns the
    launches, GMRES's bound per direction and the stepper's layout needs
    and GMRES inner iterations."""
    import torch

    from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions
    from vasp_tpu_torch.kernels import build

    print(title or "[7] bench tube (bench.py: stenosed 20,832-cell tube, "
          "quadrature degree 3, 150x interface load ramped over 6 steps), "
          "IterativeStepper with bench.py's options:")
    system, bc, load = bench_tube(FULL_MESH, "cuda")
    bcv = torch.as_tensor(bc.values_at(1e-3), device="cuda")
    held = None if free is None else ballast(free, label)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    tic = time.perf_counter()
    st = IterativeStepper(system, bc, StepOptions(**dict(BENCH_STEP, **opts)),
                          recompute_tstep=20)
    U = system.zero_state()
    secs, newton = [], []
    for k in range(1, 10):
        t0 = time.perf_counter()
        U, stats = st.step(U, bcv, min(1.0, k / 6) * load, k)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        newton.append(stats["iterations"])
        require(stats["residual"] <= BENCH_STEP["atol"] or stats["residual"]
                <= BENCH_STEP["rtol"] * stats["r0"],
                f"{label}: step {k} did not converge "
                f"({stats['residual']:.3e})")
    wall = time.perf_counter() - tic
    launches = dict(build.LAUNCHES)
    require(bool(torch.isfinite(U).all()), f"{label}: U is not finite")
    check_launches(label, launches)
    print(f"    {system.mesh.num_cells} cells, {system.space.ndof} dofs, 9 "
          f"steps in {wall:.2f} s (stepper setup included)")
    print_steps(secs, newton)
    print(f"    launches {launches}")
    report_peak(held)
    k5 = report_stepper(st, records)
    return launches, k5, dict(layout_needs(st._bpat, st._block_sizes),
                              gmres_inner=[h["gmres_inner"]
                                           for h in st.history],
                              layout=st.layout.layout)


def ballast(free, label):
    """A device allocation that leaves `free` bytes of the card free (the
    caching allocator's idle blocks released first)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    now = torch.cuda.mem_get_info()[0]
    require(now > free, f"{label}: {now / 2**30:.2f} GiB free, below the "
                        f"budget of {free / 2**30:.2f} GiB")
    held = torch.empty(now - free, dtype=torch.uint8, device="cuda")
    print(f"    ballast {held.numel() / 2**30:.2f} GiB held: "
          f"{free / 2**30:.2f} GiB of {now / 2**30:.2f} GiB left free")
    return held


def report_peak(held):
    """Peak device memory of the run, the ballast apart."""
    import torch

    peak = torch.cuda.max_memory_allocated()
    extra = 0 if held is None else held.numel()
    print(f"    peak device memory {(peak - extra) / 2**30:.2f} GiB"
          + ("" if held is None else
             f" beside the ballast ({peak / 2**30:.2f} GiB with it)"))


def phase_lowmem(tmp, records, needs6, needs7):
    """Phase 12: the low-memory banded layouts and RAS at full width; per
    run its launches, GMRES's bound per direction and (12a-c) the layout
    and bytes."""
    import gc

    import torch

    out = {}
    gib = 2 ** 30

    def needs(n, a, b):
        return f"{a} {n[a] / gib:.2f} GiB, {b} {n[b] / gib:.2f} GiB"

    print("[12a] cylinder, bench configuration, 20,832 cells, 5 steps, the "
          "card's free memory between the hybrid layout's need and the "
          "full one's (" + needs(needs6, "full_f32", "hybrid") + "):")
    held = ballast((needs6["full_f32"] + needs6["hybrid"]) // 2, "12a")
    ns, out["hybrid"] = run_main_path(tmp, "hybrid", FULL_MESH, **BENCH_CFG)
    st = ns["solver"].stepper
    report_peak(held)
    del held
    require(st.layout.layout == "hybrid", f"12a: the {st.layout.layout} "
                                          f"layout, expected the hybrid")
    out["k5_hybrid"] = report_stepper(st, records)
    print(f"    GMRES inner iterations per step "
          f"{[h['gmres_inner'] for h in st.history]}, phase 6's (full "
          f"float32 layout) {needs6['gmres_inner']}")
    del ns, st
    gc.collect()
    torch.cuda.empty_cache()
    for label, tag, free in (
            ("sinv_bf16", "[12b] bench tube, banded_factor_dtype=\"bf16\", "
             "the card's free memory between the bf16 Sinv-only layout's "
             "need and the full bf16 one's (" + needs(
                 needs7, "full_bf16", "sinv_bf16") + "):",
             (needs7["full_bf16"] + needs7["sinv_bf16"]) // 2),
            ("full_bf16", "[12c] bench tube, banded_factor_dtype=\"bf16\", "
             "no ballast (full layout, bf16 factors, probed):", None)):
        launches, k5, info = phase_bench(records, label, tag, free,
                                         banded_factor_dtype="bf16")
        require(info["layout"] == {"sinv_bf16": "bf16",
                                   "full_bf16": "full"}[label],
                f"{label}: the {info['layout']} layout")
        print(f"    GMRES inner iterations per step {info['gmres_inner']}, "
              f"phase 7's (full float32 layout) {needs7['gmres_inner']}")
        out[label], out[f"k5_{label}"] = launches, k5
        gc.collect()
        torch.cuda.empty_cache()
    print("[12d] precond=\"ras\" at vasp_tpu's defaults (jac_dtype f32, "
          "gmres_tol 1e-6, gmres_maxiter 300, ~1,500 dofs a subdomain, "
          "overlap 2), the 20,832-cell cylinder's subdomain pattern:")
    ras_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[12d] precond=\"ras\" at vasp_tpu's defaults on the "
          f"{LADDER_MESH['n_z']}-layer small tube, the largest generated tube "
          f"on which it converges (from 11,489 dofs on GMRES spends its 300 "
          f"iterations and Newton stalls, in the port and in vasp_tpu: "
          f"tests/diag_ras_cylinder.py), 2 steps:")
    from vasp_tpu_torch.kernels import build

    build.reset_launch_counts()
    tic = time.perf_counter()
    ((_, _, newton, tiers, _, inner, st),) = stepper_runs(
        "cuda", [RAS_SMALL], steps=2)
    out["ras_small"] = dict(build.LAUNCHES)
    check_launches("ras_small", out["ras_small"])
    print(f"    converged; Newton iterations {newton}, GMRES inner "
          f"{inner}, tiers {tiers}, {time.perf_counter() - tic:.2f} s")
    (pinv,) = st._pinv
    print("    K18 at this run's pattern and float32 inverses (in float64 "
          "widened from them), the shapes its apply took:")
    ras_kernel_records(records, st._ras_pattern, st.ndof, pinv)
    return out


def ras_full_width():
    """The RAS rebuild's host pattern at the 20,832-cell cylinder: float64
    Jacobians and Ruiz scales on the card (K3, K7 f64), the scaled CSR on
    the host, then build_pattern at vasp_tpu's first try (its subdomain
    count, overlap 2) and at overlap 1, each against build_pattern_auto's
    budget (m <= 2,048, S m^2 <= 6e8); its retries run on to 12 (ending,
    at this size, far over the budget: PERF.md). Then, as an extra
    measurement outside the kernels line (no RAS run reaches this shape),
    K18 against its plain version on the overlap-1 pattern with seeded
    inverses."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from vasp_tpu_torch.fem import ras as fr
    from vasp_tpu_torch.fem.scaling import ruiz_scales
    from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

    system, bc, _, _ = build_system(FULL_MESH, "cuda", seed=0)
    asm, ndof = system.assembler, system.space.ndof
    tic = time.perf_counter()
    Z = system.zero_state()
    jacs = asm.element_jacobians(bc.apply(Z, 1e-3), Z)
    dr, dc = ruiz_scales(asm.blocks, jacs, bc.mask_on("cuda"), ndof,
                         sweeps=4)
    A = asm.to_csr(jacs, bc_mask=bc.mask)
    del jacs
    A_s = (sp.diags(dr.cpu().numpy()) @ A @ sp.diags(dc.cpu().numpy()))
    adj = (abs(A_s) + abs(A_s.T)).tocsr()
    del A, A_s
    st = IterativeStepper(system, bc, StepOptions(precond="ras"))
    coords = st._dof_coords()
    print(f"    {ndof} dofs; float64 Jacobians, Ruiz and the scaled CSR "
          f"({adj.nnz} nonzeros in |A| + |A^T|) {time.perf_counter() - tic:.1f}"
          f" s")
    for ov in (2, 1):
        tic = time.perf_counter()
        pat = fr.build_pattern(adj, ndof, st._n_sub, overlap=ov,
                               coords=coords)
        S, m = pat.idx.shape
        print(f"    build_pattern(n_subdomains={st._n_sub}, overlap={ov}): "
              f"S={S}, m={m}, S m^2 = {S * m * m:.3e} (budget 6e8, m <= "
              f"2,048): the dense float64 blocks would take "
              f"{S * m * m * 8 / 2**30:.1f} GiB; host "
              f"{time.perf_counter() - tic:.1f} s")
    del adj
    print("    extra (not in the kernels line): K18 at the overlap-1 pattern "
          "on seeded inverses")
    ras_kernel_records(Records(), pat, ndof)


def ras_kernel_records(records, pat, ndof, pinv=None):
    """K18 against its plain version at the RAS pattern `pat` (every dof
    owned once) on a seeded r, on the float32 inverses `pinv` (seeded ones
    where None) and on them in float64: float64 1e-12, float32 1e-5
    relative (m-term float32 sums in another order). The bound reads the
    owned rows of the inverses once; the yardstick is torch.bmm of the
    inverses by the gathered (S, m, 1) vector."""
    import numpy as np
    import torch

    from vasp_tpu_torch.kernels import ras as kr

    S, m = pat.idx.shape
    idx = torch.as_tensor(pat.idx, device="cuda")
    own = torch.as_tensor(pat.own, device="cuda")
    n_own = int(pat.own.sum())
    gen = torch.Generator(device="cuda").manual_seed(12)
    r = torch.as_tensor(np.random.default_rng(12).normal(size=ndof),
                        device="cuda")
    for name, dt, tol in (("ras_apply_f32", torch.float32, 1e-5),
                          ("ras_apply", torch.float64, TOL_F64)):
        P = (torch.randn((S, m, m), generator=gen, dtype=dt, device="cuda")
             if pinv is None else pinv.to(dt))
        rl = torch.cat([r, r.new_zeros(1)])[idx].to(dt)[..., None]
        records.add(
            name, rel_err(kr.apply_cuda(P, idx, own, r),
                          kr.apply_plain(P, idx, own, r)),
            cuda_ms(lambda: kr.apply_cuda(P, idx, own, r), 20),
            cuda_ms(lambda: kr.apply_plain(P, idx, own, r), 3),
            (n_own * m * P.element_size() + nbytes(idx, own, r) + 8 * ndof,
             2 * n_own * m, "f64" if dt == torch.float64 else "f32"), tol,
            f"S={S} m={m} {str(dt)[6:]}, r f64",
            library_ms=cuda_ms(lambda: torch.bmm(P, rl), 10))
        del P, rl
        torch.cuda.empty_cache()


def phase_models(tmp, records):
    """Phase 8: driver.main on -p offset_stenosis and -p aneurysm at the
    20,832-cell tubes on the bench configuration; per model its launches
    and GMRES's bound per direction."""
    import gc

    import torch

    out = {}
    stenosis_file = tmp / "stenosis_series.py"
    stenosis_file.write_text(STENOSIS_PROBLEM.format())
    for label, problem, extra in (
            ("stenosis", "offset_stenosis",
             dict(fsi_region=[0.0, 0.0, 0.012, 0.01])),
            ("aneurysm", "aneurysm", {})):
        print(f"[8] {problem}, bench configuration, 20,832 cells:")
        ns, launches = run_main_path(
            tmp, label, MODEL_MESH, problem=str(stenosis_file)
            if label == "stenosis" else problem, **BENCH_CFG, **extra)
        k5 = report_stepper(ns["solver"].stepper, records)
        report_model_lines(ns, problem, 5)
        profile_one_step(ns)
        out[label] = (launches, k5)
        if label == "stenosis":
            out["series_stenosis"] = kept_series(ns)
        del ns
        gc.collect()
        torch.cuda.empty_cache()
    return out


def kept_series(ns):
    """What phase 10 postprocesses of a run: its mesh, space, flat config
    and the (t, U) per step its problem file's post_solve kept."""
    require(len(ns["series"]) == ns["counter"],
            "the problem file kept no state of a step")
    keep = ("mesh", "space", "series", "dt", "mu_f", "dx_f_id", "dx_s_id",
            "solid_properties", "material_model", "mu_s", "lambda_s", "C01",
            "C10", "C11", "rho_s")
    return {k: ns[k] for k in keep if k in ns}


def report_model_lines(ns, problem, steps):
    """Every step's minimum Jacobian positive; the last step's probe and
    minimum-Jacobian lines printed."""
    import re

    log = (Path(ns["folder"]) / "run.log").read_text()
    jmins = [float(x) for x in re.findall(r"Minimum Jacobian: (.*)", log)]
    require(len(jmins) == steps and min(jmins) > 0.0,
            f"{problem}: minimum Jacobians {jmins}")
    last = log[log.rindex("Newton iteration"):].splitlines()
    for line in last:
        if line.startswith(("Probe Point", "Minimum Jacobian")):
            print(f"    last step: {line}")


# the post_solve of a problem file that keeps each step's state on the card
# (the series phase 10 postprocesses in memory: no second run, no h5py)
SERIES_HOOK = '''

def post_solve(dvp_, t, **namespace):
    """The model's post_solve, then the step's (t, U) kept on the card."""
    _post_solve(dvp_=dvp_, t=t, **namespace)
    return {{"series": namespace.get("series", []) + [(t, dvp_["n"].clone())]}}
'''
# a problem file: -p cylinder, its series kept (phases 5 and 6; phase 15b
# holds its 2-rank run to phase 5's states)
CYLINDER_PROBLEM = '''"""-p cylinder, its per-step state kept (chip_smoke.py phases 5 and 6)."""
from vasp_tpu_torch.models.cylinder import (  # noqa: F401
    create_bcs, get_mesh_domain_and_boundaries, pre_solve,
    set_problem_parameters)
from vasp_tpu_torch.models.cylinder import post_solve as _post_solve
''' + SERIES_HOOK
# a problem file: -p offset_stenosis, its series kept (phases 8 and 10)
STENOSIS_PROBLEM = '''"""-p offset_stenosis, its per-step state kept (chip_smoke.py phase 8)."""
from vasp_tpu_torch.models.offset_stenosis import (  # noqa: F401
    create_bcs, get_mesh_domain_and_boundaries, initiate, pre_solve,
    set_problem_parameters)
from vasp_tpu_torch.models.offset_stenosis import post_solve as _post_solve
''' + SERIES_HOOK
# a problem file: -p predeform's hooks on a mesh saved with numpy (the card's
# machine has no h5py), restricted to the FSI sphere as predeform's own
# hook restricts a mesh file; its series kept (phase 10's Mooney-Rivlin wall)
CHAIN_PROBLEM = '''"""-p predeform on the predeformed mesh {npz} (chip_smoke.py phase 9)."""
import numpy as np

from vasp_tpu_torch.mesh.markers import restrict_fsi_to_sphere
from vasp_tpu_torch.mesh.tetmesh import TetMesh
from vasp_tpu_torch.models.predeform import (  # noqa: F401
    create_bcs, pre_solve, set_problem_parameters)
from vasp_tpu_torch.models.predeform import post_solve as _post_solve


def get_mesh_domain_and_boundaries(fsi_region, fsi_id, rigid_id,
                                   outer_wall_id, **namespace):
    m = np.load({npz!r})
    mesh = TetMesh(m["coords"], m["cells"], m["cell_markers"], m["facets"],
                   m["facet_markers"])
    return restrict_fsi_to_sphere(mesh, fsi_id, outer_wall_id, rigid_id,
                                  fsi_region)
''' + SERIES_HOOK


def _wall_radial(ns):
    """(mean outward radial displacement of the FSI interface's P2 nodes,
    |d|) of a predeform run's final state, on the host."""
    import numpy as np

    space = ns["space"]
    d = space.split(ns["dvp_"]["n"])[0].cpu().numpy()
    iface = space.p2_dofs_on_facets(22)
    xy = space.p2_coords[iface][:, :2]
    rhat = xy / np.linalg.norm(xy, axis=1, keepdims=True)
    return (float(np.einsum("ki,ki->k", d[iface][:, :2], rhat).mean()),
            float(np.linalg.norm(d)))


def phase_predeform(tmp, records):
    """Phase 9, the prestress chain: -p predeform at 20,832 cells on the
    bench configuration (PREDEFORM_CFG), 5 steps of dt=0.01; then the
    predeformed mesh in memory (the vertex coordinates minus the last
    displacement, as postprocessing/mesh_stages.predeform_mesh writes it)
    and 5 re-inflation steps on it through the driver (a problem file).
    Every step converges or ends below PREDEFORM_FLOOR, U is finite, the
    minimum Jacobian is positive, and the re-inflated wall moves outward
    with |d'|/|d| in 0.3-3 (tests/test_driver_predeform.py's bar). No
    profiled step: a step of this path is seconds of ladder retries,
    more device events than the profiler keeps."""
    import numpy as np

    from vasp_tpu_torch.run.metrics import compute_minimum_jacobian

    out = {}
    print("[9] predeform, bench configuration (max_it=50; ramps t_end_v="
          "0.02, t_start_p=0.02, t_end_p=0.72), 20,832 cells, 5 steps of "
          "dt=0.01:")
    ns, out["predeform"] = run_main_path(
        tmp, "predeform", MODEL_MESH, problem="predeform", T=0.05, dt=0.01,
        floor=PREDEFORM_FLOOR, **PREDEFORM_CFG)
    out["k5_predeform"] = report_stepper(ns["solver"].stepper, records)
    log = (Path(ns["folder"]) / "run.log").read_text()
    pressure = [ln for ln in log.splitlines() if ln.startswith("P = ")]
    print(f"    last step: {pressure[-1]}")
    mesh, space = ns["mesh"], ns["space"]
    d = space.split(ns["dvp_"]["n"])[0]
    jmin = compute_minimum_jacobian(space, d, verbose=False)
    out_r, d_norm = _wall_radial(ns)
    print(f"    minimum Jacobian {jmin}; wall radial displacement mean "
          f"{out_r:.3e} m, |d| {d_norm:.3e}")
    require(jmin > 0.0, f"predeform: minimum Jacobian {jmin}")
    require(out_r > 0.0, "predeform: the wall did not move outward")

    coords = mesh.coords - d[:mesh.num_vertices].cpu().numpy()
    npz = tmp / "predeformed_mesh.npz"
    np.savez(npz, coords=coords, cells=mesh.cells,
             cell_markers=mesh.cell_markers, facets=mesh.facets,
             facet_markers=mesh.facet_markers)
    problem = tmp / "predeform_chain.py"
    problem.write_text(CHAIN_PROBLEM.format(npz=str(npz)))
    del ns, d
    print("[9] the chain: 5 re-inflation steps on the predeformed mesh "
          "(the same options):")
    ns2, out["chain"] = run_main_path(
        tmp, "chain", MODEL_MESH, problem=str(problem), T=0.05, dt=0.01,
        floor=PREDEFORM_FLOOR, **PREDEFORM_CFG)
    out["k5_chain"] = report_stepper(ns2["solver"].stepper, records)
    out["series_chain"] = kept_series(ns2)
    require(np.array_equal(ns2["mesh"].coords, coords),
            "chain: the run did not take the predeformed mesh")
    jmin = compute_minimum_jacobian(
        ns2["space"], ns2["space"].split(ns2["dvp_"]["n"])[0], verbose=False)
    out_r2, d2_norm = _wall_radial(ns2)
    ratio = d2_norm / d_norm
    print(f"    minimum Jacobian {jmin}; wall radial displacement mean "
          f"{out_r2:.3e} m, |d'| {d2_norm:.3e}, |d'|/|d| {ratio:.3f}")
    require(jmin > 0.0, f"chain: minimum Jacobian {jmin}")
    require(out_r2 > 0.0, "chain: the wall did not move outward")
    require(0.3 < ratio < 3.0, f"chain: |d'|/|d| = {ratio:.3f}")
    return out


def phase_avf(tmp, records):
    """Phase 9, -p avf on its generated Y mesh at 22,656 cells (17,664 if
    the card's memory check refuses the banded preconditioner) on the
    bench configuration, 5 steps of dt=1e-4: the lines of phase 5, every
    step's minimum Jacobian positive, the last step's probe and minimum
    Jacobian."""
    out = {}
    for mesh_params in (AVF_MESH, AVF_MESH_SMALL):
        print(f"[9] avf, bench configuration (vel_t_ramp=1e-3, "
              f"p_t_ramp 2e-4-1.2e-3), Y mesh {mesh_params}, 5 steps of "
              f"dt=1e-4:")
        try:
            ns, out["avf"] = run_main_path(tmp, "avf", mesh_params,
                                           problem="avf", T=5e-4, dt=1e-4,
                                           **AVF_CFG)
            break
        except NotImplementedError as e:
            require(mesh_params is AVF_MESH and "device memory" in str(e),
                    f"avf: {e}")
            print(f"    refused: {e}; taking the 17,664-cell mesh")
    out["k5_avf"] = report_stepper(ns["solver"].stepper, records)
    report_model_lines(ns, "avf", 5)
    profile_one_step(ns)
    return out


def profile_one_step(ns):
    """A sixth step under torch.profiler (after the measured run, so its
    overhead touches none of the numbers above)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dt = float(ns["dt"])
    t = ns["t"] + dt
    U = ns["dvp_"]["n"]
    load = ns["load_fn"](t)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with redirect_stdout(io.StringIO()):
            ns["solver"].solve(U, U, t=t, tstep=ns["counter"] + 1,
                               load=load)
        torch.cuda.synchronize()
    wall = time.perf_counter() - tic

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own entries (kernels, copies, fills): the host ops that
    # launched them carry the same time again
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA), key=device_us,
                reverse=True)
    busy = sum(device_us(e) for e in ev) * 1e-6
    if busy <= 0.0:
        print("    profiled step: the profiler recorded no device time "
              "(busy share not measured)")
        return
    print(f"    profiled step: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f} "
          f"%)")
    for e in ev[:5]:
        print(f"      {device_us(e) * 1e-3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


# phase 10: the K20 kernels at the shapes of a production postprocessing
# pass: a 951-step series (-p offset_stenosis: T = 0.951 s at dt = 1e-3,
# save_step = 1) at the 20,832-cell tubes, and a spectrogram of 10,000
# sampled nodes (the spectral CLIs' --n-samples default) at
# num_windows_per_sec = 4, the CLIs' default (n_window = round(4 T) + 3)
POST_STEPS = 951
POST_NODES = 10000
POST_WINDOWS_PER_SEC = 4.0
POST_LOWCUT = 25.0  # the CLIs' --lowcut default
# K20 tolerances against the plain versions and against the CPU path:
# float64 with atomics in another order (1e-12 of the output's scale); the
# Cardano eigenvalues 1e-10 of theirs (acos near r = +-1 turns a rounding
# change of r into ~1e-8 of p), and so OSI, RRT and ECAP (the mean WSS
# vector cancels over a reversing series; RRT is its inverse)
TOL_POST = 1e-12
TOL_EIG = 1e-10
EIGVALSH_BATCH = 16384  # the largest power of 2 cuSOLVER's batched syev takes


def _scale_err(a, b):
    """(max |a - b| over the scale max |b|, max |a - b|)."""
    import torch

    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    mx = float((a - b).abs().max())
    return mx / max(float(b.abs().max()), 1e-300), mx


def _post_inputs(run, device):
    """(times, v, d (T, n_p2, 3) float64 on `device`) of a kept run."""
    import torch

    n2 = run["space"].n_p2
    U = torch.stack([u for _, u in run["series"]]).to(device)
    T = U.shape[0]
    return ([t for t, _ in run["series"]],
            U[:, 3 * n2:6 * n2].reshape(T, n2, 3).contiguous(),
            U[:, :3 * n2].reshape(T, n2, 3).contiguous())


def _postproc_pass(run, device):
    """The in-memory postprocessing of a kept run on `device`, through the
    port's own functions: the hemodynamic indices and the WSS series
    (fields/hemodynamics.py), the stress/strain fields with their largest
    eigenvalues (fields/stress_strain.py), the band-pass amplitudes of the
    strain (spectral/hi_pass_viz.strain_amplitudes), and the PSD and the
    spectrogram of |v| at up to POST_NODES fluid nodes (spectral/core.py;
    n_window = 2, the least that gives frames on a 5-step series)."""
    import numpy as np

    from vasp_tpu_torch.postprocessing.fields.hemodynamics import (
        FluidBoundaryTables, hemodynamic_indices)
    from vasp_tpu_torch.postprocessing.fields.stress_strain import (
        SolidVertexTables, _normalize_solid_props)
    from vasp_tpu_torch.postprocessing.spectral import core as spec
    from vasp_tpu_torch.postprocessing.spectral.hi_pass_viz import (
        strain_amplitudes)
    from vasp_tpu_torch.postprocessing.spectral.transform import (
        _TENSOR_SLOTS)

    mesh, space = run["mesh"], run["space"]
    times, v, d = _post_inputs(run, device)
    T, fs = len(times), 1.0 / float(run["dt"])
    mu_f = run["mu_f"][0] if isinstance(run["mu_f"], (list, tuple)) \
        else run["mu_f"]
    tables = FluidBoundaryTables(mesh, run["dx_f_id"])
    idx, tau = hemodynamic_indices(tables, v, space.cell_dofs_p2, mu_f,
                                   times, device=device)
    solid = SolidVertexTables(mesh, space, _normalize_solid_props(run))
    sig, eps, mps, mpe = (a.cpu().numpy() for a in solid.fields(
        d, solid.device_tables(device)))
    comps = {c: eps[..., k // 3, k % 3].reshape(T, -1).T
             for c, k in _TENSOR_SLOTS.items()}
    _, amp = strain_amplitudes(comps, fs, POST_LOWCUT, 1e5, None, T, device)
    fluid = mesh.domain_vertices(np.atleast_1d(run["dx_f_id"]))
    rows = np.sort(np.random.default_rng(0).choice(
        fluid, size=min(POST_NODES, len(fluid)), replace=False))
    speed = np.linalg.norm(v.cpu().numpy()[:, rows], axis=2).T  # (n, T)
    psd, _ = spec.get_psd(speed, fs, device=device)
    sgram, _, _ = spec.get_spectrogram(speed, fs, 2, device=device)
    return dict(tau=tau, sig=sig, eps=eps, mps=mps, mpe=mpe, amp=amp,
                psd=psd, spectrogram=sgram, **idx)


def _seeded(shape, scale, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return scale * torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.float64)


def _touched_bytes(dofs, steps):
    """Bytes of the P2 rows (3 float64) a gather of `dofs` reads over
    `steps` steps, each row counted once per step."""
    return int(len(set(dofs.reshape(-1).tolist()))) * 3 * 8 * steps


def _time_wss(records, run):
    """K20a against its plain version on a seeded POST_STEPS-step velocity
    series at the run's mesh; the host part of the pass (the loads'
    device-to-host copy and the boundary-mass splu solves) timed apart."""
    import numpy as np
    import torch

    from vasp_tpu_torch.kernels import postproc
    from vasp_tpu_torch.postprocessing.fields.hemodynamics import (
        FluidBoundaryTables)

    space = run["space"]
    tables = FluidBoundaryTables(run["mesh"], run["dx_f_id"])
    tab = tables.device_tables(space.cell_dofs_p2, torch.device("cuda"))
    nb, mu = len(tables.bnodes), 3.5e-3
    u = _seeded((POST_STEPS, space.n_p2, 3), 1.0, 100)
    out = postproc.wss_load_cuda(u, *tab, nb, mu)
    plain = postproc.wss_load_plain(u, *tab, nb, mu)
    err = _scale_err(out, plain)
    del plain
    ms = cuda_ms(lambda: postproc.wss_load_cuda(u, *tab, nb, mu), 5)
    plain_ms = cuda_ms(lambda: postproc.wss_load_plain(u, *tab, nb, mu), 2)
    tic = time.perf_counter()
    loads = out.cpu().numpy()
    copy_s = time.perf_counter() - tic
    tic = time.perf_counter()
    np.stack([tables._mass_lu.solve(b) for b in loads])
    solve_s = time.perf_counter() - tic
    ops = count_ops(lambda: postproc.wss_load_plain(u[:1], *tab, nb, mu))
    work = (_touched_bytes(tab[0].cpu().numpy(), POST_STEPS)
            + nbytes(*tab) + nbytes(out), ops * POST_STEPS, "f64")
    K = tab[0].shape[0]
    records.add("wss_load", err, ms, plain_ms, work, TOL_POST,
                f"T={POST_STEPS} K={K}", host_copy_ms=copy_s * 1e3,
                host_splu_ms=solve_s * 1e3, n_bnodes=nb)
    print(f"    K20a host part: device-to-host copy {copy_s * 1e3:.3f} ms, "
          f"{POST_STEPS} splu solves ({nb} boundary nodes) "
          f"{solve_s * 1e3:.3f} ms")


def _time_stress(records, run, name):
    """K20b (the run's material) against its plain version on a seeded
    POST_STEPS-step displacement series at the run's mesh (strains
    ~1e-3-1e-2), in the chunks of steps compute_stress_strain launches
    (default_chunk_steps), both sides; one launch over the whole series
    and the chunks' host copies (displacement in, fields out) apart."""
    import torch

    from vasp_tpu_torch.kernels import postproc
    from vasp_tpu_torch.postprocessing.fields.stress_strain import (
        SolidVertexTables, _normalize_solid_props, default_chunk_steps)

    space = run["space"]
    solid = SolidVertexTables(run["mesh"], space, _normalize_solid_props(run))
    dofs, G = solid.device_tables(torch.device("cuda"))
    d = _seeded((POST_STEPS, space.n_p2, 3), 1e-6, 101)
    chunk = default_chunk_steps(space.n_p2, dofs.shape[0])
    chunks = [d[c:c + chunk] for c in range(0, POST_STEPS, chunk)]
    args = (d, dofs, G, solid.segments)
    got = postproc.stress_strain_cuda(*args)
    want = postproc.stress_strain_plain(*args)
    errs = [_scale_err(g, w) for g, w in zip(got, want)]
    for label, (rel, _), tol in zip(("sigma", "E", "max eig sigma",
                                     "max eig E"), errs,
                                    (TOL_POST, TOL_POST, TOL_EIG, TOL_EIG)):
        require(rel <= tol, f"{name}: {label} {rel:.3e} > {tol:.0e}")
    del want
    ms = cuda_ms(lambda: [postproc.stress_strain_cuda(c, dofs, G,
                                                      solid.segments)
                          for c in chunks], 3)
    one_ms = cuda_ms(lambda: postproc.stress_strain_cuda(*args), 3)
    plain_ms = cuda_ms(lambda: [postproc.stress_strain_plain(
        c, dofs, G, solid.segments) for c in chunks], 1)
    d_host = d.cpu()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for c in range(0, POST_STEPS, chunk):
        out = postproc.stress_strain_cuda(d_host[c:c + chunk].cuda(), dofs,
                                          G, solid.segments)
        [a.cpu() for a in out]
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - tic) * 1e3 - ms
    ops = count_ops(lambda: postproc.stress_strain_plain(
        d[:1], dofs, G, solid.segments))
    work = (_touched_bytes(dofs.cpu().numpy(), POST_STEPS)
            + nbytes(dofs, G, *got), ops * POST_STEPS, "f64")
    err = (max(e[0] for e in errs), max(e[1] for e in errs))
    records.add(name, err, ms, plain_ms, work, TOL_EIG,
                f"T={POST_STEPS} K={dofs.shape[0]}x4", chunk_steps=chunk,
                one_launch_ms=one_ms, host_copy_ms=copy_ms)
    print(f"    {name}: {len(chunks)} launches of {chunk} steps (the CLI's "
          f"chunks) {ms:.4f} ms, one launch of {POST_STEPS} steps "
          f"{one_ms:.4f} ms; the chunks' host copies {copy_ms:.3f} ms")
    return got[1]


def _time_max_eig(records, eps):
    """K20b's eigenvalue entry against get_eig on (points, steps, 3, 3)
    amplitude-shaped tensors: the stress pass's POST_STEPS strain tensors
    of every solid (cell, vertex), hi_pass_viz's strain shape. The library
    yardstick is torch.linalg.eigvalsh's largest eigenvalue (the port never
    calls it), in batches of EIGVALSH_BATCH matrices: cuSOLVER's batched
    syev behind it refuses a batch of 3x3s beyond ~23,000
    (CUSOLVER_STATUS_INVALID_VALUE; PyTorch 2.11, CUDA 12.8)."""
    import torch

    from vasp_tpu_torch.fem.kinematics import get_eig
    from vasp_tpu_torch.kernels import postproc

    A = eps.abs().permute(1, 2, 0, 3, 4).reshape(-1, POST_STEPS, 3, 3)
    A = A.contiguous()
    batches = A.reshape(-1, 3, 3).split(EIGVALSH_BATCH)

    def library():
        return torch.cat([torch.linalg.eigvalsh(b)[:, -1] for b in batches])

    out = postproc.max_eig_cuda(A)
    err = _scale_err(out, get_eig(A))
    lib_err, _ = _scale_err(out.reshape(-1), library())
    ms = cuda_ms(lambda: postproc.max_eig_cuda(A), 3)
    plain_ms = cuda_ms(lambda: get_eig(A), 1)
    lib_ms = cuda_ms(library, 1)
    ops = count_ops(lambda: get_eig(A[:1]))
    work = (nbytes(A) + A[..., 0, 0].numel() * 8, ops * A.shape[0], "f64")
    records.add("max_eig", err, ms, plain_ms, work, TOL_EIG,
                f"{A.shape[0]}x{POST_STEPS}", library_ms=lib_ms,
                library_calls=len(batches))
    print(f"    max_eig against eigvalsh's largest ({len(batches)} calls of "
          f"{EIGVALSH_BATCH}): {lib_err:.3e} of the scale")


def _time_spectral(records):
    """K20c against its plain version on the spectrogram of a seeded
    POST_NODES x POST_STEPS series with the CLIs' windowing (NFFT 256,
    nfft 512, 11 frames), cuFFT's rfft of the same frames beside it; the
    PSD (one frame of all POST_STEPS samples) as a variant."""
    import numpy as np
    import torch
    from scipy.signal import get_window

    from vasp_tpu_torch.kernels import postproc
    from vasp_tpu_torch.postprocessing.spectral import core as spec

    x = _seeded((POST_NODES, POST_STEPS), 1.0, 102)
    n_window = round(POST_WINDOWS_PER_SEC * POST_STEPS * 1e-3) + 3
    NFFT = spec.shift_bit_length(int(POST_STEPS / n_window))
    step = NFFT - int(0.75 * NFFT)
    frames = x.unfold(1, NFFT, step)  # (n, B, NFFT)
    frames = frames - frames.mean(dim=2, keepdim=True)
    w = torch.as_tensor(get_window("blackmanharris", NFFT), device=x.device)
    xw = (frames * w).contiguous()
    scale = 1.0 / float(w.sum()) ** 2
    X = torch.fft.rfft(xw, n=2 * NFFT, dim=2)
    rfft_ms = cuda_ms(lambda: torch.fft.rfft(xw, n=2 * NFFT, dim=2), 5)
    variants = {}
    for label, XX, even in (("psd", torch.fft.rfft(x, dim=1)[:, None, :],
                             POST_STEPS % 2 == 0), ("spectrogram", X, True)):
        XX = XX.contiguous()
        err = _scale_err(postproc.spectral_power_cuda(XX, scale, even),
                         postproc.spectral_power_plain(XX, scale, even))
        ms = cuda_ms(lambda: postproc.spectral_power_cuda(XX, scale, even),
                     10)
        plain_ms = cuda_ms(
            lambda: postproc.spectral_power_plain(XX, scale, even), 3)
        ops = count_ops(lambda: postproc.spectral_power_plain(XX, scale,
                                                              even))
        n, B, F = XX.shape
        b_ms, by = bound(nbytes(XX) + F * B * 8, ops, "f64")
        variants[label] = dict(err=err, ms=ms, plain_ms=plain_ms,
                               work=(nbytes(XX) + F * B * 8, ops, "f64"),
                               shape=f"n={n} B={B} F={F}", bound_ms=b_ms,
                               bound_by=by)
        require(err[0] <= TOL_POST, f"spectral_power ({label}): {err[0]:.3e}")
        print(f"    spectral_power {label} n={n} B={B} F={F}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({by})")
    sg = variants["spectrogram"]
    records.add("spectral_power", sg["err"], sg["ms"], sg["plain_ms"],
                sg["work"], TOL_POST, sg["shape"], rfft_ms=rfft_ms,
                variants={"psd": {k: variants["psd"][k] for k in
                                  ("ms", "plain_ms", "bound_ms", "shape")}})
    print(f"    cuFFT rfft of the spectrogram's frames ({tuple(xw.shape)} -> "
          f"nfft {2 * NFFT}): {rfft_ms:.4f} ms")


def _sharded_postproc_rank(inputs, out_dir, device="cuda"):
    """One rank of phase 10's 2-rank pass (a process of spawn_world, its
    card the current one): the WSS series and the stress/strain fields of
    each kept run in `inputs`, the steps sharded over the ranks
    (FluidBoundaryTables.wss_series and SolidVertexTables.fields with a
    Collectives), the launch counters reset just before and read just
    after; rank 0 writes the WSS, every rank the fields and its
    counters."""
    import torch

    from vasp_tpu_torch.kernels import build
    from vasp_tpu_torch.parallel import bootstrap
    from vasp_tpu_torch.parallel.comm import Collectives
    from vasp_tpu_torch.postprocessing.fields.hemodynamics import (
        FluidBoundaryTables)
    from vasp_tpu_torch.postprocessing.fields.stress_strain import (
        SolidVertexTables, _normalize_solid_props)

    dev = bootstrap.use_rank_device(device)
    comm = Collectives()
    runs = torch.load(inputs, weights_only=False)
    out = {}
    build.reset_launch_counts()
    for k, run in runs.items():
        _, v, d = _post_inputs(run, dev)
        mu_f = run["mu_f"][0] if isinstance(run["mu_f"], (list, tuple)) \
            else run["mu_f"]
        tau = FluidBoundaryTables(run["mesh"], run["dx_f_id"]).wss_series(
            v, run["space"].cell_dofs_p2, mu_f, device=dev, comm=comm)
        solid = SolidVertexTables(run["mesh"], run["space"],
                                  _normalize_solid_props(run))
        sig, eps, mps, mpe = (a.cpu().numpy() for a in solid.fields(
            d, solid.device_tables(dev), comm))
        out[k] = dict(tau=tau, sig=sig, eps=eps, mps=mps, mpe=mpe)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = dict(build.LAUNCHES)
    torch.save(out, Path(out_dir) / f"rank{comm.rank}.pt")


def phase_sharded_postproc(series, card, device="cuda"):
    """Phase 10's 2-rank pass: the same in-memory series on two gloo ranks
    sharing this card (parallel/steps.py's timestep sharding, started by
    bootstrap.spawn_world), against the one-rank card pass `card`: the WSS
    (rank 0's) and the stress/strain fields (every rank's) within 1e-13 of
    their scale (TOL_SHARDED_POST; K20a's float64 atomics make the loads
    differ from run to run in the last bits), K20a and K20b launched on
    each rank."""
    import torch

    from vasp_tpu_torch.parallel import bootstrap

    tic = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vasp_smoke_post_") as tmp:
        inputs = Path(tmp) / "series.pt"
        torch.save({k: dict(run, series=[(t, u.cpu()) for t, u in
                                         run["series"]])
                    for k, run in series.items()}, inputs)
        bootstrap.spawn_world(2, _sharded_postproc_rank,
                              (str(inputs), tmp, device), "gloo")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
    worst = {}
    for k in series:
        for r, res in enumerate(ranks):
            for key, got in res[k].items():
                if got is None:
                    require(r > 0 and key == "tau", f"{k}: rank {r} has no "
                                                    f"{key}")
                    continue
                rel = _scale_err(got, card[k][key])[0]
                require(rel <= TOL_SHARDED_POST,
                        f"{k}: the 2-rank pass's {key} (rank {r}) is "
                        f"{rel:.3e} of its scale from the one-rank pass's")
                worst[key] = max(worst.get(key, 0.0), rel)
    for r, res in enumerate(ranks):
        kinds = ("wss_load", "stress_strain_svk", "stress_strain_mr")
        missing = [n for n in kinds if res["launches"][n] == 0]
        require(not missing, f"the 2-rank pass: rank {r} launched no "
                             f"{missing}")
    print(f"    2-rank gloo pass, both ranks on this card, "
          f"{time.perf_counter() - tic:.1f} s with the ranks' start: max "
          f"|diff| / scale against the one-rank pass "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items())
          + "; launches a rank (wss_load, stress_strain_svk, "
          "stress_strain_mr): " + ", ".join(
              str(tuple(res["launches"][n] for n in kinds))
              for res in ranks))


def phase_postproc(records, series):
    """Phase 10: the postprocessing of phase 8's stenosis series and phase
    9's chain series (the Mooney-Rivlin wall) in memory, on the card with
    the launch counters reset just before and read just after (the path of
    K20a-c), and on the CPU (the plain versions): the indices, WSS, stress,
    strain, eigenvalues, band-pass amplitudes and spectra agree to
    TOL_POST / TOL_EIG of their scale. Then each K20 kernel against its
    plain version at production shapes (a POST_STEPS-step series at the
    20,832-cell tubes, a POST_NODES-node spectrogram), timed."""
    import gc

    import torch

    from vasp_tpu_torch.kernels import build

    print(f"[10] postprocessing of the stenosis's and the chain's "
          f"{len(series['stenosis']['series'])}-step series in memory, card "
          f"against CPU:")
    start = tic = time.perf_counter()
    build.reset_launch_counts()
    card = {k: _postproc_pass(run, torch.device("cuda"))
            for k, run in series.items()}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    card_s = time.perf_counter() - tic
    check_launches("postproc", launches)
    host = {k: _postproc_pass(run, torch.device("cpu"))
            for k, run in series.items()}
    for k in series:
        worst = []
        for key, ref in host[k].items():
            tol = TOL_EIG if key in ("mps", "mpe", "amp", "OSI", "RRT",
                                     "ECAP") else TOL_POST
            rel, _ = _scale_err(card[k][key], ref)
            require(rel <= tol, f"{k}: {key} on the card is {rel:.3e} of "
                                f"its scale from the CPU's (> {tol:.0e})")
            worst.append(f"{key} {rel:.1e}")
        print(f"    {k}: card vs CPU, max |diff| / scale: "
              f"{', '.join(worst)}")
    print(f"    the card's pass of both series took {card_s:.2f} s")
    print(f"    launches {dict((n, launches[n]) for n in PATHS['postproc'])}")
    phase_sharded_postproc(series, card)
    print(f"[10] the K20 kernels at size ({POST_STEPS} steps, "
          f"{POST_NODES} nodes):")
    _time_wss(records, series["stenosis"])
    gc.collect()
    torch.cuda.empty_cache()
    eps = _time_stress(records, series["stenosis"], "stress_strain_svk")
    _time_max_eig(records, eps)
    del eps
    gc.collect()
    torch.cuda.empty_cache()
    _time_stress(records, series["chain"], "stress_strain_mr")
    gc.collect()
    torch.cuda.empty_cache()
    _time_spectral(records)
    print(f"[10] phase 10 took {time.perf_counter() - start:.1f} s")
    return launches


def pipe_system(device):
    """A transient flow in a rigid pipe on NewtonSolver's Krylov branch
    (tests/test_torch_schwarz.py's _pipe_system, no mesh lifting): (system,
    bc set)."""
    import numpy as np

    from vasp_tpu_torch.fem.dirichlet import DirichletBC
    from vasp_tpu_torch.mesh.generate import poiseuille_pipe_mesh
    from vasp_tpu_torch.run.system import FSISystem

    mesh = poiseuille_pipe_mesh(radius=1.0, length=3.0, n_theta=6, n_r=2,
                                n_z=3)
    system = FSISystem(mesh, dict(
        dt=1e-3, theta=1.0, rho_f=1.0, mu_f=1.0, dx_f_id=1, solid="no_solid",
        extrapolation="no_extrapolation", atol=1e-10, rtol=1e-12,
        recompute=1, recompute_tstep=1, linear_solver="krylov",
        quadrature_degree=4, verbose=False, device=device))
    space = system.space
    bcs = [DirichletBC(space.field_dofs("d", np.arange(space.n_p2)), 0.0)]
    for marker in (2, 3, 22):
        p2d = space.p2_dofs_on_facets(marker)
        xyz = space.p2_coords[p2d]
        u = np.zeros_like(xyz)
        u[:, 2] = 1.0 - xyz[:, 0] ** 2 - xyz[:, 1] ** 2
        bcs.append(DirichletBC(space.field_dofs("v", p2d), u.reshape(-1)))
    bcs.append(DirichletBC(space.pressure_dofs(mesh.facet_vertices(3)),
                           0.0))
    return system, system.make_bcset(bcs)


def krylov_pipe_solve(device):
    """One solve of the pipe's first step on `device`: (U on the host,
    Newton iterations, converged, GMRES restarts, Arnoldi iterations)."""
    system, bc = pipe_system(device)
    solver = system.make_solver(bc, **PIPE_SOLVE)
    U0 = system.zero_state()
    U, info = solver.solve(bc.apply(U0, 0.0), U0, t=0.0, tstep=0)
    return (U.cpu(), info["iterations"], info["converged"],
            solver.gmres_restarts, solver.gmres_iterations)


def step_fn_run(device, mesh_params, opts=None):
    """make_step_fn on the tube of `mesh_params` (bench.py's physics without
    the stenosis, its Dirichlet sets and 150x interface load) on `device`:
    one step from rest at t = 1e-3; (U, stats, wall seconds, system, bc)."""
    import torch

    from vasp_tpu_torch.fem.timestepper import StepOptions, make_step_fn

    system, bc, load = bench_tube(mesh_params, device, stenosis=False)
    sp = system.space
    step = make_step_fn(system.assembler, bc.mask_on(device),
                        StepOptions(**(opts or {})), layout=(sp.n_p2, sp.off_p))
    bcv = torch.as_tensor(bc.values_at(1e-3), device=device)
    tic = time.perf_counter()
    U, stats = step(system.zero_state(), bcv, load)
    if device == "cuda":
        torch.cuda.synchronize()
    return U, stats, time.perf_counter() - tic, system, bc


def check_new_paths(ref, pipe, step_fn, launches):
    """Phase 3's cases of NewtonSolver's Krylov branch (the rigid pipe, at
    tests/test_torch_schwarz.py's options) and of make_step_fn (the small
    tube of the forced ladder runs, at STEP_FN_OPTS), the card's runs
    (`pipe`, `step_fn`) against their CPU references: the same Newton
    counts, each converged, U within TOL_PATH_PIPE and TOL_PATH_STEP_FN
    relative; the launches of the card runs."""
    check_launches("krylov_pipe", launches["krylov_pipe"])
    Uc, itc, convc, *gc_ = ref["pipe"]
    Ug, itg, convg, *gg = pipe
    rel = float((Ug - Uc).norm() / Uc.norm())
    print(f"[3] NewtonSolver Krylov branch on the rigid pipe ({Uc.shape[0]} "
          f"dofs, {PIPE_SOLVE}): Newton iterations cpu {itc} cuda {itg}, "
          f"converged {convc} {convg}; GMRES restarts and Arnoldi iterations "
          f"cpu {gc_} cuda {gg}; U rel diff {rel:.3e}")
    require(convc and convg, "the rigid pipe's Krylov-branch solve did not "
                             "converge")
    require(itc == itg, "Krylov branch: Newton counts differ between the "
                        "CPU and the card")
    require(rel <= TOL_PATH_PIPE, f"Krylov branch: U differs by {rel:.3e}")
    check_launches("step_fn", launches["step_fn_tiny"])
    (Uc, sc), (Ug, sg) = ref["step_fn"], step_fn
    rel = float((Ug.cpu() - Uc).norm() / Uc.norm())
    print(f"[3] make_step_fn on the {LADDER_MESH['n_z']}-layer tube "
          f"({Uc.shape[0]} dofs, {STEP_FN_OPTS}): Newton iterations "
          f"cpu {sc['iterations']} cuda {sg['iterations']}; residual cpu "
          f"{sc['residual']:.3e} cuda {sg['residual']:.3e} (r0 "
          f"{sc['r0']:.3e}); U rel diff {rel:.3e}")
    require(sc["iterations"] == sg["iterations"],
            "make_step_fn: Newton counts differ between the CPU and the card")
    require(max(sc["residual"], sg["residual"]) <= STEP_FN_OPTS["atol"],
            "make_step_fn: the small tube's step did not converge")
    require(rel <= TOL_PATH_STEP_FN, f"make_step_fn: U differs by {rel:.3e}")


def phase_newton_krylov(tmp):
    """Phase 13a: driver.main on -p cylinder at the 20,832-cell tube with
    linear_solver="krylov", one step, max_it=2, raise_on_fail=False; the
    launches, Newton iterations, GMRES restarts and Arnoldi iterations,
    the rebuild by phase and the per-iteration costs."""
    print("[13a] cylinder, NewtonSolver's Krylov branch (linear_solver="
          "krylov: element-block Schwarz and GMRES at vasp_tpu's defaults), "
          f"one step, max_it={NEWTON_KRYLOV['max_it']}:")
    ns, launches = run_main_path(tmp, "newton_krylov", FULL_MESH, T=0.001,
                                 floor=math.inf, **NEWTON_KRYLOV)
    sol = ns["solver"]
    t = sol.timings
    its = max(sol.gmres_iterations, 1)
    print(f"    GMRES restarts {sol.gmres_restarts}, Arnoldi iterations "
          f"{sol.gmres_iterations}; rebuild split (s): jacobian "
          f"{t['jacobian']:.3f}, schwarz_build {t['schwarz_build']:.3f}, "
          f"schwarz_invert {t['schwarz_invert']:.3f}")
    print(f"    per-iteration split, summed over the run (s): residual "
          f"{t['residual']:.3f}, gmres {t['gmres']:.3f}; per Arnoldi "
          f"iteration {t['gmres'] / its * 1e3:.3f} ms (its matvec and "
          f"Schwarz apply: phase 13c's K4 and K22 times)")
    return launches


def phase_step_fn():
    """Phase 13b: make_step_fn at the 20,832-cell tube (bench.py's physics
    without the stenosis), one step at StepOptions' defaults, counters
    reset just before and read just after. Returns the launches and the
    run's system and bc set (for 13c)."""
    import torch

    from vasp_tpu_torch.fem.timestepper import StepOptions
    from vasp_tpu_torch.kernels import build

    print("[13b] make_step_fn (Ruiz + node-block GMRES Newton, float64 "
          "Jacobians every iteration) at the 20,832-cell tube, one step at "
          "StepOptions' defaults:")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    U, stats, wall, system, bc = step_fn_run("cuda", FULL_MESH)
    launches = dict(build.LAUNCHES)
    check_launches("step_fn", launches)
    require(bool(torch.isfinite(U).all()) and math.isfinite(
        stats["residual"]), "make_step_fn: non-finite state or residual")
    opt = StepOptions()
    converged = (stats["residual"] <= opt.atol
                 or stats["residual"] <= opt.rtol * stats["r0"])
    print(f"    {system.space.ndof} dofs: Newton iterations "
          f"{stats['iterations']}, residual {stats['residual']:.3e}, r0 "
          f"{stats['r0']:.3e}, converged {converged}; {wall:.2f} s")
    print(f"    launches {dict((k, launches[k]) for k in PATHS['step_fn'])}")
    print(f"    peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, system, bc


def phase_new_kernels(records, system, bc):
    """Phase 13c: K22 (build, apply, divide), K7's float64 scale and K17
    (extract, invert, apply) against their plain versions at the
    20,832-cell tube's shapes (its float64 Jacobians at a seeded state,
    the two 64-wide cell blocks), f64 to TOL_F64; each timed with its
    bound and plain version, and its one-call yardstick where there is
    one: torch.linalg.inv of K22's modified blocks (its inverse) and of
    K17's node blocks, cuSPARSE's SpMV of the assembled Schwarz operator
    for K22's apply, torch.div for K22's divide (whose launches are also
    timed replayed from a CUDA graph, beside torch.div's, to part the
    card's time from the host's launch cost), torch.bmm for K17's apply.
    Then the float32-inverse build of fem/preconditioner.py: equal to the
    same build on the plain K22 (the same modified blocks, the same
    float32 inverse)."""
    import gc

    import numpy as np
    import torch

    from vasp_tpu_torch.fem.scaling import ruiz_scales
    from vasp_tpu_torch.kernels import nodeblock as knb
    from vasp_tpu_torch.kernels import scaling as ks
    from vasp_tpu_torch.kernels import schwarz as kz

    print("[13c] K22, K7's float64 scale and K17 at the 20,832-cell tube:")
    sp, blocks = system.space, system.assembler.blocks
    ndof = sp.ndof
    rng = np.random.default_rng(13)
    scale = np.concatenate([np.full(3 * sp.n_p2, 1e-6),
                            np.full(3 * sp.n_p2, 1e-2),
                            np.full(sp.n_p1, 1e2)])
    U = torch.as_tensor(rng.normal(size=ndof) * scale, device="cuda")
    U0 = torch.as_tensor(rng.normal(size=ndof) * scale, device="cuda")
    jacs = system.assembler.element_jacobians(U, U0)
    del U, U0
    mask = bc.mask_on("cuda")
    dofs = [b.dofs for b in blocks]
    K_all = sum(d.shape[0] for d in dofs)
    dof_bytes = nbytes(*dofs)
    shape = f"K={K_all}, n=64, f64"

    # ---- K22 build
    def build_all(fn):
        mult = torch.zeros(ndof, dtype=torch.float64, device="cuda")
        return [fn(A, d, mask, 1e-12, mult) for A, d in zip(jacs, dofs)], mult

    (Ak, mk), (Ap, mp) = build_all(kz.build_cuda), build_all(kz.build_plain)
    err = max(max(rel_err(a, b) for a, b in zip(Ak, Ap)), rel_err(mk, mp))
    del Ak, mk
    ms = cuda_ms(lambda: build_all(kz.build_cuda), 10)
    plain_ms = cuda_ms(lambda: build_all(kz.build_plain), 3)
    inv_ms = cuda_ms(lambda: [torch.linalg.inv(A) for A in Ap], 3)
    records.add("schwarz_build", err, ms, plain_ms,
                (2 * nbytes(*jacs) + dof_bytes + nbytes(mask) + 8 * ndof,
                 3 * K_all * 64, "f64"), TOL_F64, shape,
                inverse_ms=inv_ms)
    print(f"    torch.linalg.inv of the modified blocks (the branch's "
          f"inverse): {inv_ms:.4f} ms")
    # fem/preconditioner.py: its build (K22 at eps 1e-8, float32 inverses)
    # equal to the same build on the plain K22
    from vasp_tpu_torch.fem import preconditioner as tpre

    Pk32, mk32 = tpre.build_schwarz(blocks, jacs, mask, ndof)
    mp32 = torch.zeros(ndof, dtype=torch.float64, device="cuda")
    Pp32 = [torch.linalg.inv(kz.build_plain(A, d, mask, 1e-8, mp32).float())
            .double() for A, d in zip(jacs, dofs)]
    require(torch.equal(mk32, mp32) and all(
        torch.equal(a, b) for a, b in zip(Pk32, Pp32)),
        "fem/preconditioner.py's build on K22 differs from the plain one")
    del Pk32, Pp32
    pinv = [torch.linalg.inv(A).contiguous() for A in Ap]
    del Ap
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K22 apply and divide
    mult = torch.clamp(mp, min=1.0)
    r = torch.as_tensor(rng.normal(size=ndof), device="cuda")
    yk = kz.apply_cuda(pinv, dofs, r)
    yp = kz.apply_plain(pinv, dofs, r)
    rows = torch.cat([d[:, :, None].expand(-1, 64, 64).reshape(-1)
                      for d in dofs])
    cols = torch.cat([d[:, None, :].expand(-1, 64, 64).reshape(-1)
                      for d in dofs])
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.cat([P.reshape(-1) for P in pinv]),
        (ndof, ndof)).coalesce().to_sparse_csr()
    del rows, cols
    lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, r[:, None]), 20)
    print(f"    cuSPARSE SpMV of the assembled Schwarz operator "
          f"({csr._nnz()} nonzeros): {lib_ms:.4f} ms")
    del csr
    records.add("schwarz_apply", rel_err(yk, yp),
                cuda_ms(lambda: kz.apply_cuda(pinv, dofs, r), 20),
                cuda_ms(lambda: kz.apply_plain(pinv, dofs, r), 5),
                (nbytes(*pinv, r) + dof_bytes + 8 * ndof, 2 * K_all * 4096,
                 "f64"), TOL_F64, shape, library_ms=lib_ms)
    # the timed divides run in place on a copy (mult >= 1: it shrinks)
    ytmp = yk.clone()
    graph_ms = cuda_graph_ms(lambda: kz.divide_cuda(ytmp, mult), 50)
    graph_library_ms = cuda_graph_ms(lambda: torch.div(yp, mult), 50)
    records.add("schwarz_divide",
                rel_err(kz.divide_cuda(yk.clone(), mult),
                        kz.divide_plain(yp, mult)),
                cuda_ms(lambda: kz.divide_cuda(ytmp, mult), 50),
                cuda_ms(lambda: kz.divide_plain(yp, mult), 50),
                (3 * 8 * ndof, ndof, "f64"), TOL_F64, f"ndof={ndof}",
                library_ms=cuda_ms(lambda: torch.div(yp, mult), 50),
                graph_ms=graph_ms, graph_library_ms=graph_library_ms)
    print(f"    schwarz_divide and torch.div replayed from a CUDA graph "
          f"(no host launch cost): {graph_ms:.4f} ms, "
          f"{graph_library_ms:.4f} ms")
    del pinv, yk, yp, ytmp
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K7's float64 scale, then K17 on the scaled blocks
    dr, dc = ruiz_scales(blocks, jacs, mask, ndof, sweeps=4)
    Sk = [ks.ruiz_scale_cuda(A, d, dr, dc) for A, d in zip(jacs, dofs)]
    Sp = [ks.ruiz_scale_plain(A, d, dr, dc) for A, d in zip(jacs, dofs)]
    records.add("ruiz_scale_f64", max(rel_err(a, b) for a, b in zip(Sk, Sp)),
                cuda_ms(lambda: [ks.ruiz_scale_cuda(A, d, dr, dc)
                                 for A, d in zip(jacs, dofs)], 10),
                cuda_ms(lambda: [ks.ruiz_scale_plain(A, d, dr, dc)
                                 for A, d in zip(jacs, dofs)], 3),
                (2 * nbytes(*jacs) + dof_bytes + nbytes(dr, dc),
                 2 * 4096 * K_all, "f64"), 0.0, shape)
    del Sk, jacs
    gc.collect()
    torch.cuda.empty_cache()

    def extract(fn):
        nb = torch.zeros((sp.n_p2, 6, 6), dtype=torch.float64, device="cuda")
        for A, d in zip(Sp, dofs):
            fn(A, d, nb)
        return nb

    nb = extract(knb.extract_plain)
    # the yardstick: one index_add_ of the cells' 6x6 node blocks gathered
    # beforehand (K8's convention), into a zeroed sum
    loc = torch.as_tensor(knb._LOCAL, device="cuda")
    blocks6 = torch.cat([A[:, loc[:, :, None], loc[:, None, :]].reshape(
        -1, 6, 6) for A in Sp])
    nodes6 = torch.cat([(d[:, 0:30:3] // 3).reshape(-1) for d in dofs])
    nb6 = torch.zeros_like(nb)
    lib_ms = cuda_ms(lambda: nb6.index_add_(0, nodes6, blocks6), 20)
    del blocks6, nodes6, nb6
    records.add("node_block_extract", rel_err(extract(knb.extract_cuda), nb),
                cuda_ms(lambda: extract(knb.extract_cuda), 20),
                cuda_ms(lambda: extract(knb.extract_plain), 5),
                (K_all * 10 * (36 + 1) * 8 + 36 * 8 * sp.n_p2,
                 36 * 10 * K_all, "f64"), TOL_F64, f"K={K_all}, n_p2={sp.n_p2}",
                library_ms=lib_ms)
    Pp = knb.invert_plain(nb, mask)
    scale_n = Pp.abs().amax(dim=(1, 2), keepdim=True)
    Pk = knb.invert_cuda(nb, mask)
    err = (float(((Pk - Pp).abs() / scale_n).max()),
           float((Pk - Pp).abs().max()))
    records.add("node_block_invert", err,
                cuda_ms(lambda: knb.invert_cuda(nb, mask), 50),
                cuda_ms(lambda: knb.invert_plain(nb, mask), 5),
                (2 * nbytes(nb) + 6 * sp.n_p2,
                 count_ops(lambda: knb.invert_plain(nb, mask)), "f64"),
                TOL_F64, f"n_p2={sp.n_p2} (per-node scale)",
                library_ms=cuda_ms(lambda: torch.linalg.inv(nb), 5))
    r = torch.as_tensor(rng.normal(size=ndof), device="cuda")
    rb = torch.cat([r[: 3 * sp.n_p2].reshape(-1, 3),
                    r[3 * sp.n_p2: 6 * sp.n_p2].reshape(-1, 3)], dim=1)
    records.add("node_block_apply",
                rel_err(knb.apply_cuda(Pp, r, sp.n_p2, sp.off_p),
                        knb.apply_plain(Pp, r, sp.n_p2, sp.off_p)),
                cuda_ms(lambda: knb.apply_cuda(Pp, r, sp.n_p2, sp.off_p), 50),
                cuda_ms(lambda: knb.apply_plain(Pp, r, sp.n_p2, sp.off_p), 10),
                (nbytes(Pp, r) + 8 * ndof, 72 * sp.n_p2, "f64"), TOL_F64,
                f"n_p2={sp.n_p2}",
                library_ms=cuda_ms(lambda: torch.bmm(Pp, rb[:, :, None]), 20))
    del Sp, nb, Pp, Pk
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 15 --
# a problem file: -p cylinder on each rank of a sharded run, the rank's
# launch counters (reset just before its time loop, read just after), peak
# memory, step times (pre_solve to post_solve, synchronized) and stepper
# records written to <folder>/rank<r>.json, rank 0's final state to
# <folder>/U.pt (phase 15b)
SHARDED_PROBLEM = '''"""-p cylinder, each rank's counters and records kept (chip_smoke.py phase 15b)."""
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from vasp_tpu_torch.kernels import build
from vasp_tpu_torch.models.cylinder import (  # noqa: F401
    create_bcs, get_mesh_domain_and_boundaries, set_problem_parameters)
from vasp_tpu_torch.models.cylinder import post_solve as _post_solve
from vasp_tpu_torch.models.cylinder import pre_solve as _pre_solve


def initiate(system, **namespace):
    torch.cuda.reset_peak_memory_stats(system.device)
    build.reset_launch_counts()
    return {{"step_clock": []}}


def pre_solve(step_clock, **namespace):
    torch.cuda.synchronize()
    step_clock.append(time.perf_counter())
    return _pre_solve(**namespace)


def post_solve(step_clock, **namespace):
    _post_solve(**namespace)
    torch.cuda.synchronize()
    step_clock.append(time.perf_counter())


def finished(solver, system, dvp_, folder, step_clock, **namespace):
    torch.cuda.synchronize()
    st = solver.stepper
    rank = dist.get_rank()
    Path(folder, f"rank{{rank}}.json").write_text(json.dumps(dict(
        rank=rank, device=str(system.device), launches=dict(build.LAUNCHES),
        history=st.history, timings=dict(st.timings), setup=st.setup,
        rebuilds=st.rebuilds, probe=st._last_rel, c=st.plan.c,
        nb_loc=st.plan.nb_loc,
        step_s=[b - a for a, b in zip(step_clock[::2], step_clock[1::2])],
        peak=torch.cuda.max_memory_allocated(system.device),
        backend=dist.get_backend())))
    if rank == 0:
        torch.save(dvp_["n"].cpu(), Path(folder, "U.pt"))
'''


def sharded_run(tmp, label, backend, n=2, **cfg):
    """vasp-tpu-torch-run -p cylinder at the 20,832-cell tube on phase 5's
    configuration with n_devices=n and the config keys cfg, through
    SHARDED_PROBLEM, as the console script runs it (driver.main starts the
    ranks); 3 steps. Returns (wall seconds, the ranks' records, rank 0's
    metrics, U)."""
    import torch

    from vasp_tpu_torch.run import driver

    path = tmp / f"{label}_problem.py"
    path.write_text(SHARDED_PROBLEM.format())
    cfg_path = tmp / f"{label}_config.json"
    cfg_path.write_text(json.dumps(dict(
        mesh_path=None, generated_mesh_params=FULL_MESH, **dict(
            RUN_KEYS, n_devices=n), linear_solver="gmres",
        dist_backend=backend, **cfg)))
    folder = tmp / f"main_{label}"
    tic = time.perf_counter()
    ret = driver.main(["-p", str(path), "-T", "0.003", "-dt", "0.001",
                       "--folder", str(folder), "--config", str(cfg_path)])
    wall = time.perf_counter() - tic
    require(ret is None, f"{label}: driver.main returned a namespace")
    ranks = [json.loads((folder / f"rank{r}.json").read_text())
             for r in range(n)]
    steps = [json.loads(line) for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    return wall, ranks, steps, torch.load(folder / "U.pt")


def phase_sharded(tmp, ref_steps, extra):
    """Phase 15b and 15d: the 2-rank runs of sharded_run on gloo, both
    ranks on this card (their exchanges are gloo all-reduces of CUDA
    tensors, which gloo stages through the host), held to phase 5's first 3
    steps: 15b with the chain apply (the default), the same Newton counts;
    15d with shard_algo="spike" (2 refinement passes, the default), every
    step converged; both with U within 3e-5 relative (TOL_PATH_GMRES) and
    every kernel of the path launched (summed over the ranks; K21a on each,
    and K21f-a on each in 15d). Prints per rank Newton and GMRES counts,
    the rebuild by part, s/step of the steps that reuse the factors, peak
    memory and the sharded kernels' launches. With two cards or more, 15b
    on nccl too (one card a rank). Returns the launches of 15b's and 15d's
    gloo runs, summed over the ranks."""
    import torch

    runs = [("15b", "sharded", "gloo", {}),
            ("15d", "sharded_spike", "gloo", dict(shard_algo="spike"))]
    if torch.cuda.device_count() >= 2:
        runs.append(("15b", "sharded_nccl", "nccl", {}))
    else:
        print("[15b] one card: the nccl run (one card a rank) is not made")
    out = {}
    for tag, label, backend, cfg in runs:
        algo = cfg.get("shard_algo", "chain")
        print(f"[{tag}] cylinder at 20,832 cells, phase 5's configuration "
              f"(linear_solver=gmres), n_devices=2, dist_backend={backend}, "
              f"shard_algo={algo}, 3 steps, started as vasp-tpu-torch-run "
              f"starts it:")
        wall, ranks, steps, U = sharded_run(tmp, label, backend, **cfg)
        newton = [s["newton_iterations"] for s in steps]
        require(len(steps) == 3 and all(s["converged"] for s in steps),
                f"{label}: steps {steps}")
        if algo == "chain":
            require(newton == [it for _, it in ref_steps],
                    f"{label}: Newton iterations {newton}, phase 5's "
                    f"{[it for _, it in ref_steps]}")
        rel = rel_err(U, ref_steps[-1][0])[0]
        require(bool(torch.isfinite(U).all()) and rel <= TOL_PATH_GMRES,
                f"{label}: U {rel:.3e} from phase 5's step 3")
        launches = {k: sum(r["launches"][k] for r in ranks)
                    for k in ranks[0]["launches"]}
        path = "sharded_spike" if algo == "spike" else "sharded"
        check_launches(path, launches)
        print(f"    3 steps in {wall:.2f} s (the ranks' start and build "
              f"included); Newton iterations {newton} (phase 5's "
              f"{[it for _, it in ref_steps]}); U {rel:.3e} from phase 5's "
              f"step-3 state; transport: {ranks[0]['backend']} all-reduce "
              f"of CUDA tensors")
        for r in ranks:
            t = r["timings"]
            hist = r["history"]
            print(f"    rank {r['rank']} on {r['device']} (c={r['c']}, "
                  f"{r['nb_loc']} blocks): Newton {[h['iterations'] for h in hist]}"
                  f", GMRES inner {[h['gmres_inner'] for h in hist]} in "
                  f"{[h['gmres_cycles'] for h in hist]} cycles, rebuilds "
                  f"{r['rebuilds']}, probe {r['probe']:.3e}")
            print("      rebuild split (s): " + ", ".join(
                f"{k} {t.get(k, 0.0):.3f}" for k in (
                    "rebuild_jacobians", "ruiz", "assemble", "factorize",
                    "transfer", "spikes", "reduced", "probe"))
                + f"; plan {r['setup']['plan']:.2f}")
            print("      per-iteration split, summed (s): " + ", ".join(
                f"{k} {t.get(k, 0.0):.3f}" for k in (
                    "jacobians", "residual", "gmres", "matvec", "precond")))
            inner = max(1, sum(h["gmres_inner"] for h in hist))
            print(f"      K21d, the all-reduces (card synchronized around "
                  f"each): {t.get('exchange', 0.0):.3f} s, "
                  f"{t.get('exchange_bytes', 0.0):.0f} bytes, "
                  f"{t.get('exchange_bytes', 0.0) / inner:.0f} bytes a GMRES "
                  f"iteration over the run's {inner}")
            print(f"      s/step {', '.join(f'{x:.3f}' for x in r['step_s'])}"
                  f" (steps 2-3 reuse the factors: mean "
                  f"{sum(r['step_s'][1:]) / 2:.3f} s); peak device memory "
                  f"{r['peak'] / 2**30:.2f} GiB; K21a launches "
                  f"{r['launches']['banded_carry']}, carry updates "
                  f"{r['launches']['banded_carry_update']}, K21f-a "
                  f"{r['launches']['banded_tri_residual']}")
            require(r["launches"]["banded_carry"] > 0,
                    f"{label}: rank {r['rank']} launched no K21a")
            if algo == "spike":
                require(r["launches"]["banded_tri_residual"] > 0,
                        f"{label}: rank {r['rank']} launched no K21f-a")
        extra[f"{label}_peak_gib"] = [r["peak"] / 2**30 for r in ranks]
        extra[f"{label}_step_s"] = [r["step_s"] for r in ranks]
        extra[f"{label}_newton"] = newton
        out.setdefault(path, launches)
    return out


# ---------------------------------------------------------------- phase 14 --
# the delta endgame's configuration: bench.py's options with its
# residual_dtype="f32" (BENCH_RESID=f32), delta_endgame at its default;
# with the anchor chain (BENCH_CHAIN=1)
DELTA_CFG = dict(BENCH_CFG, residual_dtype="f32")
CHAIN_CFG = dict(DELTA_CFG, chain_anchor=True)
# K13's launch counters: the cell blocks' per form, lifting and material,
# the facet route's per form
K13_COUNTERS = ("fluid_delta", "fluid_delta2", "fluid_delta_elastic",
                "fluid_delta2_elastic", "fluid_delta_nolift",
                "fluid_delta2_nolift", "solid_delta", "solid_delta2",
                "solid_delta_mr", "solid_delta2_mr", "robin_delta",
                "robin_delta2")
# a problem file: -p <model> with each step's raw float64 residual norm
# at its exit state and the launch counters after it kept (phase 14)
DELTA_PROBLEM = '''"""-p {model}, each step's raw exit residual and launches kept (chip_smoke.py phase 14)."""
import torch

from vasp_tpu_torch.fem.biharmonic import correction_apply
from vasp_tpu_torch.kernels import build
from vasp_tpu_torch.models.{model} import *  # noqa: F401,F403
from vasp_tpu_torch.models.{model} import post_solve as _post_solve


def post_solve(dvp_, system, bc_set, **namespace):
    """The model's post_solve, then the raw float64 residual norm of the
    step's exit state (the residual R64(U) + load + lift(U) of the step
    from dvp_["n-1"], masked) and a copy of the launch counters."""
    _post_solve(dvp_=dvp_, system=system, bc_set=bc_set, **namespace)
    U, U0 = dvp_["n"], dvp_["n-1"]
    R = system.assembler.residual(U, U0)
    if namespace.get("load_fn") is not None:
        R = R + namespace["load_fn"](namespace["t"])
    if system.lift is not None:
        R = R + correction_apply(system.lift, U)
    R = torch.where(bc_set.mask_on(U.device), 0.0, R)
    kept = namespace.get("delta_steps", []) + [
        (float(torch.linalg.norm(R)), dict(build.LAUNCHES))]
    return {{"delta_steps": kept}}
'''


def delta_run(tmp, label, model, mesh_params, steps, floor=None, dt=1e-3,
              **cfg):
    """driver.main on -p `model` through DELTA_PROBLEM for `steps` steps of
    `dt` (run_main_path's checks); prints per step the Newton
    iterations, GMRES inner iterations, the fine flag, the ladder tiers,
    the anchor, the Taylor-delta residuals and K13's launches, and the
    raw float64 residual norm at the exit state beside the reported one.
    Returns (ns, launches, per-step records)."""
    path = tmp / f"{label}_problem.py"
    path.write_text(DELTA_PROBLEM.format(model=model))
    ns, launches = run_main_path(tmp, label, mesh_params, problem=str(path),
                                 T=steps * dt, dt=dt, floor=floor, **cfg)
    st = ns["solver"].stepper
    kept = ns["delta_steps"]
    metrics = [json.loads(line) for line in
               (Path(ns["folder"]) / "metrics.jsonl").read_text()
               .splitlines()]
    require(len(kept) == len(st.history) == steps,
            f"{label}: {len(kept)} kept steps, {len(st.history)} history "
            f"records, {steps} steps")
    prev = dict.fromkeys(K13_COUNTERS, 0)
    out = []
    for (raw, snap), h, m in zip(kept, st.history, metrics):
        k13 = {k: snap[k] - prev[k] for k in K13_COUNTERS
               if snap[k] != prev[k]}
        prev = {k: snap[k] for k in K13_COUNTERS}
        out.append(dict(h, raw=raw, reported=m["residual"], k13=k13))
        print(f"    step {h['tstep']}: Newton {h['iterations']}, GMRES "
              f"{h['gmres_inner']} in {h['gmres_cycles']} cycles, fine "
              f"{h['fine']}, tiers {h['tiers']}, anchor {h['anchor']}, "
              f"Taylor-delta residuals {h['deltas']}, K13 launches {k13}; "
              f"reported residual {m['residual']:.3e}, raw float64 "
              f"residual at the exit state {raw:.3e}")
    t = st.timings
    print(f"    time in K13's deltas {t['delta']:.3f} s, in the other "
          f"residuals {t['residual']:.3f} s (summed over the run)")
    return ns, launches, out


def check_delta_steps(label, steps, n_cells):
    """Every Taylor-delta residual of a step launched K13's delta on each
    of the run's n_cells cell blocks: a step that went on past its
    anchor launched it, and no other did."""
    for s in steps:
        n = sum(v for k, v in s["k13"].items()
                if k.startswith(("fluid_delta", "solid_delta"))
                and "delta2" not in k)
        require(n == n_cells * s["deltas"],
                f"{label}: step {s['tstep']} launched K13 {n} times for "
                f"{s['deltas']} Taylor-delta residuals on {n_cells} cell "
                f"blocks")


def phase_delta_endgame(tmp):
    """Phase 14a: -p cylinder at the 20,832-cell tube, bench.py's options
    with residual_dtype="f32" (DELTA_CFG), 5 steps."""
    print("[14a] cylinder, the Taylor-delta endgame (bench configuration "
          "with residual_dtype=f32, delta_endgame at its default), 5 "
          "steps:")
    _, launches, steps = delta_run(tmp, "delta_endgame", "cylinder",
                                   FULL_MESH, 5, **DELTA_CFG)
    check_delta_steps("delta_endgame", steps, 2)
    return launches


def phase_chain_anchor(tmp):
    """Phase 14b: the same with chain_anchor=True (CHAIN_CFG), 4 steps:
    K13's delta2 launched once on each cell block at every chained anchor
    and never at a raw one, and at least one chained anchor."""
    print("[14b] cylinder, the cross-step anchor chain (CHAIN_CFG: "
          "chain_anchor=True, chain_reanchor=1), 4 steps:")
    _, launches, steps = delta_run(tmp, "chain_anchor", "cylinder",
                                   FULL_MESH, 4, **CHAIN_CFG)
    check_delta_steps("chain_anchor", steps, 2)
    for s in steps:
        n2 = s["k13"].get("fluid_delta2", 0) + s["k13"].get("solid_delta2", 0)
        require(n2 == (2 if s["anchor"] == "chained" else 0),
                f"chain_anchor: step {s['tstep']}'s {s['anchor']} anchor "
                f"launched K13's delta2 {n2} times")
    require(any(s["anchor"] == "chained" for s in steps),
            "chain_anchor: no step chained its anchor")
    return launches


def phase_delta_models(tmp):
    """Phase 14d: the tiny aneurysm (Robin facets: K13's facet route) and
    the tiny predeform (the Mooney-Rivlin wall) of phase 3 on CHAIN_CFG,
    3 steps each, counters reset just before each run and read just
    after. The predeform's theta=1 inflation stalls on the bench options
    in both packages (phase 9), so it runs with raise_on_fail=False and
    fails only on non-finite values or a missing launch."""
    out = {}
    runs = (("aneurysm_chain", "aneurysm", TINY_ANEURYSM, {}),
            ("predeform_chain", "predeform", TINY_PREDEFORM,
             dict(atol=TINY_PREDEFORM["atol"], rtol=TINY_PREDEFORM["rtol"],
                  max_it=50, raise_on_fail=False)))
    for label, model, tiny, extra in runs:
        print(f"[14d] tiny {model} on the anchor chain (CHAIN_CFG), 3 "
              f"steps:")
        cfg = {k: v for k, v in tiny.items()
               if k not in ("T", "dt", "mesh_path", "generated_mesh_params")
               and k not in RUN_KEYS}
        cfg.update(CHAIN_CFG, **extra)
        _, out[label], steps = delta_run(
            tmp, label, model, tiny["generated_mesh_params"], 3,
            floor=math.inf if extra else None, dt=tiny["dt"], **cfg)
        check_delta_steps(label, steps, 2)
    return out


def delta_block_records(records, b, U, A, U0, U0new, shape_tag=""):
    """K13 on one cell block, both forms, against its plain version
    (element.delta_plain / delta2_plain in float32), under the float32
    rule in the max norm: max|D_kernel - D_plain| <= 2 max|D_plain -
    D_f64| + 1e-12 max|D_f64|, D_f64 the same series in float64 (both are
    float32 series summed in float64 in other orders; the kernel folds
    each contribution's weighted coefficients into one float as it adds
    it, the plain version sums each order apart). Each record carries the
    time of the raw float64 K1/K2 residual of the block at U (raw_f64_ms),
    the work the delta stands in for. The bounds count the entries the
    block touches (U, A, U0 and, for delta2, U0new read, R written), its
    tables, and count_ops of one cell in Jet3 arithmetic times K."""
    import torch

    from vasp_tpu_torch.kernels import element

    K = b.dofs.shape[0]
    f32, f64 = torch.float32, torch.float64
    touched = int(torch.unique(b.dofs).numel())
    cell_args = [A[b.dofs[0]], U0[b.dofs[0]], b.Jinv[0], b.detJ[0],
                 b.vol[0]]
    cell_args = [a.to(f32) for a in cell_args]
    R = torch.zeros_like(U)
    raw_ms = cuda_ms(lambda: element.residual_cuda(b, U, U0, R), 20)
    for form, new in (("delta", None), ("delta2", U0new)):
        name = element.counter_name(b, form, False)

        def kernel(R, new=new):
            return element.block_delta(b, U, A, U0, R, new)

        def plain(R, dtype=f32, new=new):
            return element.delta_plain(b, U, A, U0, R, dtype, new)

        Dk = kernel(torch.zeros_like(U))
        # the plain version (seconds at full width) is timed once, in the
        # call that makes the reference
        Dp, plain_ms = cuda_ms_once(lambda: plain(torch.zeros_like(U)))
        D64 = plain(torch.zeros_like(U), f64)
        scale = float(D64.abs().max())
        err = float((Dk - Dp).abs().max())
        tol = (2 * float((Dp - D64).abs().max()) + 1e-12 * scale) / scale
        ops = count_ops(lambda: b.kernel.cell(*cell_args),
                        cell_args[:1 if new is None else 2]) * K
        print(f"    {name}: {ops / K:.0f} operations a cell in Jet3 "
              f"arithmetic, {count_ops(lambda: b.kernel.cell(*cell_args)):.0f}"
              f" in the float32 residual's (count_ops)")
        reads = 3 if new is None else 4
        records.add(name, (err / scale, err), cuda_ms(lambda: kernel(R), 20),
                    plain_ms,
                    (nbytes(b.dofs, b.Jinv, b.detJ, b.vol, b.rowmask)
                     + (reads + 1) * 8 * touched, ops, "f32"), tol,
                    f"K={K}{shape_tag} {form}", raw_f64_ms=raw_ms,
                    plain_rel_to_f64=float((Dp - D64).abs().max()) / scale)
        del Dk, Dp, D64


def delta_facet_records(records, fb, U, A):
    """K13's facet route (the K14 float32 residual on U - A) against its
    plain version by the rule of delta_block_records, both forms being
    the same launch under its two counters; raw_f64_ms is K14's float64
    residual at U; the bound counts U and A at the touched entries read,
    R written, the tables, and K14 float32's operations (the term is
    linear: its series is the residual of du alone)."""
    import torch

    from vasp_tpu_torch.kernels import facet

    K = fb.dofs.shape[0]
    touched = int(torch.unique(fb.dofs).numel())
    R = torch.zeros_like(U)
    raw_ms = cuda_ms(lambda: facet.residual_cuda(fb, U, R), 20)
    ops = count_ops(lambda: facet.residual_plain(fb, U - A, R,
                                                 torch.float32))
    wq, N2t = fb.kernel.tables(U.new_empty((), dtype=torch.float32))
    for name in ("robin_delta", "robin_delta2"):
        Dk = facet.delta_cuda(fb, U, A, torch.zeros_like(U), name)
        Dp = facet.delta_plain(fb, U, A, torch.zeros_like(U))
        D64 = facet.delta_plain(fb, U, A, torch.zeros_like(U), torch.float64)
        scale = float(D64.abs().max())
        err = float((Dk - Dp).abs().max())
        tol = (2 * float((Dp - D64).abs().max()) + 1e-12 * scale) / scale
        records.add(name, (err / scale, err),
                    cuda_ms(lambda: facet.delta_cuda(fb, U, A, R, name), 20),
                    cuda_ms(lambda: facet.delta_plain(fb, U, A, R), 5),
                    (nbytes(fb.dofs, fb.area2, wq, N2t) + 3 * 8 * touched,
                     ops, "f32"), tol, f"K={K} facets", raw_f64_ms=raw_ms,
                    plain_rel_to_f64=float((Dp - D64).abs().max()) / scale)


def _endgame_states(space, rng, d_scale):
    """(A, U0, U, U0new) on the card: A and U0 seeded at the models' scales
    (displacement d_scale), U = A + du and U0new = U0 + du0 with du, du0
    seeded at 1e-3 of those scales (an endgame-size step)."""
    import numpy as np
    import torch

    scale = np.concatenate([np.full(3 * space.n_p2, d_scale),
                            np.full(3 * space.n_p2, 1e-2),
                            np.full(space.n_p1, 1e2)])
    A, U0, du, du0 = (torch.as_tensor(rng.normal(size=space.ndof) * scale,
                                      device="cuda") for _ in range(4))
    return A, U0, A + 1e-3 * du, U0 + 1e-3 * du0


def phase_delta_kernels(records):
    """Phase 14c: K13 against its plain version at the 20,832-cell tube's
    shapes (the Laplace fluid and SVK solid blocks), the predeform tube's
    Mooney-Rivlin wall (strains ~1e-2) and the aneurysm tube's Robin
    facets (the facet route), each under delta and delta2, at seeded
    states; each timed beside its bound, its plain version and the raw
    float64 residual of the same state."""
    import gc

    import numpy as np
    import torch

    from vasp_tpu_torch.fem.assembly import FacetBlock

    print("[14c] K13 against its plain version, timed beside the raw "
          "float64 residual it stands in for:")
    rng = np.random.default_rng(14)
    system, _ = model_system("cylinder", FULL_MESH, "cuda")
    A, U0, U, U0new = _endgame_states(system.space, rng, 1e-6)
    for b in system.assembler.blocks:
        delta_block_records(records, b, U, A, U0, U0new)
    raw = sum(records[element_name]["raw_f64_ms"] for element_name in
              ("fluid_delta", "solid_delta"))
    k13 = sum(records[n]["ms"] for n in ("fluid_delta", "solid_delta"))
    print(f"    the tube's K13 delta {k13:.4f} ms against its raw float64 "
          f"K1 + K2 residual {raw:.4f} ms")
    del system, A, U0, U, U0new
    gc.collect()
    torch.cuda.empty_cache()

    system, _ = model_system("predeform", MODEL_MESH, "cuda")
    (b,) = [b for b in system.assembler.blocks if b.kernel.kind == "solid"]
    A, U0, U, U0new = _endgame_states(system.space, rng,
                                      1e-2 * system.mesh.hmin)
    delta_block_records(records, b, U, A, U0, U0new, " MR")
    del system, b, A, U0, U, U0new
    gc.collect()
    torch.cuda.empty_cache()

    system, _ = model_system("aneurysm", MODEL_MESH, "cuda")
    (fb,) = [b for b in system.assembler.blocks if isinstance(b, FacetBlock)]
    A, _, U, _ = _endgame_states(system.space, rng, 1e-6)
    delta_facet_records(records, fb, U, A)
    del system, fb, A, U
    gc.collect()
    torch.cuda.empty_cache()


def main():
    start = time.perf_counter()

    def elapsed(label):
        print(f"[time] {label} done at {time.perf_counter() - start:.1f} s",
              flush=True)

    phase_device()
    import gc

    import torch

    elapsed("phase 1")
    with tempfile.TemporaryDirectory(prefix="vasp_smoke_") as tmp:
        tmp = Path(tmp)
        records, extra = phase_kernels()
        elapsed("phase 2")
        refs = start_cpu_references(tmp)
        try:
            launches = phase_parity(tmp, refs)
        finally:
            stop_cpu_references(refs)
        elapsed("phase 3")
        launches["lu"], lu_splu_s = phase_lu(tmp)
        elapsed("phase 4")
        launches["gmres"], extra["k5_bound_ms_gmres"], _, gmres_steps = \
            phase_krylov(tmp, records, "gmres", "[5] cylinder, Newton-Krylov "
                         "path (linear_solver=gmres):", linear_solver="gmres")
        elapsed("phase 5")
        gc.collect()
        torch.cuda.empty_cache()
        launches["f32f"], extra["k5_bound_ms_f32f"], needs6, _ = \
            phase_krylov(tmp, records, "f32f", "[6] cylinder, bench "
                         "configuration (residual_dtype=f32f, "
                         "krylov_dtype=f32, gmres_tol=1e-3, jac_recompute=2, "
                         "atol=1e-6):", **BENCH_CFG)
        elapsed("phase 6")
        gc.collect()
        torch.cuda.empty_cache()
        series = {}
        for label, val in phase_models(tmp, records).items():
            if label.startswith("series_"):
                series[label[7:]] = val
                continue
            launches[label], extra[f"k5_bound_ms_{label}"] = val
        elapsed("phase 8")
        phases = (phase_predeform, phase_avf,
                  lambda tmp, records: phase_lifting(tmp, records,
                                                     lu_splu_s))
        for phase in phases:
            gc.collect()
            torch.cuda.empty_cache()
            for key, val in phase(tmp, records).items():
                if key.startswith("k5_"):
                    extra[f"k5_bound_ms_{key[3:]}"] = val
                elif key.startswith("series_"):
                    series[key[7:]] = val
                else:
                    launches[key] = val
            elapsed("phase 9" if phase is not phases[-1] else "phase 11")
    gc.collect()
    torch.cuda.empty_cache()
    launches["postproc"] = phase_postproc(records, series)
    elapsed("phase 10")
    del series
    gc.collect()
    torch.cuda.empty_cache()
    launches["bench"], extra["k5_bound_ms_bench"], needs7 = phase_bench(
        records)
    elapsed("phase 7")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="vasp_smoke_") as tmp:
        for key, val in phase_lowmem(Path(tmp), records, needs6,
                                     needs7).items():
            if key.startswith("k5_"):
                extra[f"k5_bound_ms_{key[3:]}"] = val
            else:
                launches[key] = val
    elapsed("phase 12")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="vasp_smoke_") as tmp:
        launches["newton_krylov"] = phase_newton_krylov(Path(tmp))
    elapsed("phase 13a")
    gc.collect()
    torch.cuda.empty_cache()
    launches["step_fn"], system, bc = phase_step_fn()
    elapsed("phase 13b")
    phase_new_kernels(records, system, bc)
    del system, bc
    elapsed("phase 13c")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="vasp_smoke_") as tmp:
        launches["delta_endgame"] = phase_delta_endgame(Path(tmp))
        elapsed("phase 14a")
        gc.collect()
        torch.cuda.empty_cache()
        launches["chain_anchor"] = phase_chain_anchor(Path(tmp))
        elapsed("phase 14b")
        gc.collect()
        torch.cuda.empty_cache()
        phase_delta_kernels(records)
        elapsed("phase 14c")
        launches.update(phase_delta_models(Path(tmp)))
        elapsed("phase 14d")
        gc.collect()
        torch.cuda.empty_cache()
        launches.update(phase_sharded(Path(tmp), gmres_steps[:3], extra))
        elapsed("phase 15b, 15d")

    kernels = []
    for name, (src, rep, path) in REPLACES.items():
        r = records[name]
        require(all(math.isfinite(r[k]) for k in ("max_abs_err", "ms",
                                                  "plain_ms", "bound_ms")),
                f"{name}: non-finite measurement")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[path][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], path=path,
            **{k: r[k] for k in ("variants", "rfft_ms", "host_copy_ms",
                                 "host_splu_ms", "chunk_steps",
                                 "one_launch_ms", "library_calls",
                                 "bound_ms_sinv_read_twice", "inverse_ms",
                                 "graph_ms", "graph_library_ms",
                                 "raw_f64_ms", "thomas_ms", "thomas_plain_ms",
                                 "thomas_bound_ms", "rank0_ms",
                                 "rank0_plain_ms", "rank0_bound_ms",
                                 "interior_ms", "interior_plain_ms",
                                 "interior_bound_ms")
               if k in r}))
    print(json.dumps(extra))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def cpu_reference_main(tmp, out):
    """The --cpu-reference entry: the phase-3 CPU sides that this process
    claims under `tmp`, into `out`."""
    import torch

    torch.set_num_threads(CPU_REFERENCE_THREADS)
    torch.save(cpu_references(Path(tmp)), out)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-reference"]:
        cpu_reference_main(sys.argv[2], sys.argv[3])
    else:
        main()
