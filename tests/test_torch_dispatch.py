"""Device and dispatch rules of vasp_tpu_torch: CPU tensors take the plain
versions, CUDA tensors launch a kernel or raise, device="cuda" without a
card raises, and configurations the CUDA kernels or the slice do not cover
are refused by name."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vasp_tpu_torch.device import resolve_device
from vasp_tpu_torch.fem import forms
from vasp_tpu_torch.fem.timestepper import IterativeNewtonSolver, StepOptions
from vasp_tpu_torch.kernels import build, element
from vasp_tpu_torch.run.system import FSISystem
from _torch_small_fsi import torch_threads

_threads = torch_threads(1)
CFG = dict(dt=1e-3, theta=0.501, rho_f=1e3, mu_f=3.5e-3, rho_s=1e3,
           mu_s=3e5, lambda_s=1e6, quadrature_degree=2, device="cpu")
FLUID = dict(rho_f=1e3, mu_f=3.5e-3, dt=1e-3, theta=0.501)
SVK = dict(material_model="StVenantKirchoff", rho_s=1e3, mu_s=3e5,
           lambda_s=1e6)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_card_raises(no_cuda, tiny_tube):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        FSISystem(tiny_tube, dict(CFG, device="cuda"))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kernel,tail", [
    (forms.make_fluid_kernel(**FLUID, lift_sub="constant"), (0, 0, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift_sub="small_constant"),
     (0, 0, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift_sub="volume"), (1, 0, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift_sub="volume_change"),
     (2, 0, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift="elastic"), (0, 1, 0.0)),
    (forms.make_fluid_kernel(**FLUID, p_stab=0.1), (0, 0, 0.1)),
    (forms.make_solid_kernel(SVK, 1e-3, 0.501), (0.0, 0.0, 0.0)),
    (forms.make_solid_kernel(SVK, 1e-3, 0.501, gravity=[0, 0, -9.81]),
     (0.0, 0.0, -9.81)),
    (forms.make_solid_kernel(dict(SVK, material_model="MooneyRivlin",
                                  C01=2e4, C10=0.0, C11=1.8e6),
                             1e-3, 0.501), (0.0, 0.0, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift="no_extrapolation"), (0, 2, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift="biharmonic", lift_sub="bc1"),
     (0, 0, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift="biharmonic", lift_sub="bc2"),
     (0, 0, 0.0)),
    (forms.make_fluid_kernel(**FLUID, lift="biharmonic", lift_sub="volume"),
     (1, 0, 0.0)),
], ids=["constant", "small_constant", "volume", "volume_change", "elastic",
        "p_stab", "svk", "gravity", "mooney_rivlin", "no_extrapolation",
        "biharmonic_bc1", "biharmonic_bc2", "biharmonic_volume"])
def test_cuda_kernels_cover_their_configurations(kernel, tail):
    """Every configuration of the plain forms has its CUDA parameters: the
    fluid's (lifting sub-type code, lifting mode, p_stab; biharmonic on the
    Laplace branch, bc1/bc2 with the constant coefficient), the solid's
    gravity last."""
    params = element.cuda_params(kernel)
    assert all(isinstance(p, (int, float)) for p in params)
    assert params[-3:] == tail


def test_mr_block_counts_under_its_own_name():
    """A Mooney-Rivlin block launches (and counts) the MR instances of
    K2/K3, an SVK block the SVK ones; the fluid has no material tag."""
    mr = forms.make_solid_kernel(dict(SVK, material_model="MooneyRivlin",
                                      C01=2e4, C10=0.0, C11=1.8e6),
                                 1e-3, 0.501)
    svk = forms.make_solid_kernel(SVK, 1e-3, 0.501)
    fluid = forms.make_fluid_kernel(**FLUID)
    names = [element.counter_name(SimpleNamespace(kernel=k), op, f32)
             for k in (mr, svk, fluid) for op in ("residual", "jacobian")
             for f32 in (False, True)]
    assert names == [
        "solid_residual_mr", "solid_residual_mr_f32", "solid_jacobian_mr",
        "solid_jacobian_mr_f32", "solid_residual", "solid_residual_f32",
        "solid_jacobian", "solid_jacobian_f32", "fluid_residual",
        "fluid_residual_f32", "fluid_jacobian", "fluid_jacobian_f32"]
    assert set(names) <= set(build.LAUNCHES)
    assert element.cuda_params(mr)[5:] == (1, 2e4, 0.0, 1.8e6, 0.0, 0.0, 0.0)
    assert element.cuda_params(svk)[5:] == (0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def test_lifting_blocks_count_under_their_own_names():
    """The elastic and the no-lifting fluid instances of K1/K3 count under
    their own names; the biharmonic fluid block is a Laplace one; K16
    counts per dtype."""
    from vasp_tpu_torch.kernels import lifting

    names = [element.counter_name(SimpleNamespace(
        kernel=forms.make_fluid_kernel(**FLUID, lift=lift)), op, f32)
        for lift in ("elastic", "no_extrapolation", "biharmonic")
        for op in ("residual", "jacobian") for f32 in (False, True)]
    assert names == [
        "fluid_residual_elastic", "fluid_residual_elastic_f32",
        "fluid_jacobian_elastic", "fluid_jacobian_elastic_f32",
        "fluid_residual_nolift", "fluid_residual_nolift_f32",
        "fluid_jacobian_nolift", "fluid_jacobian_nolift_f32",
        "fluid_residual", "fluid_residual_f32", "fluid_jacobian",
        "fluid_jacobian_f32"]
    lift_names = [lifting.counter_name(torch.zeros(1, dtype=dt))
                  for dt in (torch.float64, torch.float32)]
    assert lift_names == ["lift_correction", "lift_correction_f32"]
    assert set(names + lift_names) <= set(build.LAUNCHES)


def test_dispatch_refuses_other_devices(tiny_tube):
    system = FSISystem(tiny_tube, CFG)
    block = system.assembler.blocks[0]
    U = torch.zeros(system.space.ndof, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        element.block_residual(block, U, U, U)


# the id the n_devices case had beside the two biharmonic cases, which
# went with the refusal they tested
@pytest.mark.parametrize("extra,item", [(dict(n_devices=4), 13)],
                         ids=["extra2-13"])
def test_unported_options_raise(tiny_tube, extra, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        FSISystem(tiny_tube, dict(CFG, **extra))


@pytest.mark.parametrize("sub_type", ["bc1", "volume"])
def test_biharmonic_options_build(tiny_tube, sub_type):
    """extrapolation="biharmonic" builds on the CPU: the correction's
    tables on the system's device, the fluid block on the Laplace branch
    with beta*gamma, both solvers holding the tables."""
    cfg = dict(CFG, extrapolation="biharmonic",
               extrapolation_sub_type=sub_type, biharmonic_beta=0.5)
    system = FSISystem(tiny_tube, cfg)
    lift = system.lift
    assert lift["beta"] == 0.5 and lift["beta_gamma"] > 0.0
    assert lift["Ke"].device.type == "cpu"
    (fluid,) = [b.kernel for b in system.assembler.blocks
                if b.kernel.kind == "fluid"]
    assert fluid.lift_coeff == lift["beta_gamma"]
    assert element.cuda_params(fluid)[5] == (1 if sub_type == "volume" else 0)
    bcs = system.make_bcset([])
    assert system.make_solver(bcs).lift is lift
    gmres = FSISystem(tiny_tube, dict(cfg, linear_solver="gmres"))
    assert gmres.make_solver(gmres.make_bcset([])).stepper._lift is not None


def test_lift_correction_refuses_other_devices(tiny_tube):
    from vasp_tpu_torch.kernels import lifting

    system = FSISystem(tiny_tube, dict(CFG, extrapolation="biharmonic"))
    U = torch.zeros(system.space.ndof, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        lifting.correction_apply(system.lift, U)


@pytest.mark.parametrize("stage", ["hemodynamics", "stress_strain"])
def test_multi_device_postprocessing_raises(tmp_path, stage):
    """vasp_tpu's n_devices > 1 postprocessing (timesteps sharded over
    devices) is refused by its ROADMAP item before any file is read."""
    from vasp_tpu_torch.postprocessing.fields import (
        hemodynamics,
        stress_strain,
    )

    fn = {"hemodynamics": hemodynamics.compute_hemodynamics,
          "stress_strain": stress_strain.compute_stress_strain}[stage]
    with pytest.raises(NotImplementedError, match="item 13"):
        fn(tmp_path, n_devices=2, device="cpu")


@pytest.mark.parametrize("stage", ["hemodynamics", "stress_strain"])
def test_postprocessing_on_cuda_without_card_raises(no_cuda, tmp_path,
                                                    stage):
    from vasp_tpu_torch.postprocessing.fields import (
        hemodynamics,
        stress_strain,
    )

    fn = {"hemodynamics": hemodynamics.compute_hemodynamics,
          "stress_strain": stress_strain.compute_stress_strain}[stage]
    with pytest.raises(RuntimeError, match="cuda"):
        fn(tmp_path)


def test_postprocessing_kernels_refuse_other_devices():
    from vasp_tpu_torch.kernels import postproc

    A = torch.zeros((2, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        postproc.max_eig(A)


@pytest.mark.parametrize("lin", ["gmres", "iterative", "ras"])
def test_iterative_solvers_raise(tiny_tube, lin):
    """The three iterative names build the Newton-Krylov solver with
    vasp_tpu's defaults (they raised before it was ported; the name is
    kept)."""
    system = FSISystem(tiny_tube, dict(CFG, linear_solver=lin))
    solver = system.make_solver(system.make_bcset([]))
    assert isinstance(solver, IterativeNewtonSolver)
    opt = solver.opt
    assert (opt.precond, opt.jac_dtype, opt.krylov_dtype,
            opt.residual_dtype, opt.recompute) == ("banded", "f32", None,
                                                   None, 1)
    assert solver.stepper.recompute_tstep == 20
    assert solver.stepper._bpat.nb >= 1


@pytest.mark.parametrize("lin", ["krylov", "schwarz"])
def test_newton_solver_krylov_branch_builds(tiny_tube, lin):
    """A linear_solver outside lu, mumps, gmres, iterative and ras reaches
    NewtonSolver's Krylov branch (element-block Schwarz and GMRES) with
    vasp_tpu's defaults, from a config and from make_solver's keyword; its
    preconditioner builds on the plain versions (no kernel launch)."""
    from vasp_tpu_torch.fem.solver import NewtonSolver

    system = FSISystem(tiny_tube, dict(CFG, linear_solver=lin))
    bcs = system.make_bcset([])
    for solver in (system.make_solver(bcs),
                   FSISystem(tiny_tube, CFG).make_solver(
                       bcs, linear_solver=lin)):
        assert isinstance(solver, NewtonSolver)
        opt = solver.opt
        assert (opt.linear_solver, opt.gmres_tol, opt.gmres_restart,
                opt.gmres_maxiter) == (lin, 1e-4, 50, 400)
    build.reset_launch_counts()
    U = system.zero_state()
    solver._rebuild(U, U, 1)
    assert solver.state.lu is None
    assert [P.shape for P in solver.state.pinv] == [
        b.dofs.shape + b.dofs.shape[1:] for b in solver.asm.blocks]
    assert float(solver.state.multiplicity.min()) >= 1.0
    assert not any(build.LAUNCHES.values())


@pytest.mark.parametrize("extra,item", [
    (dict(residual_dtype="f32"), 14), (dict(chain_anchor=True), 14),
], ids=["f32", "chain_anchor"])
def test_unported_iterative_options_raise(tiny_tube, extra, item):
    """residual_dtype="f32" from a config keeps vasp_tpu's delta_endgame
    default (True), the jet Taylor-delta endgame, which is not ported."""
    system = FSISystem(tiny_tube, dict(CFG, linear_solver="gmres", **extra))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        system.make_solver(system.make_bcset([]))


@pytest.mark.parametrize("extra,item", [
    (dict(residual_dtype="f32", delta_endgame=True), 14),
    (dict(chain_anchor=True), 14),
], ids=["f32_delta_endgame", "chain_anchor"])
def test_unported_step_options_raise(extra, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        StepOptions(**extra)


@pytest.mark.parametrize("extra", [
    dict(residual_dtype="f32f"), dict(residual_dtype="mixed"),
    dict(residual_dtype="f32", delta_endgame=False),
    dict(jac_carry=True, recompute=2), dict(precond="ras"),
    dict(banded_factor_dtype="bf16"), dict(banded_factor_dtype="hybrid"),
], ids=["f32f", "mixed", "f32_raw_endgame", "jac_carry", "ras", "bf16",
        "hybrid"])
def test_ported_step_options_build(tiny_tube, extra):
    """The hybrid residual precisions, jac_carry, the RAS preconditioner
    and the bf16/hybrid banded factor storage build, as StepOptions and
    through a config (residual_dtype and precond as config keys,
    endgame_factor and chain_reanchor mapped as vasp_tpu maps them); with
    the host's free memory the banded ones take the full layout."""
    assert StepOptions(**extra)
    cfg = dict(CFG, linear_solver="gmres", endgame_factor=3.0,
               chain_reanchor=2, **{k: v for k, v in extra.items()
                                    if k in ("residual_dtype", "precond")})
    system = FSISystem(tiny_tube, cfg)
    solver = system.make_solver(
        system.make_bcset([]), **{k: v for k, v in extra.items()
                                  if k != "precond"})
    assert isinstance(solver, IterativeNewtonSolver)
    assert (solver.opt.endgame_factor, solver.opt.chain_reanchor) == (3.0, 2)
    for k, v in extra.items():
        assert getattr(solver.opt, k) == v
    layout = solver.stepper.layout
    assert (layout is None) == (solver.opt.precond == "ras")
    assert layout is None or layout.layout == "full"


def test_unknown_residual_dtype_is_refused():
    with pytest.raises(ValueError, match="residual_dtype"):
        StepOptions(residual_dtype="f16")


def test_build_is_keyed_by_source_hash_and_counts_start_at_zero():
    h = build._source_hash()
    assert len(h) == 16 and h == build._source_hash()
    assert set(build.LAUNCHES) == {
        "fluid_residual", "solid_residual", "fluid_residual_f32",
        "solid_residual_f32", "fluid_jacobian",
        "solid_jacobian", "fluid_jacobian_f32", "solid_jacobian_f32",
        "dg0_project_speed", "integrate_p2_dot_n", "dg0_project_jacobian",
        "solid_residual_mr", "solid_residual_mr_f32", "solid_jacobian_mr",
        "solid_jacobian_mr_f32",
        "elem_matvec", "ruiz_sweep", "ruiz_scale", "banded_assemble",
        "banded_apply", "banded_factorize_f64", "robin_residual",
        "robin_residual_f32", "robin_jacobian", "robin_jacobian_f32",
        "elem_matvec_36", "ruiz_sweep_36", "ruiz_scale_36", "wss_load",
        "stress_strain_svk", "stress_strain_mr", "max_eig",
        "spectral_power", "fluid_residual_elastic",
        "fluid_residual_elastic_f32", "fluid_jacobian_elastic",
        "fluid_jacobian_elastic_f32", "fluid_residual_nolift",
        "fluid_residual_nolift_f32", "fluid_jacobian_nolift",
        "fluid_jacobian_nolift_f32", "lift_correction",
        "lift_correction_f32", "banded_apply_hybrid", "banded_apply_bf16",
        "banded_apply_lowmem_bf16", "banded_apply_lowmem_f32",
        "ruiz_sweep_f64", "ruiz_sweep_36_f64", "ras_apply", "ras_apply_f32",
        "schwarz_build", "schwarz_build_36", "schwarz_apply",
        "schwarz_apply_36", "schwarz_divide", "node_block_extract",
        "node_block_invert", "node_block_apply", "ruiz_scale_f64",
        "ruiz_scale_36_f64"}
    build.reset_launch_counts()
    assert not any(build.LAUNCHES.values())


def test_cpu_path_launches_no_kernel(tiny_tube):
    build.reset_launch_counts()
    system = FSISystem(tiny_tube, CFG)
    U = torch.as_tensor(np.random.default_rng(0).normal(
        size=system.space.ndof) * 1e-6)
    R = system.assembler.residual(U, U)
    assert R.dtype == torch.float64 and torch.isfinite(R).all()
    assert not any(build.LAUNCHES.values())
