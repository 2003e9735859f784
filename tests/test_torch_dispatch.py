"""Device and dispatch rules of vasp_tpu_torch: CPU tensors take the plain
versions, CUDA tensors launch a kernel or raise, device="cuda" without a
card raises, and configurations the CUDA kernels or the slice do not cover
are refused by name."""
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


@pytest.mark.parametrize("kernel,ok", [
    (forms.make_fluid_kernel(**FLUID, lift_sub="constant"), True),
    (forms.make_fluid_kernel(**FLUID, lift_sub="small_constant"), True),
    (forms.make_fluid_kernel(**FLUID, lift_sub="volume"), True),
    (forms.make_fluid_kernel(**FLUID, lift_sub="volume_change"), True),
    (forms.make_fluid_kernel(**FLUID, lift="elastic"), False),
    (forms.make_fluid_kernel(**FLUID, p_stab=0.1), False),
    (forms.make_solid_kernel(SVK, 1e-3, 0.501), True),
    (forms.make_solid_kernel(SVK, 1e-3, 0.501, gravity=[0, 0, -9.81]), False),
    (forms.make_solid_kernel(dict(SVK, material_model="MooneyRivlin"),
                             1e-3, 0.501), False),
], ids=["constant", "small_constant", "volume", "volume_change", "elastic",
        "p_stab", "svk", "gravity", "mooney_rivlin"])
def test_cuda_kernels_cover_their_configurations(kernel, ok):
    if ok:
        params = element.cuda_params(kernel)
        assert all(isinstance(p, (int, float)) for p in params)
    else:
        with pytest.raises(NotImplementedError, match="queue 1, item 10"):
            element.cuda_params(kernel)


def test_dispatch_refuses_other_devices(tiny_tube):
    system = FSISystem(tiny_tube, CFG)
    block = system.assembler.blocks[0]
    U = torch.zeros(system.space.ndof, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        element.block_residual(block, U, U, U)


@pytest.mark.parametrize("extra,item", [
    (dict(extrapolation="biharmonic"), 10),
    (dict(material_model="MooneyRivlin"), 10),
    (dict(n_devices=4), 13),
])
def test_unported_options_raise(tiny_tube, extra, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        FSISystem(tiny_tube, dict(CFG, **extra))


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


@pytest.mark.parametrize("extra,item", [
    (dict(residual_dtype="f32"), 14), (dict(precond="ras"), 14),
    (dict(chain_anchor=True), 14),
], ids=["f32", "ras", "chain_anchor"])
def test_unported_iterative_options_raise(tiny_tube, extra, item):
    """residual_dtype="f32" from a config keeps vasp_tpu's delta_endgame
    default (True), the jet Taylor-delta endgame, which is not ported."""
    system = FSISystem(tiny_tube, dict(CFG, linear_solver="gmres", **extra))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        system.make_solver(system.make_bcset([]))


@pytest.mark.parametrize("extra,item", [
    (dict(residual_dtype="f32", delta_endgame=True), 14),
    (dict(chain_anchor=True), 14), (dict(banded_factor_dtype="bf16"), 9),
    (dict(banded_factor_dtype="hybrid"), 9),
], ids=["f32_delta_endgame", "chain_anchor", "bf16", "hybrid"])
def test_unported_step_options_raise(extra, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        StepOptions(**extra)


@pytest.mark.parametrize("extra", [
    dict(residual_dtype="f32f"), dict(residual_dtype="mixed"),
    dict(residual_dtype="f32", delta_endgame=False),
    dict(jac_carry=True, recompute=2),
], ids=["f32f", "mixed", "f32_raw_endgame", "jac_carry"])
def test_ported_step_options_build(tiny_tube, extra):
    """The hybrid residual precisions and jac_carry build, as StepOptions
    and through a config (endgame_factor and chain_reanchor mapped as
    vasp_tpu maps them)."""
    assert StepOptions(**extra)
    cfg = dict(CFG, linear_solver="gmres", endgame_factor=3.0,
               chain_reanchor=2, **{k: v for k, v in extra.items()
                                    if k == "residual_dtype"})
    system = FSISystem(tiny_tube, cfg)
    solver = system.make_solver(system.make_bcset([]), **extra)
    assert isinstance(solver, IterativeNewtonSolver)
    assert (solver.opt.endgame_factor, solver.opt.chain_reanchor) == (3.0, 2)
    for k, v in extra.items():
        assert getattr(solver.opt, k) == v


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
        "elem_matvec", "ruiz_sweep", "ruiz_scale", "banded_assemble",
        "banded_apply", "banded_factorize_f64", "robin_residual",
        "robin_residual_f32", "robin_jacobian", "robin_jacobian_f32",
        "elem_matvec_36", "ruiz_sweep_36", "ruiz_scale_36"}
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
