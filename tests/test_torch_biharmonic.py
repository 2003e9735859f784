"""Biharmonic mesh lifting on the port (fem/biharmonic.py, K16 in
kernels/lifting.py, its wiring in FSISystem, the LU and the Krylov
solvers) against vasp_tpu on tests/test_biharmonic.py's tube (n_theta=8,
n_z=3) and configuration.

Tolerances, each with what was measured:
- the tables (Ke, p2dofs, minv, wfree, dmask, beta, beta_gamma) of bc1
  and bc2: 1e-14 relative, the same numpy code on the same mesh (measured
  0, bitwise);
- correction_apply on a seeded state: float64 1e-12 relative (measured
  1.9e-16 and 2.3e-16: the two scatter-adds sum in other orders), float32
  1e-6 (measured 1.4e-7 and 1.6e-7: float32 sums in other orders);
- correction_csr: the same pattern and values within 1e-14 (measured 0);
- one LU step for bc1 and for bc2: equal Newton counts, U within 1e-8
  relative (measured 4.7e-15 and 1.9e-14);
- one Krylov step (bc2, beta = 1e-2, as tests/test_biharmonic.py's
  iterative case): equal Newton counts, U within 3e-5 relative, the bound
  of test_torch_driver_gmres.py (measured 9.4e-7), and the GMRES restart
  cycles of each direction (vasp_tpu returns no inner count: its GMRES
  reports its cycles, read here by a debug callback) equal, except where
  vasp_tpu's GMRES spent its whole budget (gmres_maxiter / gmres_restart
  cycles) without reaching gmres_tol: there the port's must stay within
  the budget too. Measured: cycles [10, 5] in vasp_tpu, [7, 5] in the
  port. The first direction stalls at the float32 preconditioner's floor
  (the banded factors see only the correction's Laplace surrogate), where
  the count follows the two packages' float32 Jacobian roundings (a
  designed difference, ROADMAP queue 3); the Laplace case of the same
  step takes [2, 2] in both;
- biharmonic with sub-type volume, built through a config: the residual
  with the correction within 1e-12 of vasp_tpu's (measured 1.3e-16).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vasp_tpu.fem import biharmonic as jbih
from vasp_tpu.fem.dirichlet import DirichletBC as JaxBC
from vasp_tpu.mesh.generate import fsi_tube_mesh as jax_tube
from vasp_tpu.run.system import FSISystem as JaxSystem
from vasp_tpu_torch.fem import biharmonic as tbih
from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.kernels import element
from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
from vasp_tpu_torch.run.system import FSISystem
from _torch_small_fsi import random_state, torch_threads

# BLAS at its default thread count: test_krylov_step_matches_vasp_tpu holds
# vasp_tpu's GMRES cycles on a direction that stalls at its float32
# factors' floor, and the rounding of those factors (vasp_tpu's CPU LAPACK
# goes through numpy's BLAS) decides whether it spends its whole budget
_threads = torch_threads(2, blas=False)

MESH = dict(r_inner=0.001, r_outer=0.0013, length=0.003, n_theta=8,
            n_r_fluid=2, n_r_solid=1, n_z=3)
_E, _NU = 1e6, 0.45
_MU_S = _E / (2 * (1 + _NU))
CFG = dict(dt=0.001, theta=0.501, rho_f=1.025e3, mu_f=3.5e-3, dx_f_id=1,
           rho_s=1e3, mu_s=_MU_S, lambda_s=_NU * 2 * _MU_S / (1 - 2 * _NU),
           dx_s_id=2, material_model="StVenantKirchoff",
           extrapolation="biharmonic", quadrature_degree=2, atol=1e-10,
           rtol=1e-10, max_it=10, recompute=1, recompute_tstep=1,
           linear_solver="lu", verbose=False)
TABLES = ("Ke", "p2dofs", "minv", "wfree", "dmask")


def _bcs(space, BC):
    bcs = [BC(space.field_dofs("d", space.p2_dofs_on_facets(m)), 0.0)
           for m in (2, 3, 11)]
    bcs += [BC(space.field_dofs("v", space.p2_dofs_on_facets(m)), 0.0)
            for m in (2, 11)]
    return bcs


def _pair(sub_type, **extra):
    """Both packages' systems, bc sets and 100x interface loads."""
    cfg = dict(CFG, extrapolation_sub_type=sub_type, **extra)
    js = JaxSystem(jax_tube(**MESH), cfg)
    ts = FSISystem(fsi_tube_mesh(**MESH), dict(cfg, device="cpu"))
    jbc = js.make_bcset(_bcs(js.space, JaxBC))
    tbc = ts.make_bcset(_bcs(ts.space, DirichletBC))
    return ((js, jbc, 100.0 * jnp.asarray(js.interface_pressure_load())),
            (ts, tbc, 100.0 * ts.interface_pressure_load()))


@pytest.fixture(scope="module", params=["bc1", "bc2"])
def pair(request):
    return request.param, _pair(request.param)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_tables_match_vasp_tpu(pair):
    _, ((js, _, _), (ts, _, _)) = pair
    for key in TABLES:
        a, b = ts.lift[key].numpy(), np.asarray(js.lift[key])
        assert a.shape == b.shape, key
        assert _rel(a.astype(np.float64), b.astype(np.float64)) <= 1e-14, key
    assert ts.lift["p2dofs"].dtype == torch.int32
    assert ts.lift["wfree"].dtype == torch.bool
    for key in ("beta", "beta_gamma"):
        assert abs(ts.lift[key] - float(js.lift[key])) \
            <= 1e-14 * abs(float(js.lift[key])), key
    assert ts.lift["beta"] == 1.0
    # the fluid element kernel carries beta*gamma*L on the Laplace branch
    (fluid,) = [b.kernel for b in ts.assembler.blocks
                if b.kernel.kind == "fluid"]
    assert fluid.lift_coeff == ts.lift["beta_gamma"]
    assert element.cuda_params(fluid)[5:] == (0, 0, 0.0)


def test_tables_with_hmin_beta_match_vasp_tpu():
    """A direct call with beta=None takes beta = hmin^2 in both."""
    jm, tm = jax_tube(**MESH), fsi_tube_mesh(**MESH)
    js, ts = JaxSystem(jm, dict(CFG, extrapolation="laplace")), \
        FSISystem(tm, dict(CFG, extrapolation="laplace", device="cpu"))
    jl = jbih.build_biharmonic(jm, js.space, [1], sub_type="bc1")
    tl = tbih.build_biharmonic(tm, ts.space, [1], sub_type="bc1")
    assert tl["beta"] == float(jl["beta"]) == float(tm.hmin) ** 2
    assert abs(tl["beta_gamma"] - float(jl["beta_gamma"])) \
        <= 1e-14 * float(jl["beta_gamma"])
    for key in TABLES:
        assert _rel(tl[key].numpy().astype(np.float64),
                    np.asarray(jl[key]).astype(np.float64)) <= 1e-14


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)],
                         ids=["f64", "f32"])
def test_correction_apply_matches_vasp_tpu(pair, dtype, tol):
    _, ((js, _, _), (ts, _, _)) = pair
    U = random_state(ts.space, 3).astype(dtype)
    cj = np.asarray(jbih.correction_apply(js.lift, jnp.asarray(U)))
    ct = tbih.correction_apply(ts.lift, torch.as_tensor(U))
    assert ct.dtype == torch.float64 if dtype == np.float64 \
        else ct.dtype == torch.float32
    n_d = 3 * ts.space.n_p2
    assert not ct[n_d:].any() and ct[:n_d].any()
    assert _rel(ct.numpy().astype(np.float64), cj.astype(np.float64)) <= tol


def test_correction_csr_matches_vasp_tpu(pair):
    _, ((js, _, _), (ts, _, _)) = pair
    ndof = ts.space.ndof
    Cj = jbih.correction_csr(js.lift, ndof)
    Ct = tbih.correction_csr(ts.lift, ndof)
    Cj.sort_indices()
    Ct.sort_indices()
    assert np.array_equal(Ct.indptr, Cj.indptr)
    assert np.array_equal(Ct.indices, Cj.indices)
    assert _rel(Ct.data, Cj.data) <= 1e-14
    # and it is the matrix of correction_apply
    U = random_state(ts.space, 4)
    assert _rel(Ct @ U, tbih.correction_apply(
        ts.lift, torch.as_tensor(U)).numpy()) <= 1e-12


def test_lu_step_matches_vasp_tpu(pair):
    _, ((js, jbc, jload), (ts, tbc, tload)) = pair
    jU0, tU0 = js.zero_state(), ts.zero_state()
    jU, jinfo = js.make_solver(jbc).solve(jbc.apply(jU0, 0.001), jU0,
                                          t=0.001, tstep=1, load=jload)
    solver = ts.make_solver(tbc)
    assert solver.lift is ts.lift
    tU, tinfo = solver.solve(tbc.apply(tU0, 0.001), tU0, t=0.001, tstep=1,
                             load=tload)
    assert tinfo["converged"] and jinfo["converged"]
    assert tinfo["iterations"] == jinfo["iterations"]
    assert _rel(tU.numpy(), np.asarray(jU)) <= 1e-8


def test_krylov_step_matches_vasp_tpu(monkeypatch):
    """tests/test_biharmonic.py's iterative case (bc2, beta = 1e-2) on both
    steppers: the correction in the residual and in the matvec."""
    import vasp_tpu.fem.timestepper as jts
    import vasp_tpu_torch.fem.timestepper as tts
    from vasp_tpu.fem.timestepper import IterativeStepper as JaxStepper
    from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
    from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

    jcycles, tcycles = [], []
    jgmres, tgmres = jts.gmres, tts.gmres

    def jcounted(*args, **kw):
        y, info = jgmres(*args, **kw)
        jax.debug.callback(lambda n: jcycles.append(int(n)), info[1])
        return y, info

    def tcounted(*args, **kw):
        y, info = tgmres(*args, **kw)
        tcycles.append(int(info[1]))
        return y, info

    monkeypatch.setattr(jts, "gmres", jcounted)
    monkeypatch.setattr(tts, "gmres", tcounted)
    (js, jbc, jload), (ts, tbc, tload) = _pair("bc2", biharmonic_beta=1e-2)
    opts = dict(atol=1e-9, rtol=1e-9, max_it=10, gmres_tol=1e-8,
                gmres_restart=60, gmres_maxiter=600)
    jst = JaxStepper(js, jbc, JaxOptions(**opts), recompute_tstep=20)
    tst = IterativeStepper(ts, tbc, StepOptions(**opts), recompute_tstep=20)
    assert tst._lift is ts.lift
    jU, jstats = jst.step(js.zero_state(), jnp.asarray(jbc.values_at(0.001)),
                          jload, 1)
    tU, tstats = tst.step(ts.zero_state(),
                          torch.as_tensor(tbc.values_at(0.001)), tload, 1)
    assert tstats["iterations"] == int(jstats["iterations"]) >= 1
    assert tstats["residual"] <= 1e-9
    budget = opts["gmres_maxiter"] // opts["gmres_restart"]
    assert len(tcycles) == len(jcycles) == tstats["iterations"]
    for j, t in zip(jcycles, tcycles):
        assert t == j or (j == budget and t <= budget), (jcycles, tcycles)
    assert tst.gmres_cycles == sum(tcycles) and tst.gmres_inner > 0
    assert _rel(tU.numpy(), np.asarray(jU)) <= 3e-5


def test_biharmonic_volume_builds_through_config():
    """The biharmonic/volume combination (soft clamp plus the volume-
    weighted first L) is valid in vasp_tpu: built from a config, its
    residual with the correction agrees."""
    (js, _, _), (ts, _, _) = _pair("volume")
    (fluid,) = [b.kernel for b in ts.assembler.blocks
                if b.kernel.kind == "fluid"]
    assert (fluid.lift, fluid.lift_sub) == ("biharmonic", "volume")
    assert element.cuda_params(fluid)[5:] == (1, 0, 0.0)
    U = random_state(ts.space, 5)
    U0 = random_state(ts.space, 6)
    Rj = np.asarray(js.assembler.residual(jnp.asarray(U), jnp.asarray(U0))
                    + jbih.correction_apply(js.lift, jnp.asarray(U)))
    Ut = torch.as_tensor(U)
    Rt = ts.assembler.residual(Ut, torch.as_tensor(U0)) \
        + tbih.correction_apply(ts.lift, Ut)
    assert _rel(Rt.numpy(), Rj) <= 1e-12
