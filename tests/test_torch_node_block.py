"""make_step_fn and its node-block preconditioner (K17,
kernels/nodeblock.py) against vasp_tpu's, on the small system of
tests/test_sharded_step.py (the single-chip reference of the sharded
step: a Robin facet block beside the cells, SVK wall, 150x the interface
pressure load) with its StepOptions.

The node blocks are fed the same scaled float64 element Jacobians in both
packages (the port's, at a seeded state, through the port's Ruiz scales);
vasp_tpu's summed and masked blocks are read by running its
build_node_block with the inverse an identity.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_small_fsi import random_state, torch_threads
from vasp_tpu.fem import scaling as jscaling
from vasp_tpu.fem import smallmat as jsmallmat
from vasp_tpu_torch.fem import scaling as tscaling
from vasp_tpu_torch.fem.smallmat import inv6
from vasp_tpu_torch.kernels import nodeblock as knb

_threads = torch_threads(2)
# tests/test_sharded_step.py's small system and step options
MESH = dict(r_inner=0.001, r_outer=0.0013, length=0.003, n_theta=8,
            n_r_fluid=2, n_r_solid=1, n_z=3)
_E, _NU = 1e6, 0.45
_MU_S = _E / (2 * (1 + _NU))
CFG = dict(dt=0.001, theta=0.501, rho_f=1.025e3, mu_f=3.5e-3, dx_f_id=1,
           rho_s=1e3, mu_s=_MU_S, lambda_s=_NU * 2 * _MU_S / (1 - 2 * _NU),
           dx_s_id=2, material_model="StVenantKirchoff",
           extrapolation="laplace", extrapolation_sub_type="constant",
           quadrature_degree=2, robin_bc=True, k_s=[1e5], c_s=[10],
           ds_s_id=[33])
OPTS = dict(atol=1e-10, rtol=1e-10, max_it=6, gmres_tol=1e-9,
            gmres_restart=120, gmres_maxiter=1200)


def _system(pkg):
    """(system, bc set, load) of test_sharded_step.py's small_system."""
    if pkg == "vasp_tpu":
        from vasp_tpu.fem.dirichlet import DirichletBC
        from vasp_tpu.mesh.generate import fsi_tube_mesh
        from vasp_tpu.run.system import FSISystem
        cfg = CFG
    else:
        from vasp_tpu_torch.fem.dirichlet import DirichletBC
        from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
        from vasp_tpu_torch.run.system import FSISystem
        cfg = dict(CFG, device="cpu")
    system = FSISystem(fsi_tube_mesh(**MESH), cfg)
    space = system.space
    bcs = [DirichletBC(space.field_dofs("d", space.p2_dofs_on_facets(m)),
                       0.0) for m in (2, 3, 11)]
    bcs += [DirichletBC(space.field_dofs("v", space.p2_dofs_on_facets(m)),
                        0.0) for m in (2, 11)]
    bc = system.make_bcset(bcs)
    return system, bc, 150.0 * system.interface_pressure_load()


@pytest.fixture(scope="module")
def systems():
    return _system("vasp_tpu"), _system("vasp_tpu_torch")


@pytest.fixture(scope="module")
def node_blocks(systems):
    """The same scaled Jacobians in both packages; each package's masked,
    regularized node blocks (the inverse an identity) and inverses."""
    (js, jbc, _), (ts, tbc, _) = systems
    space = ts.space
    U = torch.as_tensor(random_state(space, 0))
    U0 = torch.as_tensor(random_state(space, 1))
    mask = tbc.mask_on("cpu")
    jacs = ts.assembler.element_jacobians(U, U0)
    dr, dc = tscaling.ruiz_scales(ts.assembler.blocks, jacs, mask,
                                  space.ndof, sweeps=4)
    jacs_s = tscaling.scale_element_jacobians(ts.assembler.blocks, jacs, dr,
                                              dc)
    args = (space.n_p2, space.off_p, space.ndof)
    jj = [jnp.asarray(A.numpy()) for A in jacs_s]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsmallmat, "inv6", lambda m: m)
        mp.setattr(knb, "inv6", lambda m: m)
        out["jax_nb"] = np.asarray(jscaling.build_node_block(
            js.assembler.blocks, jj, jnp.asarray(jbc.mask), *args))
        out["port_nb"] = tscaling.build_node_block(
            ts.assembler.blocks, jacs_s, mask, *args).numpy()
    out["jax_pinv"] = np.asarray(jscaling.build_node_block(
        js.assembler.blocks, jj, jnp.asarray(jbc.mask), *args))
    out["port_pinv"] = tscaling.build_node_block(
        ts.assembler.blocks, jacs_s, mask, *args).numpy()
    return out


def _scale_err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_node_blocks_extract_matches_vasp_tpu(node_blocks):
    """K17's extract and bc masking (plain here): the summed node blocks
    within 1e-12 of their scale (float64 sums, possibly in another order;
    measured equal)."""
    assert _scale_err(node_blocks["port_nb"], node_blocks["jax_nb"]) <= 1e-12


def test_node_blocks_invert_matches_vasp_tpu(node_blocks):
    """inv6 against vasp_tpu's on the same masked blocks, and the whole
    build's inverses: 1e-12 of each node's largest entry (measured 1.1e-13;
    the blocks' cond is at most ~10 here)."""
    nb = node_blocks["jax_nb"]
    mine = inv6(torch.as_tensor(nb)).numpy()
    ref = np.asarray(jsmallmat.inv6(jnp.asarray(nb)))
    scale = np.abs(ref).max(axis=(1, 2))[:, None, None]
    assert (np.abs(mine - ref) / scale).max() <= 1e-12
    pinv, jpinv = node_blocks["port_pinv"], node_blocks["jax_pinv"]
    scale = np.abs(jpinv).max(axis=(1, 2))[:, None, None]
    assert (np.abs(pinv - jpinv) / scale).max() <= 1e-12


def test_node_block_apply_matches_vasp_tpu(systems, node_blocks):
    """K17's apply (plain here) on vasp_tpu's inverses: 1e-12 of scale,
    pressure copied through exactly."""
    ts = systems[1][0]
    space = ts.space
    r = np.random.default_rng(4).normal(size=space.ndof)
    P = node_blocks["jax_pinv"]
    yj = np.asarray(jscaling.apply_node_block(jnp.asarray(P), jnp.asarray(r),
                                              space.n_p2, space.off_p))
    yt = tscaling.apply_node_block(torch.as_tensor(P), torch.as_tensor(r),
                                   space.n_p2, space.off_p).numpy()
    assert _scale_err(yt, yj) <= 1e-12
    assert np.array_equal(yt[space.off_p:], r[space.off_p:])


def test_make_step_fn_matches_vasp_tpu(systems):
    """One step of both packages' make_step_fn (vasp_tpu's jitted, as
    tests/test_sharded_step.py runs it): the same Newton iterations and r0,
    the step converged, U within 1e-8 relative (measured 2.3e-9: GMRES to
    1e-9 on node-block preconditioners of Jacobians that agree to 1e-12)."""
    from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
    from vasp_tpu.fem.timestepper import make_step_fn as jax_make_step_fn
    from vasp_tpu_torch.fem.timestepper import StepOptions, make_step_fn

    (js, jbc, jload), (ts, tbc, tload) = systems
    layout = (ts.space.n_p2, ts.space.off_p)
    jstep = jax.jit(jax_make_step_fn(js.assembler, jbc.mask,
                                     JaxOptions(**OPTS), layout=layout))
    Uj, sj = jstep(js.zero_state(), jnp.asarray(jbc.values_at(0.001)),
                   jnp.asarray(jload))
    tstep = make_step_fn(ts.assembler, tbc.mask, StepOptions(**OPTS),
                         layout=layout)
    Ut, st = tstep(ts.zero_state(), torch.as_tensor(tbc.values_at(0.001)),
                   tload)
    Uj = np.asarray(Uj)
    assert st["iterations"] == int(sj["iterations"]) >= 1
    assert abs(st["r0"] - float(sj["r0"])) <= 1e-12 * float(sj["r0"])
    assert st["residual"] < 1e-9 * max(1.0, st["r0"])
    assert Ut.dtype == torch.float64 and torch.isfinite(Ut).all()
    assert np.linalg.norm(Ut.numpy() - Uj) <= 1e-8 * np.linalg.norm(Uj)
