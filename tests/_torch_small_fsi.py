"""The small FSI tube of tests/test_banded.py built by both packages, for
the parity tests of the port's iterative path (tests/test_torch_*.py).

vasp_tpu and vasp_tpu_torch get the same mesh parameters, configuration
and boundary conditions, so their dof tables, masks and loads agree; the
inputs each test hands to both sides are made with numpy."""
import numpy as np

MESH = dict(r_inner=0.0015, r_outer=0.002, length=0.008, n_theta=8,
            n_r_fluid=2, n_r_solid=1, n_z=5)
_E, _NU = 1e6, 0.45
_MU_S = _E / (2 * (1 + _NU))
CFG = dict(dt=0.001, theta=0.501, rho_f=1.0e3, mu_f=3.5e-3, dx_f_id=1,
           rho_s=1e3, mu_s=_MU_S, lambda_s=_NU * 2 * _MU_S / (1 - 2 * _NU),
           dx_s_id=2, material_model="StVenantKirchoff",
           extrapolation="laplace", extrapolation_sub_type="constant",
           quadrature_degree=2)


def _bcs(space, DirichletBC):
    bcs = [DirichletBC(space.field_dofs("d", space.p2_dofs_on_facets(m)), 0.0)
           for m in (2, 3, 11)]
    bcs += [DirichletBC(space.field_dofs("v", space.p2_dofs_on_facets(m)),
                        0.0) for m in (2, 11)]
    return bcs


def build_pair():
    """((jax system, jax bc set), (torch system, torch bc set)); the torch
    side on the CPU."""
    from vasp_tpu.fem.dirichlet import DirichletBC as JBC
    from vasp_tpu.mesh.generate import fsi_tube_mesh as jax_tube
    from vasp_tpu.run.system import FSISystem as JaxSystem

    from vasp_tpu_torch.fem.dirichlet import DirichletBC
    from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
    from vasp_tpu_torch.run.system import FSISystem

    js = JaxSystem(jax_tube(**MESH), CFG)
    ts = FSISystem(fsi_tube_mesh(**MESH), dict(CFG, device="cpu"))
    jbc = js.make_bcset(_bcs(js.space, JBC))
    tbc = ts.make_bcset(_bcs(ts.space, DirichletBC))
    assert np.array_equal(np.asarray(jbc.mask), tbc.mask)
    return (js, jbc), (ts, tbc)


def random_state(space, seed):
    """A state at the tube's scales: displacement ~1 um, velocity ~1 cm/s,
    pressure ~100 Pa (numpy float64)."""
    scale = np.concatenate([np.full(3 * space.n_p2, 1e-6),
                            np.full(3 * space.n_p2, 1e-2),
                            np.full(space.n_p1, 1e2)])
    return np.random.default_rng(seed).normal(size=space.ndof) * scale
