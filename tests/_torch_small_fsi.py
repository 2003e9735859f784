"""The small FSI tube of tests/test_banded.py built by both packages, for
the parity tests of the port's iterative path (tests/test_torch_*.py).

vasp_tpu and vasp_tpu_torch get the same mesh parameters, configuration
and boundary conditions, so their dof tables, masks and loads agree; the
inputs each test hands to both sides are made with numpy.

Also what the stepper parity tests share: both steppers driven through
the same steps (run_steps), the same damage of both packages' banded
factors (damage_sinv), the ladder tiers a step printed (printed_tiers),
and the torch thread count of the port's test modules (torch_threads)."""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

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


def loaded_pair():
    """build_pair() with each side's 150x interface pressure load and its bc
    values at t = 1e-3: ((jax system, bc set, load, bc values), (torch
    system, bc set, load, bc values))."""
    import jax.numpy as jnp

    (js, jbc), (ts, tbc) = build_pair()
    jload = 150.0 * jnp.asarray(js.interface_pressure_load())
    tload = 150.0 * ts.interface_pressure_load()
    jbcv = jnp.asarray(jbc.values_at(0.001))
    tbcv = torch.as_tensor(tbc.values_at(0.001))
    return (js, jbc, jload, jbcv), (ts, tbc, tload, tbcv)


def run_steps(pair, opts, loads, recompute_tstep=20):
    """Both packages' IterativeStepper with StepOptions(**opts) through the
    steps 1, 2, ... under the given load scales; returns the port's stepper
    and per step (jax U numpy, jax stats, port U, port stats, jax carry
    age, port carry age)."""
    from vasp_tpu.fem.timestepper import IterativeStepper as JaxStepper
    from vasp_tpu.fem.timestepper import StepOptions as JaxOptions

    from vasp_tpu_torch.fem.timestepper import IterativeStepper, StepOptions

    (js, jbc, jload, jbcv), (ts, tbc, tload, tbcv) = pair
    jst = JaxStepper(js, jbc, JaxOptions(**opts),
                     recompute_tstep=recompute_tstep)
    tst = IterativeStepper(ts, tbc, StepOptions(**opts),
                           recompute_tstep=recompute_tstep)
    jU, tU = js.zero_state(), ts.zero_state()
    out = []
    for tstep, scale in enumerate(loads, start=1):
        jU, jstats = jst.step(jU, jbcv, scale * jload, tstep)
        tU, tstats = tst.step(tU, tbcv, scale * tload, tstep)
        ages = [None if c is None else int(c[1])
                for c in (jst._jac_carry, tst._jac_carry)]
        out.append((np.asarray(jU), jstats, tU, tstats, *ages))
    return tst, out


def damage_sinv(jst, tst, seed=0, scale=5.0):
    """The same random damage of both steppers' Sinv: every entry scaled by
    1 + scale u, u uniform in [-1, 1] (as tests/test_iterative_stepper.py
    injects it)."""
    import jax.numpy as jnp

    first = np.asarray(jst._pinv[0])
    noise = np.random.default_rng(seed).uniform(-1.0, 1.0, first.shape)
    jst._pinv = (jnp.asarray(first * (1.0 + scale * noise),
                             dtype=first.dtype), *jst._pinv[1:])
    Sinv, H, G = tst._pinv
    tst._pinv = (Sinv * (1.0 + scale * torch.as_tensor(noise,
                                                       dtype=Sinv.dtype)),
                 H, G)


# the tier each printed ladder line of either package announces
_TIER_LINES = {"escalating to f64 factorization": "f64_factors",
               "retrying with exact residuals": "fine_retry",
               "escalating to f64 Jacobians": "exact",
               "rebuilding preconditioner at the current state":
                   "exact_rebuild"}


def quiet_step(st, *args):
    """st.step(*args) with its printed lines captured: (U, stats, tiers
    printed)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        U, stats = st.step(*args)
    tiers = [tier for line in buf.getvalue().splitlines()
             if line.startswith("Newton:")
             for key, tier in _TIER_LINES.items() if key in line]
    return U, stats, tiers


def random_state(space, seed):
    """A state at the tube's scales: displacement ~1 um, velocity ~1 cm/s,
    pressure ~100 Pa (numpy float64)."""
    scale = np.concatenate([np.full(3 * space.n_p2, 1e-6),
                            np.full(3 * space.n_p2, 1e-2),
                            np.full(space.n_p1, 1e2)])
    return np.random.default_rng(seed).normal(size=space.ndof) * scale


def torch_threads(n):
    """An autouse module-scoped fixture that runs a test module's tests at
    n torch threads and restores the count after them; bind it to a module
    name (``_threads = torch_threads(2)``). A count set when a module is
    imported would not hold: a pytest-xdist worker imports every test
    module at collection, so the last import's count would win for all."""

    @pytest.fixture(autouse=True, scope="module")
    def _torch_threads():
        old = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(old)

    return _torch_threads
