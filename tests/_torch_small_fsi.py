"""The small FSI tube of tests/test_banded.py built by both packages, for
the parity tests of the port's iterative path (tests/test_torch_*.py).

vasp_tpu and vasp_tpu_torch get the same mesh parameters, configuration
and boundary conditions, so their dof tables, masks and loads agree; the
inputs each test hands to both sides are made with numpy.

Also what the stepper parity tests share: both steppers driven through
the same steps (run_steps), the same damage of both packages' banded
factors (damage_sinv), the ladder tiers a step printed (printed_tiers),
the torch thread count of the port's test modules (torch_threads), a
canonical order of a mesh's cells or facets (canonical_entities), and one
RCM ordering for both packages in a test process (same_rcm)."""
import fcntl
import io
import os
import subprocess
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

MESH = dict(r_inner=0.0015, r_outer=0.002, length=0.008, n_theta=8,
            n_r_fluid=2, n_r_solid=1, n_z=5)
# its first 3 layers (3,838 dofs, 3 banded blocks): the preconditioner
# layouts' and RAS's parity runs, each of which compiles vasp_tpu's stepper
SHORT_MESH = dict(MESH, n_z=3, length=0.0048)
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


_SAME_RCM = []


def same_rcm():
    """Make vasp_tpu take its native RCM ordering in this process, as the
    port does, or fail saying which package took which.

    vasp_tpu builds vasp_tpu/native/libmeshcore.so in place at first use
    (its Makefile writes the final name directly) and, where the build or
    the load fails, keeps scipy's RCM for the life of the process. Under
    pytest-xdist one worker can see another's half-written library; the
    two orderings give banded patterns of different widths on the same
    tube (c = 1,656 natively, 1,712 by scipy's RCM on MESH). So, once per
    process and under a file lock, the library in place is kept where it
    loads (tried in a child process: mapping a library that another
    process is still writing can kill the process that maps it); else it
    is built by its Makefile into a temporary directory and renamed into
    place. Then vasp_tpu's cached failure, if any, is reset and the
    library loaded. Nothing of vasp_tpu is edited."""
    if _SAME_RCM:
        return
    from vasp_tpu import native as jnative
    from vasp_tpu_torch import native as tnative

    port_native = tnative._library() is not None
    if port_native and jnative._LIB is None:
        so = jnative._DIR / "libmeshcore.so"
        tnative.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(tnative.BUILD_DIR / "libmeshcore.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            loads = so.exists() and subprocess.run(
                [sys.executable, "-c",
                 "import ctypes, sys; ctypes.CDLL(sys.argv[1])", str(so)],
                capture_output=True, timeout=60).returncode == 0
            if not loads:
                with tempfile.TemporaryDirectory(
                        dir=tnative.BUILD_DIR) as tmp:
                    build = subprocess.run(
                        ["make", "-s", "-B", "-C", tmp, "-f",
                         str(jnative._DIR / "Makefile"),
                         f"VPATH={jnative._DIR}", so.name],
                        capture_output=True, text=True, timeout=600)
                    assert build.returncode == 0, (
                        f"make could not build vasp_tpu's {so.name}: "
                        f"{build.stderr}")
                    os.replace(Path(tmp) / so.name, so)
            jnative._TRIED, jnative._LIB = False, None
            jnative._load()
    assert jnative.available() == port_native, (
        f"the two packages take different RCM orderings in this process: "
        f"vasp_tpu {'native' if jnative.available() else 'scipy'}, the "
        f"port {'native' if port_native else 'scipy'}")
    _SAME_RCM.append(True)


def build_pair(mesh=MESH):
    """((jax system, jax bc set), (torch system, torch bc set)) on the tube
    of `mesh`'s parameters; the torch side on the CPU."""
    same_rcm()
    from vasp_tpu.fem.dirichlet import DirichletBC as JBC
    from vasp_tpu.mesh.generate import fsi_tube_mesh as jax_tube
    from vasp_tpu.run.system import FSISystem as JaxSystem

    from vasp_tpu_torch.fem.dirichlet import DirichletBC
    from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
    from vasp_tpu_torch.run.system import FSISystem

    js = JaxSystem(jax_tube(**mesh), CFG)
    ts = FSISystem(fsi_tube_mesh(**mesh), dict(CFG, device="cpu"))
    jbc = js.make_bcset(_bcs(js.space, JBC))
    tbc = ts.make_bcset(_bcs(ts.space, DirichletBC))
    assert np.array_equal(np.asarray(jbc.mask), tbc.mask)
    return (js, jbc), (ts, tbc)


def loaded_pair(mesh=MESH):
    """build_pair(mesh) with each side's 150x interface pressure load and
    its bc values at t = 1e-3: ((jax system, bc set, load, bc values),
    (torch system, bc set, load, bc values))."""
    import jax.numpy as jnp

    (js, jbc), (ts, tbc) = build_pair(mesh)
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


def canonical_entities(rows, markers=None):
    """A mesh's cells or facets (with their markers, if given) in a
    canonical order: each row's vertices sorted, the rows sorted. vasp_tpu
    lists facets in the order of its native facet builder where that
    library loads, the port in the order of the numpy one."""
    rows = np.sort(np.asarray(rows), axis=1)
    if markers is not None:
        rows = np.column_stack([rows, markers])
    return rows[np.lexsort(rows.T[::-1])]


def torch_threads(n, blas=True):
    """An autouse module-scoped fixture that runs a test module's tests at
    n torch threads and, with blas, n BLAS threads for numpy and scipy,
    after same_rcm(), and restores the counts after them (under pytest -n
    6 on 8 cores, BLAS at its default of one thread per core in every
    worker oversubscribes the host); bind it to a module name
    (``_threads = torch_threads(2)``). A count set when a module is
    imported would not hold: a pytest-xdist worker imports every test
    module at collection, so the last import's count would win for all.
    blas=False leaves BLAS at its default, for a module whose vasp_tpu
    side is held to counts that its float32 LAPACK factors' rounding
    decides (vasp_tpu's CPU LAPACK calls go through the same BLAS)."""

    @pytest.fixture(autouse=True, scope="module")
    def _torch_threads():
        from threadpoolctl import threadpool_limits

        same_rcm()
        old = torch.get_num_threads()
        torch.set_num_threads(n)
        with threadpool_limits(limits=n if blas else None, user_api="blas"):
            yield
        torch.set_num_threads(old)

    return _torch_threads
