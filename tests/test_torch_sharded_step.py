"""make_sharded_step (parallel/shard.py: replicated state, element blocks
sharded over the ranks, the partial residuals, matvecs, Ruiz maxima and
node blocks combined by all-reduce) on 4 gloo ranks, against vasp_tpu's
make_sharded_step on 4 of the virtual CPU devices of tests/conftest.py and
against the port's single-device make_step_fn, on tests/test_sharded_step.py's
small system with its step options.

Checks, as tests/test_torch_node_block.py holds make_step_fn to vasp_tpu's:
the same Newton iterations and r0 (1e-12 relative: float64 sums in another
order), the step converged, U within 1e-8 relative (GMRES to 1e-9 on
node-block preconditioners whose Jacobians agree to 1e-12), and every
rank holding the same U."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import SMALL, STEP_OPTS, sharded_step_world, \
    start_world, tube_system
from _torch_small_fsi import same_rcm, torch_threads

_threads = torch_threads(2)
N = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(vasp_tpu's sharded U and stats, the port's single-device U and
    stats, the ranks' results)."""
    same_rcm()
    from vasp_tpu.fem.dirichlet import DirichletBC
    from vasp_tpu.fem.timestepper import StepOptions as JaxOptions
    from vasp_tpu.mesh.generate import fsi_tube_mesh
    from vasp_tpu.parallel.shard import build_device_mesh, make_sharded_step
    from vasp_tpu.run.system import FSISystem
    from vasp_tpu_torch.fem.timestepper import StepOptions, make_step_fn

    # the ranks run while vasp_tpu and the single-device step do
    ranks = start_world(N, sharded_step_world,
                        tmp_path_factory.mktemp("sharded_step"))
    js, jbc, jload = tube_system(SMALL, DirichletBC=DirichletBC,
                                 FSISystem=FSISystem,
                                 fsi_tube_mesh=fsi_tube_mesh)
    jstep, _ = make_sharded_step(js, jbc.mask, JaxOptions(**STEP_OPTS),
                                 mesh=build_device_mesh(N))
    Uj, sj = jstep(js.zero_state(), jnp.asarray(jbc.values_at(0.001)),
                   jnp.asarray(jload))
    ts, tbc, tload = tube_system(SMALL)
    single = make_step_fn(ts.assembler, tbc.mask, StepOptions(**STEP_OPTS),
                          layout=(ts.space.n_p2, ts.space.off_p))
    Us, ss = single(ts.zero_state(), torch.as_tensor(tbc.values_at(0.001)),
                    tload)
    return (np.asarray(Uj), jax.tree.map(float, sj)), (Us, ss), ranks()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_ranks_hold_the_same_state(runs):
    _, _, ranks = runs
    assert [r["rank"] for r in ranks] == list(range(N))
    for r in ranks:
        assert r["n"] == N
        assert torch.equal(r["U"], ranks[0]["U"])
        assert r["stats"] == ranks[0]["stats"]


@pytest.mark.parametrize("reference", ["vasp_tpu_sharded", "port_single"])
def test_sharded_step_matches(runs, reference):
    (Uj, sj), (Us, ss), ranks = runs
    want_U, want = ((Uj, sj) if reference == "vasp_tpu_sharded"
                    else (Us.numpy(), ss))
    got = ranks[0]["stats"]
    U = ranks[0]["U"]
    assert U.dtype == torch.float64 and torch.isfinite(U).all()
    assert got["iterations"] == int(want["iterations"]) >= 1
    assert abs(got["r0"] - float(want["r0"])) <= 1e-12 * float(want["r0"])
    assert got["residual"] < 1e-9 * max(1.0, got["r0"])
    assert _rel(U.numpy(), want_U) <= 1e-8
