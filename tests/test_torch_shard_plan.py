"""The sharded path's host setup and exchanges: build_shard_plan and
partition_blocks (parallel/banded_shard.py, host numpy copied from
vasp_tpu) against vasp_tpu's on tests/test_banded_shard.py's tube (Robin
facets on) at 2 and 4 shards, exactly; and every Collectives operation
(parallel/comm.py) on 2 and 4 gloo ranks against its single-process
definition (ppermute's and psum's semantics), exactly: the exchanges move
values untouched and the sums run on integer-valued floats; and the card
each rank takes and makes current."""
import numpy as np
import pytest
import torch

from _torch_dist import comm_ops, rank_devices, run_world, tube_system
from _torch_small_fsi import same_rcm, torch_threads
from vasp_tpu_torch.parallel.banded_shard import (
    build_shard_plan,
    partition_blocks,
)

_threads = torch_threads(2)


@pytest.fixture(scope="module")
def systems():
    same_rcm()
    from vasp_tpu.fem.dirichlet import DirichletBC
    from vasp_tpu.mesh.generate import fsi_tube_mesh
    from vasp_tpu.run.system import FSISystem

    js = tube_system(DirichletBC=DirichletBC, FSISystem=FSISystem,
                     fsi_tube_mesh=fsi_tube_mesh)[0]
    return js, tube_system()[0]


@pytest.mark.parametrize("n", [2, 4])
def test_plan_and_partition_match_vasp_tpu(systems, n):
    from vasp_tpu.parallel import banded_shard as jshard

    js, ts = systems
    block_dofs = [b.dofs.numpy() for b in ts.assembler.blocks]
    jplan = jshard.build_shard_plan(block_dofs, js.assembler.ndof, n)
    tplan = build_shard_plan(block_dofs, ts.assembler.ndof, n)
    for key in ("c", "nb_loc", "span", "n", "ndof", "npad"):
        assert getattr(tplan, key) == getattr(jplan, key), key
    np.testing.assert_array_equal(tplan.perm, jplan.perm)
    np.testing.assert_array_equal(tplan.iperm, jplan.iperm)
    jskel, jarrays = jshard.partition_blocks(js, jplan)
    tskel, tarrays = partition_blocks(ts, tplan)
    assert [s[:2] for s in tskel] == [s[:2] for s in jskel]
    assert [s[0] for s in tskel] == ["cell", "cell", "facet"]
    for (kind, _, _), ja, ta in zip(jskel, jarrays, tarrays):
        assert sorted(ta) == sorted(ja)
        for key, want in ja.items():
            assert ta[key].dtype == want.dtype, key
            assert ta[key].shape == want.shape, key
        if kind == "facet":
            # vasp_tpu lists facets in its native facet builder's order,
            # the port in numpy's: each shard's rows are the same set
            for dev in range(n):
                rows = [np.column_stack([a["dofs"][dev], a["area2"][dev]])
                        for a in (ta, ja)]
                np.testing.assert_array_equal(
                    *(r[np.lexsort(r.T[::-1])] for r in rows))
            continue
        for key, want in ja.items():
            np.testing.assert_array_equal(ta[key], want)


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_their_definitions(tmp_path, n):
    span, c = 24, 8
    out = run_world(n, comm_ops, tmp_path, span, c)
    ints = [o["inputs"][0] for o in out]
    xs = [o["inputs"][1] for o in out]
    ys = [o["inputs"][2] for o in out]
    total = sum(ints)
    zero = torch.zeros(c, dtype=torch.float64)
    for r, o in enumerate(out):
        assert torch.equal(o["red"], total)
        assert torch.equal(o["red_scalar"], total.sum())
        assert torch.equal(o["red_max"], torch.stack(xs).amax(0))
        assert torch.equal(o["ppermute"],
                           xs[n - 1] if r == 0 else torch.zeros(span,
                                                                dtype=torch.float64))
        want_r = xs[r - 1] if r > 0 else torch.zeros_like(xs[0])
        want_l = xs[r + 1] if r < n - 1 else torch.zeros_like(xs[0])
        assert torch.equal(o["shift_right"], want_r)
        assert torch.equal(o["shift_left"], want_l)
        halo = xs[r + 1][:c] if r < n - 1 else zero
        assert torch.equal(o["ext_gather"],
                           torch.cat([xs[r], halo, zero[:1]]))
        recv = ys[r - 1][span:span + c] if r > 0 else zero
        own = ys[r][:span].clone()
        own[:c] += recv
        assert torch.equal(o["halo_add"], own)
        own = ys[r][:span].clone()
        own[:c] = torch.maximum(own[:c], recv)
        assert torch.equal(o["halo_max"], own)
        assert torch.equal(o["gather_spans"], torch.cat(xs))


def test_each_rank_makes_its_card_current(tmp_path):
    """Rank r of two takes cuda:<r % cards> and makes it the current card,
    which the kernels' launches need on a card a rank."""
    for r, o in enumerate(run_world(2, rank_devices, tmp_path)):
        assert o["device"] == torch.device("cuda", r % o["cards"])
        assert o["current"] == r % o["cards"]
