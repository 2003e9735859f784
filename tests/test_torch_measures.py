"""Parity of the port's boundary measures, DG0 projections and point
probes with vasp_tpu's, on the tiny tube with a random P2 velocity (plain
versions on the CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vasp_tpu.fem.functionspace import DVPSpace as JSpace
from vasp_tpu.fem.measures import BoundaryMeasure as JMeasure
from vasp_tpu.fem.measures import PointProbes as JProbes
from vasp_tpu.fem.measures import dg0_project_jacobian as j_jac
from vasp_tpu.fem.measures import dg0_project_speed as j_speed
from vasp_tpu_torch.fem.functionspace import DVPSpace as TSpace
from vasp_tpu_torch.fem.measures import BoundaryMeasure as TMeasure
from vasp_tpu_torch.fem.measures import PointProbes as TProbes
from vasp_tpu_torch.fem.measures import dg0_project_jacobian as t_jac
from vasp_tpu_torch.fem.measures import dg0_project_speed as t_speed
from vasp_tpu_torch.mesh.tetmesh import TetMesh
from _torch_small_fsi import torch_threads

_threads = torch_threads(1)
RTOL = 1e-12


@pytest.fixture(scope="module")
def spaces(tiny_tube):
    m = tiny_tube
    tm = TetMesh(coords=m.coords, cells=m.cells, cell_markers=m.cell_markers,
                 facets=m.facets, facet_markers=m.facet_markers)
    js, ts = JSpace(m), TSpace(tm)
    v = np.random.default_rng(20).normal(size=(js.n_p2, 3)) * 1e-2
    return js, ts, v


def _rel(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_dg0_project_speed(spaces):
    js, ts, v = spaces
    ref = np.asarray(j_speed(js, jnp.asarray(v)))
    out = t_speed(ts, torch.as_tensor(v))
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) <= RTOL


def test_dg0_project_jacobian(spaces):
    js, ts, v = spaces
    d = v * 1e-2
    ref = np.asarray(j_jac(js, jnp.asarray(d)))
    assert _rel(t_jac(ts, torch.as_tensor(d)).numpy(), ref) <= RTOL


def test_dg0_project_jacobian_at_large_strain(spaces):
    """K19c's plain version at strains ~1e-2 (a displacement of 1e-2 of
    the cell size's scale per unit length), as chip_smoke.py holds the
    kernel against it; the tables cached on the space serve a second
    call."""
    js, ts, _ = spaces
    rng = np.random.default_rng(21)
    d = 1e-2 * ts.mesh.hmin * rng.normal(size=(ts.n_p2, 3))
    ref = np.asarray(j_jac(js, jnp.asarray(d)))
    assert 1e-3 < np.abs(ref - 1.0).max() < 0.5
    for _ in range(2):
        assert _rel(t_jac(ts, torch.as_tensor(d)).numpy(), ref) <= RTOL


def test_point_probes(spaces):
    """PointProbes (host numpy): the same cells and values as vasp_tpu's,
    for points inside cells and one outside the mesh (the nearest-cell
    fallback)."""
    js, ts, v = spaces
    L = ts.mesh.coords[:, 2].max()
    pts = np.array([[0.0, 0.0, L / 2], [2e-4, -1e-4, L / 3],
                    [0.0, 0.0, 2 * L]])
    jp, tp = JProbes(js, pts), TProbes(ts, pts)
    np.testing.assert_array_equal(tp.cells, jp.cells)
    p = np.random.default_rng(22).normal(size=ts.n_p1)
    assert _rel(tp.eval_p2(v), np.asarray(jp.eval_p2(v))) <= RTOL
    assert _rel(tp.eval_p1(p), np.asarray(jp.eval_p1(p))) <= RTOL


@pytest.mark.parametrize("marker", [2, 3, 33])
def test_boundary_measure(spaces, marker):
    js, ts, v = spaces
    jm, tm = JMeasure(js, marker), TMeasure(ts, marker)
    assert _rel(tm.area, jm.area) <= RTOL
    assert _rel(tm.centroid, jm.centroid) <= RTOL
    assert _rel(tm.mean_normal, jm.mean_normal) <= RTOL
    flux = tm.integrate_p2_dot_n(torch.as_tensor(v))
    assert flux.dtype == torch.float64 and flux.device.type == "cpu"
    assert _rel(float(flux), float(jm.integrate_p2_dot_n(jnp.asarray(v)))) \
        <= RTOL
