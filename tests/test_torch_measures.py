"""Parity of the port's boundary measures and DG0 projections with
vasp_tpu's, on the tiny tube with a random P2 velocity (plain versions on
the CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vasp_tpu.fem.functionspace import DVPSpace as JSpace
from vasp_tpu.fem.measures import BoundaryMeasure as JMeasure
from vasp_tpu.fem.measures import dg0_project_jacobian as j_jac
from vasp_tpu.fem.measures import dg0_project_speed as j_speed
from vasp_tpu_torch.fem.functionspace import DVPSpace as TSpace
from vasp_tpu_torch.fem.measures import BoundaryMeasure as TMeasure
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
