"""The host side of the CUDA element kernels (kernels/element.py), at
quadrature degrees 1 to 10, against vasp_tpu's quadrature and shape
functions: the packed tables the kernels read from device memory, the
route each rule takes (the constant bank or device memory), and K3's
launch shape and dynamic shared memory.

Tolerances: the float64 pack equals vasp_tpu's tables exactly (the same
numpy arithmetic); the float32 pack is their rounding, exactly."""
import numpy as np
import pytest

from vasp_tpu.fem.quadrature import tet_quadrature as j_tet_quadrature
from vasp_tpu.fem.shape import p1_tet as j_p1_tet
from vasp_tpu.fem.shape import p2_tet as j_p2_tet
from vasp_tpu_torch.fem.forms import FluidKernel
from vasp_tpu_torch.kernels import element

DEGREES = range(1, 11)
# the shared memory a block of an H100 can take (232,448 bytes)
SMEM_MAX = 227 * 1024


def _reference(degree):
    pts, wq = j_tet_quadrature(degree)
    N2, dN2 = j_p2_tet(pts)
    return [np.asarray(a, np.float64) for a in
            (wq, j_p1_tet(pts)[0], N2, dN2)]


@pytest.mark.parametrize("degree", DEGREES)
def test_table_pack(degree):
    """[wq | N1 | N2 | dN2], nq * 45 entries, in float64 and float32."""
    ref = _reference(degree)
    nq = len(ref[0])
    kern = FluidKernel(1e3, 3.5e-3, 1e-3, 0.5, quad_degree=degree)
    pack = element.table_pack(kern.tables_np)
    assert pack.dtype == np.float64 and pack.shape == (45 * nq,)
    # the segments GlobalTab reads: wq at 0, N1 at nq, N2 at 5 nq, dN2 at
    # 15 nq, each C-ordered
    segments = np.split(pack, [nq, 5 * nq, 15 * nq])
    for got, want in zip(segments, ref):
        np.testing.assert_array_equal(got, want.reshape(-1))
    pack32 = element.table_pack(kern.tables_np, np.float32)
    assert pack32.dtype == np.float32
    np.testing.assert_array_equal(pack32, pack.astype(np.float32))


@pytest.mark.parametrize("degree", DEGREES)
def test_table_route_and_jacobian_launch(degree):
    """The constant bank up to 125 points in float64 (degree 9) and 64 in
    float32 (degree 7), device memory past them; K3's chunk takes one
    tangent a thread (25 a fluid point, 15 a solid one, of 256 threads)
    and its buffers fit a block's shared memory at every degree."""
    nq = len(_reference(degree)[0])
    assert nq == max(1, (degree + 2) // 2) ** 3
    assert element.table_route(nq, "f64") == (
        "constant" if degree <= 9 else "memory")
    assert element.table_route(nq, "f32") == (
        "constant" if degree <= 7 else "memory")
    for kind, states in (("fluid", 25), ("solid", 15)):
        qc, smem = element.jacobian_launch(kind, nq)
        assert qc == min(nq, 256 // states)
        assert qc * states <= element.JAC_THREADS
        # u, u0 and Jinv; per point the basis (40), N1 and w (8), two
        # states (2 x 26), the previous state's terms (20) and D_q (25 x
        # 26); at least A_e's 4096 for its staging
        assert smem == 8 * (144 + max(770 * qc, 4096))
        assert smem <= SMEM_MAX
