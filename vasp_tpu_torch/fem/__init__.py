from vasp_tpu_torch.fem.quadrature import tet_quadrature, tri_quadrature  # noqa: F401
from vasp_tpu_torch.fem.shape import (  # noqa: F401
    TET_EDGES,
    p1_tet,
    p2_tet,
    p1_tri,
    p2_tri,
)
