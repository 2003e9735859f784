"""Block-based residual / element-Jacobian / matvec assembly on torch
tensors.

Counterpart of vasp_tpu.fem.assembly (the plain scatter-add path): gather
-> element kernel -> masked scatter-add, with the element Jacobians kept
as a batched (K, n, n) float64 or float32 tensor per block (n = 64 for the
cell blocks, 36 for the Robin facet blocks), and the matrix-free matvec
over them. The residual's element work runs in float64, float32 or
"mixed" (float32 on the fluid only), always accumulated in float64. On
CUDA tensors the residual, Jacobians and matvec are the hand-written
kernels of kernels/element.py, kernels/facet.py and kernels/matvec.py; on
CPU tensors their plain torch versions. The endgame's Taylor deltas
(residual_delta, residual_delta2) go the same way (K13).
"""
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vasp_tpu_torch.kernels import element, facet
from vasp_tpu_torch.kernels.matvec import elem_matvec


def cell_geometry(coords, cells):
    """Affine map data per cell: (Jinv (Nc,3,3), detJ (Nc,), vol (Nc,)),
    host numpy float64.

    x(xi) = x0 + A xi with A[:,j] = x_{j+1} - x_0; physical gradients are
    dN_ref @ Jinv with Jinv = A^{-1}."""
    xe = coords[cells]  # (Nc,4,3)
    A = np.stack([xe[:, 1] - xe[:, 0], xe[:, 2] - xe[:, 0], xe[:, 3] - xe[:, 0]],
                 axis=2)  # (Nc,3,3), columns are edge vectors
    detA = np.linalg.det(A)
    Jinv = np.linalg.inv(A)
    detJ = np.abs(detA)
    return Jinv, detJ, detJ / 6.0


@dataclass
class CellBlock:
    """A group of cells sharing one element kernel (one subdomain/material).

    All tensors live on the run's device: dofs int64, the rest float64.

    rowmask (optional, (K, 64) in {0,1}): zeroes selected LOCAL RESIDUAL
    ROWS of this block before the scatter, in the residual and in the
    Jacobian alike. FSISystem uses it to take the fluid mesh-lifting
    equation off the d-rows that carry the solid kinematic equation (see
    vasp_tpu.fem.assembly.CellBlock for the measurement behind it)."""

    name: str
    kernel: object  # fem.forms FluidKernel / SolidKernel
    dofs: torch.Tensor  # (K,64) global indices into U
    Jinv: torch.Tensor  # (K,3,3)
    detJ: torch.Tensor  # (K,)
    vol: torch.Tensor  # (K,)
    rowmask: Optional[torch.Tensor] = None  # (K,64) 0/1 residual-row mask


@dataclass
class FacetBlock:
    """A group of boundary triangles sharing one facet kernel (the Robin
    term): dofs (K,36) int64 = [d 6x3, v 6x3], area2 (K,) float64 twice
    the triangle areas, on the run's device."""

    name: str
    kernel: object  # fem.forms RobinKernel
    dofs: torch.Tensor  # (K,36) global indices into U
    area2: torch.Tensor  # (K,)


def _ops(block):
    """The kernel module of a block: kernels/facet.py for a FacetBlock,
    kernels/element.py for a CellBlock."""
    return facet if isinstance(block, FacetBlock) else element


class Assembler:
    """Residual / element Jacobians / host CSR over a list of blocks."""

    def __init__(self, ndof: int, blocks):
        self.ndof = ndof
        self.blocks = list(blocks)

    def residual(self, U, U0, dtype=None):
        """R(U; U0) as a float64 (ndof,) tensor on U's device.

        dtype: the precision of the ELEMENT work, accumulated in float64
        either way (vasp_tpu.fem.assembly.Assembler.residual): None for
        float64, torch.float32 for float32 on every block, "mixed" for
        float32 on the blocks whose name starts with "fluid" and float64
        on the others (the stiff solid, where the float32 cancellation
        noise lives, and the facet terms)."""
        if isinstance(dtype, str):
            if dtype != "mixed":
                raise ValueError(f"residual dtype {dtype!r}: expected None, "
                                 f"torch.float32 or 'mixed'")
            per_block = [torch.float32 if b.name.startswith("fluid") else None
                         for b in self.blocks]
        else:
            per_block = [dtype] * len(self.blocks)
        R = torch.zeros(self.ndof, dtype=torch.float64, device=U.device)
        for b, dt in zip(self.blocks, per_block):
            _ops(b).block_residual(b, U, U0, R, dt)
        return R

    def residual_delta(self, U, A, U0):
        """R(U) - R(A) as vasp_tpu's Assembler.residual_delta computes it: a
        float64 (ndof,) tensor on U's device, the sum over the blocks of
        the order-3 float32 Taylor delta of each element kernel along
        du = U - A at the previous state U0 (K13, kernels/element.py and
        kernels/facet.py), accumulated in float64. Its value is jet's sum
        of derivatives y1 + y2 + y3, not the Taylor sum y1 + y2/2 + y3/6
        (ROADMAP.md queue 3)."""
        R = torch.zeros(self.ndof, dtype=torch.float64, device=U.device)
        for b in self.blocks:
            _ops(b).block_delta(b, U, A, U0, R)
        return R

    def residual_delta2(self, U, A, U0new, U0old):
        """R(U; U0new) - R(A; U0old) as vasp_tpu's Assembler.residual_delta2
        computes it: the delta of residual_delta with the previous state
        moving along du0 = U0new - U0old too (the facet terms have no
        previous state: only du applies there)."""
        R = torch.zeros(self.ndof, dtype=torch.float64, device=U.device)
        for b in self.blocks:
            _ops(b).block_delta(b, U, A, U0old, R, U0new)
        return R

    def element_jacobians(self, U, U0, dtype=torch.float64):
        """Per block, the (K,n,n) element Jacobians in `dtype` (float64 or
        float32, see kernels/element.py on how float32 is rounded), rows
        masked."""
        return [_ops(b).block_jacobian(b, U, U0, dtype) for b in self.blocks]

    def matvec(self, jacs, x):
        """y = J x from element Jacobians, in x's dtype: each element
        product is taken in the Jacobians' dtype and accumulated in x's."""
        y = torch.zeros(self.ndof, dtype=x.dtype, device=x.device)
        for b, A in zip(self.blocks, jacs):
            elem_matvec(A, b.dofs, x, y)
        return y

    # ---------------- host-side sparse export (direct solver path) ----------
    def to_csr(self, jacs, bc_mask: Optional[np.ndarray] = None):
        """Assemble a scipy CSR matrix from element Jacobians (copied to the
        host).

        bc_mask: boolean (ndof,) — constrained rows are replaced by identity
        (and their columns zeroed), the standard strong Dirichlet treatment."""
        import scipy.sparse as sp

        rows, cols, vals = [], [], []
        for b, A in zip(self.blocks, jacs):
            dofs = b.dofs.cpu().numpy()
            K, nloc = dofs.shape
            rows.append(np.repeat(dofs, nloc, axis=1).reshape(-1))
            cols.append(np.tile(dofs, (1, nloc)).reshape(-1))
            vals.append(A.cpu().numpy().reshape(-1))
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        vals = np.concatenate(vals)
        if bc_mask is not None:
            keep = ~(bc_mask[rows] | bc_mask[cols])
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
            bc_dofs = np.nonzero(bc_mask)[0]
            rows = np.concatenate([rows, bc_dofs])
            cols = np.concatenate([cols, bc_dofs])
            vals = np.concatenate([vals, np.ones(len(bc_dofs))])
        M = sp.coo_matrix((vals, (rows, cols)), shape=(self.ndof, self.ndof))
        return M.tocsr()
