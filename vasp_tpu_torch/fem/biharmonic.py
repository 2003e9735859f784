"""Biharmonic mesh lifting (discrete mixed form, matrix-free).

Counterpart of vasp_tpu.fem.biharmonic. The reference vocabulary lists
extrapolation="biharmonic" with sub-types bc1/bc2 (reference:
src/vasp/simulations/cylinder.py:65-66 and predeform.py:77-78; the solver
itself is turtleFSI's). The continuous operator is the clamped biharmonic
extension Delta^2 d = 0 on the fluid domain, solved in turtleFSI as a
mixed second-order system with an auxiliary field w = -Delta d.

The auxiliary field is eliminated discretely with a lumped P2 mass
matrix:

    R_d(d) = beta L M_l^{-1} L d     L = P2 vector Laplacian on fluid cells,
                                     M_l = lumped (row-sum) P2 mass

the standard discrete biharmonic (two stiffness applications, one
diagonal solve), linear in d, so the Newton matvec applies the same
operator. The element kernels carry the FIRST L application, scaled by
beta * gamma (gamma ~ median of diag(L)/m), as the preconditioners'
surrogate of the true d-block; this module supplies the correction

    beta L (M_l^{-1} L d) - beta gamma L d

on the fluid d rows, so that the assembled residual equals the discrete
biharmonic exactly. FSISystem builds the tables with beta =
cfg["biharmonic_beta"] (default 1.0); beta=None here takes hmin^2.

Sub-types (auxiliary-field boundary treatment):
- "bc1": w SOFT-clamped (mass-penalized, x1e-4) at the inlet/outlet endcap
  nodes; a hard clamp is structurally rank-deficient (vasp_tpu's module
  docstring has the measurement);
- "bc2": w natural (no clamp); the operator's null space is constants
  only, removed by the d Dirichlet rows.

``build_biharmonic`` and ``correction_csr`` are host numpy/scipy, copied;
``correction_apply`` is the device dispatch to K16 (kernels/lifting.py).
"""
import numpy as np
import torch

from vasp_tpu_torch.fem.assembly import cell_geometry
from vasp_tpu_torch.fem.quadrature import tet_quadrature
from vasp_tpu_torch.fem.shape import p2_tet
from vasp_tpu_torch.kernels.lifting import correction_apply  # noqa: F401


def build_biharmonic(mesh, space, fluid_ids, sub_type="bc1",
                     quad_degree=2, clamp_ids=(2, 3), beta=None,
                     device="cpu"):
    """The correction's tables: Ke (K_f,10,10) float64, p2dofs (K_f,10)
    int32, minv, wfree (bool), dmask (n_p2,) as tensors on `device`, and
    the scalars beta and beta_gamma as Python floats."""
    fluid_ids = np.atleast_1d(fluid_ids)
    sel = np.nonzero(np.isin(mesh.cell_markers, fluid_ids))[0]
    # P2 nodes owned by NON-fluid (solid) cells carry the solid kinematic
    # equation: the lifting correction must not write to their d-rows
    # (the rule of CellBlock.rowmask)
    solid_sel = np.nonzero(~np.isin(mesh.cell_markers, fluid_ids))[0]
    Jinv, detJ, _ = cell_geometry(mesh.coords, mesh.cells)
    Jinv, detJ = Jinv[sel], detJ[sel]

    pts, wq = tet_quadrature(quad_degree)
    N2, dN2 = p2_tet(pts)  # (nq,10), (nq,10,3)
    # per-cell P2 stiffness Ke[a,b] = sum_q wq detJ (dNa J^-1)·(dNb J^-1)
    G = np.einsum("qaj,kji->kqai", dN2, Jinv)  # (K,nq,10,3)
    Ke = np.einsum("q,k,kqai,kqbi->kab", wq, detJ, G, G)  # (K,10,10)
    # lumped P2 mass over fluid cells: m_a = sum_e sum_q wq detJ N_a
    me = np.einsum("q,k,qa->ka", wq, detJ, N2)  # (K,10)
    p2dofs = space.cell_dofs_p2[sel]  # (K,10) P2 node ids
    n_p2 = space.n_p2
    m = np.zeros(n_p2)
    np.add.at(m, p2dofs.reshape(-1), me.reshape(-1))
    in_fluid = m > 0
    m = np.where(in_fluid, m, 1.0)

    # w soft-clamp (bc1): endcap (inlet/outlet) nodes only, via mass
    # penalty
    minv = 1.0 / m
    if sub_type != "bc2":
        clamp = np.zeros(n_p2, bool)
        for mk in clamp_ids:
            fv, _, _ = mesh.exterior_facets(int(mk))
            if len(fv) == 0:
                continue
            fvs = np.sort(fv.astype(np.int64), axis=1)
            p2d = space.facet_dofs_p2(fvs)
            clamp[np.unique(p2d)] = True
        clamp &= in_fluid
        minv = np.where(clamp, 1e-4 * minv, minv)

    if beta is None:
        beta = float(mesh.hmin) ** 2
    # spectral surrogate scale: L M^-1 L ~ gamma L with gamma ~ diag(L)/m;
    # the element kernels carry beta*gamma*L so that the preconditioners
    # (built from element Jacobians only: the 2-ring correction stencil
    # does not fit their patterns) see a d-block of the right magnitude
    diagL = np.zeros(n_p2)
    np.add.at(diagL, p2dofs.reshape(-1),
              np.einsum("kaa->ka", Ke).reshape(-1))
    gamma = float(np.median((diagL * minv)[in_fluid]))
    dmask = np.ones(n_p2, np.float64)
    if len(solid_sel):
        dmask[np.unique(space.cell_dofs_p2[solid_sel])] = 0.0

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return dict(
        Ke=dev(Ke),
        p2dofs=dev(p2dofs.astype(np.int32), torch.int32),
        minv=dev(minv),
        wfree=dev(in_fluid, torch.bool),
        dmask=dev(dmask),
        beta=float(beta),
        beta_gamma=float(beta) * gamma,
    )


def correction_csr(lift, ndof):
    """Host scipy CSR of the correction (for the direct-LU path)."""
    import scipy.sparse as sp

    n_p2 = lift["minv"].shape[0]
    Ke = lift["Ke"].cpu().numpy()
    dofs = lift["p2dofs"].cpu().numpy()
    K, nloc = dofs.shape
    rows = np.repeat(dofs, nloc, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, nloc)).reshape(-1)
    Ls = sp.coo_matrix((Ke.reshape(-1), (rows, cols)),
                       shape=(n_p2, n_p2)).tocsr()
    winv = lift["minv"].cpu().numpy() * lift["wfree"].cpu().numpy()
    C = (float(lift["beta"]) * (Ls @ sp.diags(winv) @ Ls)
         - float(lift["beta_gamma"]) * Ls)
    # kinematic-row mask (same rule as correction_apply)
    C = (sp.diags(lift["dmask"].cpu().numpy()) @ C).tocoo()
    # expand scalar node operator to the 3 interleaved d components
    # (d dof = 3*node + comp)
    r = (3 * C.row[:, None] + np.arange(3)[None, :]).reshape(-1)
    c = (3 * C.col[:, None] + np.arange(3)[None, :]).reshape(-1)
    v = np.repeat(C.data, 3)
    return sp.coo_matrix((v, (r, c)), shape=(ndof, ndof)).tocsr()
