"""Monolithic ALE FSI variational forms: the plain torch element kernels.

Counterpart of vasp_tpu.fem.forms (same discretization contract: P2/P2/P1
Taylor-Hood (d, v, p), theta-scheme, ALE Navier-Stokes on the reference
domain, total-Lagrangian St.Venant-Kirchhoff or Mooney-Rivlin solid,
Laplace, elastic or no mesh lifting on the fluid; the biharmonic lifting's
element part is the Laplace one, its correction fem/biharmonic.py).

Each kernel object evaluates ONE cell's residual with ``cell(u (64,), u0
(64,), Jinv (3,3), detJ (), vol ()) -> (64,)`` in tensor ops, and calling
the object runs ``torch.func.vmap`` of it over a batch of cells. The same
per-cell function is what ``torch.func.jacfwd`` differentiates for the
plain element Jacobians (kernels/element.py), and what the hand-written
CUDA kernels in csrc/element_forms.cuh evaluate term for term.

Fluid form:

  rho_f/dt J(d) (v - v0)·psi
  + th rho_f J(d)  [grad v  F(d)^-1  (v  - w)]·psi
  + (1-th) rho_f J(d0)[grad v0 F(d0)^-1 (v0 - w)]·psi        w = (d-d0)/dt
  + th J(d) sig_v(v,d) F(d)^-T : grad psi
  + (1-th) J(d0) sig_v(v0,d0) F(d0)^-T : grad psi
  - J(d) p F(d)^-T : grad psi                                 (pressure implicit)
  + J(d) tr(grad v F(d)^-1) gamma                             (continuity)

  sig_v(v,d) = mu_f (grad v F^-1 + F^-T grad v^T)

Solid form:

  rho_s/dt (v - v0)·psi + th P(d):grad psi + (1-th) P(d0):grad psi
  - rho_s g·psi
  rho_s [ (d - d0)/dt - (th v + (1-th) v0) ]·phi              (kinematic)

Robin facet form on the solid's outer wall (aneurysm):

  (k_s d + c_s v)·psi ds
"""
import numpy as np
import torch

from vasp_tpu_torch.fem.kinematics import piola1
from vasp_tpu_torch.fem.quadrature import tet_quadrature, tri_quadrature
from vasp_tpu_torch.fem.shape import p1_tet, p2_tet, p2_tri
from vasp_tpu_torch.fem.smallmat import det3, inv3

# constant P1 reference gradients on the tet [1-x-y-z, x, y, z]
_P1GRAD = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0],
                    [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

LAPLACE_SUBTYPES = ("constant", "small_constant", "volume", "volume_change")


def tabulate(quad_degree):
    """numpy (wq (nq,), N1 (nq,4), N2 (nq,10), dN2 (nq,10,3)) on the tet."""
    pts, wq = tet_quadrature(quad_degree)
    N1, _ = p1_tet(pts)
    N2, dN2 = p2_tet(pts)
    return wq, N1, N2, dN2


def _unpack_local(u):
    return u[:30].reshape(10, 3), u[30:60].reshape(10, 3), u[60:64]


def _grad(coeff, G2):
    return torch.einsum("ai,qaj->qij", coeff, G2)


def _trace(A):
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


class _ElementKernel:
    """Shared table handling; subclasses define ``cell``."""

    kind = ""

    def __init__(self, quad_degree):
        self.quad_degree = int(quad_degree)
        self.tables_np = tabulate(self.quad_degree)
        self._tables = {}

    def tables(self, like):
        """Tables in `like`'s dtype and on its device (dtype-polymorphic,
        as the reference kernels cast theirs to the input's dtype)."""
        key = (like.device, like.dtype)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for a in self.tables_np)
        return self._tables[key]

    def __call__(self, u, u0, Jinv, detJ, vol):
        """Batched over cells: (K,64), (K,64), (K,3,3), (K,), (K,) -> (K,64)."""
        return torch.func.vmap(self.cell)(u, u0, Jinv, detJ, vol)


class FluidKernel(_ElementKernel):
    """Fluid element residual (ALE Navier-Stokes + mesh lifting).

    lift_coeff carries the sub_type-dependent global scaling (e.g.
    0.01*hmin^2 for 'small_constant'; beta*gamma for 'biharmonic', whose
    element kernel carries the first Laplace application, the L M^-1 L - L
    correction being added globally by fem/biharmonic.py)."""

    kind = "fluid"

    def __init__(self, rho_f, mu_f, dt, theta, lift="laplace",
                 lift_sub="constant", lift_coeff=1.0, quad_degree=6,
                 p_stab=0.0):
        super().__init__(quad_degree)
        self.rho_f, self.mu_f = float(rho_f), float(mu_f)
        self.dt, self.theta = float(dt), float(theta)
        self.lift, self.lift_sub = lift, lift_sub
        self.lift_coeff = float(lift_coeff)
        self.p_stab = float(p_stab)
        if lift not in ("laplace", "biharmonic", "elastic",
                        "no_extrapolation"):
            raise ValueError(f"unknown extrapolation: {lift}")

    def cell(self, u, u0, Jinv, detJ, vol):
        rho_f, mu_f, dt, th = self.rho_f, self.mu_f, self.dt, self.theta
        dty = u.dtype
        wq, N1, N2, dN2 = self.tables(u)
        de, ve, pe = _unpack_local(u)
        d0e, v0e, _ = _unpack_local(u0)
        G2 = dN2 @ Jinv  # (nq,10,3) physical gradients of P2 basis

        d_q = N2 @ de
        v_q = N2 @ ve
        v0_q = N2 @ v0e
        p_q = N1 @ pe
        w_q = (d_q - (N2 @ d0e)) / dt  # mesh velocity

        gd, gd0 = _grad(de, G2), _grad(d0e, G2)
        gv, gv0 = _grad(ve, G2), _grad(v0e, G2)

        eye = torch.eye(3, dtype=dty, device=u.device)
        F = eye + gd
        F0 = eye + gd0
        Jd = det3(F)
        J0 = det3(F0)
        Fi = inv3(F, Jd)
        Fi0 = inv3(F0, J0)

        # ---- momentum ----
        mom_val = rho_f / dt * Jd[:, None] * (v_q - v0_q)
        gvFi = gv @ Fi
        gvFi0 = gv0 @ Fi0
        conv_n = torch.einsum("qij,qj->qi", gvFi, v_q - w_q)
        conv_o = torch.einsum("qij,qj->qi", gvFi0, v0_q - w_q)
        mom_val = mom_val + rho_f * (th * Jd[:, None] * conv_n
                                     + (1 - th) * J0[:, None] * conv_o)

        sig_n = mu_f * (gvFi + gvFi.transpose(1, 2))
        sig_o = mu_f * (gvFi0 + gvFi0.transpose(1, 2))
        mom_grad = th * Jd[:, None, None] * (sig_n @ Fi.transpose(1, 2))
        mom_grad = mom_grad + (1 - th) * J0[:, None, None] * (
            sig_o @ Fi0.transpose(1, 2))
        # pressure, fully implicit: -J p F^-T
        mom_grad = mom_grad - (Jd * p_q)[:, None, None] * Fi.transpose(1, 2)

        wdet = wq * detJ
        rv = torch.einsum("q,qa,qi->ai", wdet, N2, mom_val)
        rv = rv + torch.einsum("q,qij,qaj->ai", wdet, mom_grad, G2)

        # ---- continuity ----
        divv = Jd * torch.einsum("qij,qji->q", gv, Fi)
        rp = torch.einsum("q,q,qb->b", wdet, divv, N1)
        if self.p_stab:
            # Brezzi-Pitkaranta pressure stabilization (see the reference
            # package's forms.py for why the fixture meshes need it)
            G1 = torch.as_tensor(_P1GRAD, dtype=dty, device=u.device) @ Jinv
            gp = pe @ G1
            h2 = (6.0 * vol) ** (2.0 / 3.0)
            rp = rp + (self.p_stab * h2 / mu_f) * vol * (G1 @ gp)

        # ---- mesh lifting ----
        if self.lift in ("laplace", "biharmonic"):
            if self.lift_sub == "volume":
                a_q = (self.lift_coeff / vol).expand(gd.shape[0])
            elif self.lift_sub == "volume_change":
                a_q = self.lift_coeff / Jd
            else:  # constant / small_constant (coeff baked into lift_coeff)
                a_q = torch.full((gd.shape[0],), self.lift_coeff, dtype=dty,
                                 device=u.device)
            rd = torch.einsum("q,qij,qaj->ai", wdet * a_q, gd, G2)
        elif self.lift == "elastic":
            eps = 0.5 * (gd + gd.transpose(1, 2))
            sig = 2.0 * eps + _trace(eps)[:, None, None] * eye
            rd = torch.einsum("q,qij,qaj->ai", wdet * self.lift_coeff, sig, G2)
        else:  # no_extrapolation
            rd = torch.zeros((10, 3), dtype=dty, device=u.device)

        return torch.cat([rd.reshape(-1), rv.reshape(-1), rp])


class SolidKernel(_ElementKernel):
    """Solid element residual (total-Lagrangian hyperelasticity).

    props: solid_properties dict with material_model/rho_s/mu_s/lambda_s."""

    kind = "solid"

    def __init__(self, props, dt, theta, gravity=None, quad_degree=6):
        super().__init__(quad_degree)
        self.props = dict(props)
        self.rho_s = float(props["rho_s"])
        self.dt, self.theta = float(dt), float(theta)
        self.gravity = (np.zeros(3) if gravity is None
                        else np.asarray(gravity, np.float64))

    def cell(self, u, u0, Jinv, detJ, vol):
        rho_s, dt, th = self.rho_s, self.dt, self.theta
        dty = u.dtype
        wq, N1, N2, dN2 = self.tables(u)
        g = torch.as_tensor(self.gravity, dtype=dty, device=u.device)
        de, ve, _ = _unpack_local(u)
        d0e, v0e, _ = _unpack_local(u0)
        G2 = dN2 @ Jinv

        d_q = N2 @ de
        d0_q = N2 @ d0e
        v_q = N2 @ ve
        v0_q = N2 @ v0e
        P_n = piola1(_grad(de, G2), self.props)
        P_o = piola1(_grad(d0e, G2), self.props)

        mom_val = rho_s / dt * (v_q - v0_q) - rho_s * g
        mom_grad = th * P_n + (1 - th) * P_o
        wdet = wq * detJ
        rv = torch.einsum("q,qa,qi->ai", wdet, N2, mom_val)
        rv = rv + torch.einsum("q,qij,qaj->ai", wdet, mom_grad, G2)

        kin = rho_s * ((d_q - d0_q) / dt - (th * v_q + (1 - th) * v0_q))
        rd = torch.einsum("q,qa,qi->ai", wdet, N2, kin)

        rp = torch.zeros(4, dtype=dty, device=u.device)
        return torch.cat([rd.reshape(-1), rv.reshape(-1), rp])


class RobinKernel(_ElementKernel):
    """Robin BC facet kernel on P2 triangles: (k_s d + c_s v)·psi ds
    (reference: src/vasp/simulations/aneurysm.py:73-76; external tissue
    support k*d + c*d_dot, reference: docs/aneurysm.md:154-170).

    ``facet(u (36,) = [d(6x3), v(6x3)], area2 ()) -> (36,)`` with area2 =
    |(x1-x0)x(x2-x0)| (twice the triangle area); the d rows are zero, the
    v rows (the momentum equation) take the traction. Calling the object
    runs ``torch.func.vmap`` of it over a batch of facets. The tables are
    tri_quadrature / p2_tri at the run's degree, in the input's dtype."""

    kind = "robin"

    def __init__(self, k_s, c_s, quad_degree=6):
        self.k_s, self.c_s = float(k_s), float(c_s)
        self.quad_degree = int(quad_degree)
        pts, wq = tri_quadrature(self.quad_degree)
        self.tables_np = (wq, p2_tri(pts)[0])
        self._tables = {}

    def facet(self, u, area2):
        wq, N2t = self.tables(u)
        d = u[:18].reshape(6, 3)
        v = u[18:36].reshape(6, 3)
        val = self.k_s * (N2t @ d) + self.c_s * (N2t @ v)
        r = torch.einsum("q,qa,qi->ai", wq * area2, N2t, val)
        return torch.cat([torch.zeros(18, dtype=u.dtype, device=u.device),
                          r.reshape(-1)])

    def __call__(self, u, area2):
        """Batched over facets: (K,36), (K,) -> (K,36)."""
        return torch.func.vmap(self.facet)(u, area2)


# the reference package's factory names
make_fluid_kernel = FluidKernel
make_solid_kernel = SolidKernel
make_robin_kernel = RobinKernel


def interface_pressure_vector(space, facet_verts, cells_plus, p2_tri_dofs,
                              quad_degree=6):
    """Assemble the geometry part b of the interface-pressure load so that
    R_v += P(t) * b. b[a,i] = sum_facets int_tri n_i N_a dGamma with n the
    unit normal oriented outward from the solid ('+') cell
    (reference: src/vasp/simulations/cylinder.py:164-169).

    Returns a dense (ndof,) numpy vector (assembled once on the host; the
    load is linear in the scalar P(t))."""
    mesh = space.mesh
    pts, wq = tri_quadrature(quad_degree)
    N2t, _ = p2_tri(pts)

    x = mesh.coords[np.sort(facet_verts, axis=1)]  # (K,3,3)
    e1 = x[:, 1] - x[:, 0]
    e2 = x[:, 2] - x[:, 0]
    cr = np.cross(e1, e2)
    area2 = np.linalg.norm(cr, axis=1)
    n = cr / area2[:, None]
    # orient outward from the solid cell: from solid centroid toward facet
    solid_cent = mesh.coords[mesh.cells[cells_plus]].mean(axis=1)
    face_cent = x.mean(axis=1)
    flip = np.einsum("ki,ki->k", n, face_cent - solid_cent) < 0
    n[flip] *= -1.0

    # b_local[k,a,i] = sum_q wq * area2 * N_a(q) * n_i
    coeff = (wq[None, :] * area2[:, None])  # (K,nq)
    ba = np.einsum("kq,qa->ka", coeff, N2t)  # (K,6)
    b_local = ba[:, :, None] * n[:, None, :]  # (K,6,3)

    b = np.zeros(space.ndof)
    vdofs = space.field_dofs("v", p2_tri_dofs.reshape(-1)).reshape(-1, 6, 3)
    np.add.at(b, vdofs.reshape(-1), b_local.reshape(-1))
    return b
