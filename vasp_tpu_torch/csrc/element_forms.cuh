// One cell's monolithic FSI element residual, templated on its scalar type.
//
// Replaces the element math of vasp_tpu/fem/forms.py: make_fluid_kernel
// (ALE Navier-Stokes + continuity + Laplace lifting) and make_solid_kernel
// with vasp_tpu/fem/kinematics.py (total-Lagrangian St.Venant-Kirchhoff +
// kinematic row). The plain torch twin is vasp_tpu_torch/fem/forms.py; the
// expressions below follow it term for term.
//
// T = double gives the residual (K1, K2). T = Dual (value + one tangent)
// gives one column of the exact element Jacobian (K3), so the Jacobian is
// the derivative of this very code, as jax.jacfwd is of the JAX kernel.
// Inputs that the Jacobian does not differentiate (u0, geometry, tables)
// stay double in both instantiations.
//
// The quadrature loop is outermost: per point the (10,3) physical basis
// gradients live in registers and are folded straight into the 64 local
// residual entries, so no (nq,10,3) array is ever materialized.
#pragma once

#include <cuda_runtime.h>

#define VT_NQ_MAX 125  // tet rule of degree 8 (5^3 points); degree 6 is 64

// Quadrature and basis tables (weights, P1 values, P2 values, P2 reference
// gradients), uploaded by vt_set_element_tables. Every thread walks the
// quadrature points in the same order, so each read is a broadcast.
__constant__ double c_wq[VT_NQ_MAX];
__constant__ double c_N1[VT_NQ_MAX * 4];
__constant__ double c_N2[VT_NQ_MAX * 10];
__constant__ double c_dN2[VT_NQ_MAX * 30];

// ---------------------------------------------------------------- dual --
struct Dual {
  double v, d;
  __device__ Dual() {}
  __device__ Dual(double x) : v(x), d(0.0) {}
  __device__ Dual(double x, double t) : v(x), d(t) {}
};

__device__ inline Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ inline Dual operator+(Dual a, double b) { return Dual(a.v + b, a.d); }
__device__ inline Dual operator+(double a, Dual b) { return Dual(a + b.v, b.d); }
__device__ inline Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ inline Dual operator-(Dual a, double b) { return Dual(a.v - b, a.d); }
__device__ inline Dual operator-(double a, Dual b) { return Dual(a - b.v, -b.d); }
__device__ inline Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ inline Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.v * b.d + a.d * b.v);
}
__device__ inline Dual operator*(Dual a, double b) { return Dual(a.v * b, a.d * b); }
__device__ inline Dual operator*(double a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ inline Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ inline Dual operator/(Dual a, double b) { return Dual(a.v / b, a.d / b); }
__device__ inline Dual operator/(double a, Dual b) {
  const double q = a / b.v;
  return Dual(q, -q * b.d / b.v);
}
__device__ inline Dual& operator+=(Dual& a, Dual b) { a = a + b; return a; }

// ------------------------------------------------------------ params --
// lift_sub: 0 = constant / small_constant (coefficient baked into
// lift_coeff), 1 = volume, 2 = volume_change. Other extrapolations,
// p_stab and gravity are refused by the Python wrapper.
struct FluidParams {
  double rho, mu, dt, theta, lift_coeff;
  int lift_sub;
};

struct SolidParams {
  double rho, mu, lam, dt, theta;
};

// ------------------------------------------------------------ helpers --
template <class S>
__device__ inline S det3(const S A[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1])
       - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0])
       + A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

template <class S>
__device__ inline void inv3(const S A[3][3], S det, S Ai[3][3]) {
  Ai[0][0] = (A[1][1] * A[2][2] - A[1][2] * A[2][1]) / det;
  Ai[0][1] = (A[0][2] * A[2][1] - A[0][1] * A[2][2]) / det;
  Ai[0][2] = (A[0][1] * A[1][2] - A[0][2] * A[1][1]) / det;
  Ai[1][0] = (A[1][2] * A[2][0] - A[1][0] * A[2][2]) / det;
  Ai[1][1] = (A[0][0] * A[2][2] - A[0][2] * A[2][0]) / det;
  Ai[1][2] = (A[0][2] * A[1][0] - A[0][0] * A[1][2]) / det;
  Ai[2][0] = (A[1][0] * A[2][1] - A[1][1] * A[2][0]) / det;
  Ai[2][1] = (A[0][1] * A[2][0] - A[0][0] * A[2][1]) / det;
  Ai[2][2] = (A[0][0] * A[1][1] - A[0][1] * A[1][0]) / det;
}

// physical P2 basis gradients at point q: G[a][l] = sum_j dN2[q,a,j] Jinv[j,l]
__device__ inline void basis_gradients(int q, const double* Jinv, double G[10][3]) {
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const int o = (q * 10 + a) * 3;
#pragma unroll
    for (int l = 0; l < 3; ++l)
      G[a][l] = c_dN2[o] * Jinv[l] + c_dN2[o + 1] * Jinv[3 + l]
              + c_dN2[o + 2] * Jinv[6 + l];
  }
}

// value of a P2 vector field at q: out[i] = sum_a N2[q,a] c[a*3+i]
template <class S>
__device__ inline void p2_value(int q, const S* c, S out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = S(0.0);
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const double n = c_N2[q * 10 + a];
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] += n * c[a * 3 + i];
  }
}

// gradient of a P2 vector field: g[i][j] = sum_a c[a*3+i] G[a][j]
template <class S>
__device__ inline void p2_grad(const S* c, const double G[10][3], S g[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) g[i][j] = S(0.0);
#pragma unroll
  for (int a = 0; a < 10; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) g[i][j] += c[a * 3 + i] * G[a][j];
}

// ------------------------------------------------------------- fluid --
// u: local (64,) [d 10x3 | v 10x3 | p 4]; u0 likewise; Jinv row-major 3x3.
template <class T>
__device__ void fluid_residual(const T* u, const double* u0, const double* Jinv,
                               double detJ, double vol, const FluidParams& P,
                               int nq, T* r) {
  const double th = P.theta;
  const double rho = P.rho, mu = P.mu, dt = P.dt;
#pragma unroll
  for (int k = 0; k < 64; ++k) r[k] = T(0.0);

  for (int q = 0; q < nq; ++q) {
    double G[10][3];
    basis_gradients(q, Jinv, G);

    T d_q[3], v_q[3], p_q = T(0.0);
    double d0_q[3], v0_q[3];
    p2_value(q, u, d_q);
    p2_value(q, u + 30, v_q);
    p2_value(q, u0, d0_q);
    p2_value(q, u0 + 30, v0_q);
#pragma unroll
    for (int b = 0; b < 4; ++b) p_q += c_N1[q * 4 + b] * u[60 + b];
    T w_q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w_q[i] = (d_q[i] - d0_q[i]) / dt;

    T gd[3][3], gv[3][3];
    double gd0[3][3], gv0[3][3];
    p2_grad(u, G, gd);
    p2_grad(u + 30, G, gv);
    p2_grad(u0, G, gd0);
    p2_grad(u0 + 30, G, gv0);

    T F[3][3], Fi[3][3];
    double F0[3][3], Fi0[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        F[i][j] = gd[i][j] + (i == j ? 1.0 : 0.0);
        F0[i][j] = gd0[i][j] + (i == j ? 1.0 : 0.0);
      }
    const T Jd = det3(F);
    const double J0 = det3(F0);
    inv3(F, Jd, Fi);
    inv3(F0, J0, Fi0);

    // grad v F^-1, new and old
    T gvFi[3][3];
    double gvFi0[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gvFi[i][j] = gv[i][0] * Fi[0][j] + gv[i][1] * Fi[1][j] + gv[i][2] * Fi[2][j];
        gvFi0[i][j] = gv0[i][0] * Fi0[0][j] + gv0[i][1] * Fi0[1][j] + gv0[i][2] * Fi0[2][j];
      }

    // momentum: value-test terms (mass + theta-split convection)
    T mom_val[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      T conv_n = T(0.0), conv_o = T(0.0);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        conv_n += gvFi[i][j] * (v_q[j] - w_q[j]);
        conv_o += gvFi0[i][j] * (v0_q[j] - w_q[j]);
      }
      mom_val[i] = rho / dt * Jd * (v_q[i] - v0_q[i])
                 + rho * (th * Jd * conv_n + (1.0 - th) * J0 * conv_o);
    }

    // momentum: gradient-test terms (viscous stress, implicit pressure)
    T mom_grad[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T sn = T(0.0);
        double so = 0.0;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          sn += mu * (gvFi[i][j] + gvFi[j][i]) * Fi[k][j];
          so += mu * (gvFi0[i][j] + gvFi0[j][i]) * Fi0[k][j];
        }
        mom_grad[i][k] = th * Jd * sn + (1.0 - th) * J0 * so - Jd * p_q * Fi[k][i];
      }

    // continuity: J tr(grad v F^-1)
    const T divv = Jd * (gvFi[0][0] + gvFi[1][1] + gvFi[2][2]);

    // Laplace lifting coefficient
    T a_q;
    if (P.lift_sub == 2)
      a_q = P.lift_coeff / Jd;
    else if (P.lift_sub == 1)
      a_q = T(P.lift_coeff / vol);
    else
      a_q = T(P.lift_coeff);

    const double wdet = c_wq[q] * detJ;
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const double n = c_N2[q * 10 + a];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T gdG = gd[i][0] * G[a][0] + gd[i][1] * G[a][1] + gd[i][2] * G[a][2];
        const T mgG = mom_grad[i][0] * G[a][0] + mom_grad[i][1] * G[a][1]
                    + mom_grad[i][2] * G[a][2];
        r[a * 3 + i] += wdet * a_q * gdG;
        r[30 + a * 3 + i] += (wdet * n) * mom_val[i] + wdet * mgG;
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) r[60 + b] += wdet * divv * c_N1[q * 4 + b];
  }
}

// ------------------------------------------------------------- solid --
// St.Venant-Kirchhoff: E = (H + H^T + H^T H)/2 (cancellation-free),
// S = lam tr(E) I + 2 mu E, P = (I + H) S.
template <class S>
__device__ inline void svk_piola1(const S H[3][3], double mu, double lam, S Pk[3][3]) {
  S E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      E[i][j] = 0.5 * (H[i][j] + H[j][i]
                       + (H[0][i] * H[0][j] + H[1][i] * H[1][j] + H[2][i] * H[2][j]));
  const S trE = E[0][0] + E[1][1] + E[2][2];
  S Sm[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Sm[i][j] = (i == j ? lam * trE : S(0.0)) + 2.0 * mu * E[i][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Pk[i][j] = (H[i][0] + (i == 0 ? 1.0 : 0.0)) * Sm[0][j]
               + (H[i][1] + (i == 1 ? 1.0 : 0.0)) * Sm[1][j]
               + (H[i][2] + (i == 2 ? 1.0 : 0.0)) * Sm[2][j];
}

template <class T>
__device__ void solid_svk_residual(const T* u, const double* u0, const double* Jinv,
                                   double detJ, double vol, const SolidParams& P,
                                   int nq, T* r) {
  (void)vol;
  const double th = P.theta, rho = P.rho, dt = P.dt;
#pragma unroll
  for (int k = 0; k < 64; ++k) r[k] = T(0.0);

  for (int q = 0; q < nq; ++q) {
    double G[10][3];
    basis_gradients(q, Jinv, G);

    T d_q[3], v_q[3];
    double d0_q[3], v0_q[3];
    p2_value(q, u, d_q);
    p2_value(q, u + 30, v_q);
    p2_value(q, u0, d0_q);
    p2_value(q, u0 + 30, v0_q);

    T gd[3][3], Pn[3][3];
    double gd0[3][3], Po[3][3];
    p2_grad(u, G, gd);
    p2_grad(u0, G, gd0);
    svk_piola1(gd, P.mu, P.lam, Pn);
    svk_piola1(gd0, P.mu, P.lam, Po);

    T mom_val[3], kin[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mom_val[i] = rho / dt * (v_q[i] - v0_q[i]);
      kin[i] = rho * ((d_q[i] - d0_q[i]) / dt - (th * v_q[i] + (1.0 - th) * v0_q[i]));
    }

    const double wdet = c_wq[q] * detJ;
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const double n = c_N2[q * 10 + a];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        T mgG = T(0.0);
#pragma unroll
        for (int j = 0; j < 3; ++j) mgG += (th * Pn[i][j] + (1.0 - th) * Po[i][j]) * G[a][j];
        r[a * 3 + i] += (wdet * n) * kin[i];
        r[30 + a * 3 + i] += (wdet * n) * mom_val[i] + wdet * mgG;
      }
    }
  }
}
