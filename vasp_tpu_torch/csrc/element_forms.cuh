// One cell's monolithic FSI element residual, templated on its scalar type.
//
// Replaces the element math of vasp_tpu/fem/forms.py: make_fluid_kernel
// (ALE Navier-Stokes + continuity + Laplace lifting) and make_solid_kernel
// with vasp_tpu/fem/kinematics.py (total-Lagrangian St.Venant-Kirchhoff or
// compressible Mooney-Rivlin + kinematic row). The plain torch twin is
// vasp_tpu_torch/fem/forms.py with fem/kinematics.py; the expressions below
// follow it term for term. vasp_tpu gets S from jax.grad of the strain
// energy and its Jacobian from jax.jacfwd over that; here S is closed form
// for both materials and K3 is forward mode (Dual) over it.
//
// T is the type of the local state u and of the result r, S = Real<T> the
// type of everything else (u0, geometry, tables, parameters):
// - T = S = double gives the float64 residual (K1, K2);
// - T = S = float gives the float32 residual (K1/K2 f32: vasp_tpu's
//   residual(dtype=float32), f32 element work on f32-rounded inputs and
//   f32 tables); every literal and parameter is an S, so no operation of
//   this instance is promoted to double;
// - T = Dual (value + one tangent, over double), S = double gives one
//   column of the exact element Jacobian (K3), so the Jacobian is the
//   derivative of this very code, as jax.jacfwd is of the JAX kernel.
//
// The quadrature loop is outermost: per point the (10,3) physical basis
// gradients live in registers and are folded straight into the 64 local
// residual entries, so no (nq,10,3) array is ever materialized.
#pragma once

#include <cuda_runtime.h>

#define VT_NQ_MAX 125     // tet rule of degree 8 (5^3 points); degree 6 is 64
#define VT_NQ_MAX_F32 64  // degree <= 7: both table sets fit the 64 KB bank

// Quadrature and basis tables (weights, P1 values, P2 values, P2 reference
// gradients), uploaded by vt_set_element_tables, in float64 and rounded to
// float32. Every thread walks the quadrature points in the same order, so
// each read is a broadcast. Static: each source that includes this header
// (element_kernels.cu, postproc.cu) has its own copy, so the objects link
// into one library; only element_kernels.cu uploads and reads them.
static __constant__ double c_wq[VT_NQ_MAX];
static __constant__ double c_N1[VT_NQ_MAX * 4];
static __constant__ double c_N2[VT_NQ_MAX * 10];
static __constant__ double c_dN2[VT_NQ_MAX * 30];
static __constant__ float c_wq_f[VT_NQ_MAX_F32];
static __constant__ float c_N1_f[VT_NQ_MAX_F32 * 4];
static __constant__ float c_N2_f[VT_NQ_MAX_F32 * 10];
static __constant__ float c_dN2_f[VT_NQ_MAX_F32 * 30];

template <class S>
struct Tab;

template <>
struct Tab<double> {
  static __device__ __forceinline__ double wq(int i) { return c_wq[i]; }
  static __device__ __forceinline__ double N1(int i) { return c_N1[i]; }
  static __device__ __forceinline__ double N2(int i) { return c_N2[i]; }
  static __device__ __forceinline__ double dN2(int i) { return c_dN2[i]; }
};

template <>
struct Tab<float> {
  static __device__ __forceinline__ float wq(int i) { return c_wq_f[i]; }
  static __device__ __forceinline__ float N1(int i) { return c_N1_f[i]; }
  static __device__ __forceinline__ float N2(int i) { return c_N2_f[i]; }
  static __device__ __forceinline__ float dN2(int i) { return c_dN2_f[i]; }
};

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

// log1p on each scalar type: float's own (the float instance must stay
// free of float64 arithmetic), double's, and its derivative on a Dual
__device__ inline float vt_log1p(float a) { return log1pf(a); }
__device__ inline double vt_log1p(double a) { return log1p(a); }
__device__ inline Dual vt_log1p(Dual a) { return Dual(log1p(a.v), a.d / (1.0 + a.v)); }

// the type of everything a residual does not differentiate
template <class T>
struct RealOf { using type = T; };
template <>
struct RealOf<Dual> { using type = double; };
template <class T>
using Real = typename RealOf<T>::type;

// ------------------------------------------------------------ params --
// lift_sub: 0 = constant / small_constant (coefficient baked into
// lift_coeff), 1 = volume, 2 = volume_change. Other extrapolations,
// p_stab and gravity are refused by the Python wrapper. The derived
// constants (rho/dt, 1 - theta, 2 mu) are formed in double on the host and
// rounded once, as the plain version's Python floats are.
template <class S>
struct FluidParams {
  S rho, mu, dt, theta, one_m_theta, rho_dt, lift_coeff;
  int lift_sub;
};

// C01, C10, C11 and c0 = 2 C01 + 4 C10 serve the Mooney-Rivlin material
// only. The material is a template parameter of the solid residual (kSVK,
// kMooneyRivlin below), so each material is its own kernel instance.
template <class S>
struct SolidParams {
  S rho, mu, lam, dt, theta, one_m_theta, rho_dt, two_mu;
  S C01, C10, C11, c0;
};

template <class S>
inline FluidParams<S> make_fluid_params(double rho, double mu, double dt, double theta,
                                        double lift_coeff, int lift_sub) {
  return FluidParams<S>{S(rho), S(mu), S(dt), S(theta), S(1.0 - theta), S(rho / dt),
                        S(lift_coeff), lift_sub};
}

template <class S>
inline SolidParams<S> make_solid_params(double rho, double mu, double lam, double dt,
                                        double theta, double C01, double C10,
                                        double C11) {
  return SolidParams<S>{S(rho),       S(mu),         S(lam),      S(dt),
                        S(theta),     S(1.0 - theta), S(rho / dt), S(2.0 * mu),
                        S(C01),       S(C10),        S(C11),      S(2.0 * C01 + 4.0 * C10)};
}

// ------------------------------------------------------------ helpers --
template <class V>
__device__ inline V det3(const V A[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1])
       - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0])
       + A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

template <class V>
__device__ inline void inv3(const V A[3][3], V det, V Ai[3][3]) {
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
template <class S>
__device__ inline void basis_gradients(int q, const S* Jinv, S G[10][3]) {
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const int o = (q * 10 + a) * 3;
#pragma unroll
    for (int l = 0; l < 3; ++l)
      G[a][l] = Tab<S>::dN2(o) * Jinv[l] + Tab<S>::dN2(o + 1) * Jinv[3 + l]
              + Tab<S>::dN2(o + 2) * Jinv[6 + l];
  }
}

// value of a P2 vector field at q: out[i] = sum_a N2[q,a] c[a*3+i]
template <class S, class V>
__device__ inline void p2_value(int q, const V* c, V out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = V(S(0));
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const S n = Tab<S>::N2(q * 10 + a);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] += n * c[a * 3 + i];
  }
}

// gradient of a P2 vector field: g[i][j] = sum_a c[a*3+i] G[a][j]
template <class S, class V>
__device__ inline void p2_grad(const V* c, const S G[10][3], V g[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) g[i][j] = V(S(0));
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
__device__ void fluid_residual(const T* u, const Real<T>* u0, const Real<T>* Jinv,
                               Real<T> detJ, Real<T> vol, const FluidParams<Real<T>>& P,
                               int nq, T* r) {
  using S = Real<T>;
  const S th = P.theta, one_m_th = P.one_m_theta, rho = P.rho, mu = P.mu;
  const S zero = S(0), one = S(1);
#pragma unroll
  for (int k = 0; k < 64; ++k) r[k] = T(zero);

  for (int q = 0; q < nq; ++q) {
    S G[10][3];
    basis_gradients(q, Jinv, G);

    T d_q[3], v_q[3], p_q = T(zero);
    S d0_q[3], v0_q[3];
    p2_value<S>(q, u, d_q);
    p2_value<S>(q, u + 30, v_q);
    p2_value<S>(q, u0, d0_q);
    p2_value<S>(q, u0 + 30, v0_q);
#pragma unroll
    for (int b = 0; b < 4; ++b) p_q += Tab<S>::N1(q * 4 + b) * u[60 + b];
    T w_q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w_q[i] = (d_q[i] - d0_q[i]) / P.dt;

    T gd[3][3], gv[3][3];
    S gd0[3][3], gv0[3][3];
    p2_grad(u, G, gd);
    p2_grad(u + 30, G, gv);
    p2_grad(u0, G, gd0);
    p2_grad(u0 + 30, G, gv0);

    T F[3][3], Fi[3][3];
    S F0[3][3], Fi0[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        F[i][j] = gd[i][j] + (i == j ? one : zero);
        F0[i][j] = gd0[i][j] + (i == j ? one : zero);
      }
    const T Jd = det3(F);
    const S J0 = det3(F0);
    inv3(F, Jd, Fi);
    inv3(F0, J0, Fi0);

    // grad v F^-1, new and old
    T gvFi[3][3];
    S gvFi0[3][3];
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
      T conv_n = T(zero), conv_o = T(zero);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        conv_n += gvFi[i][j] * (v_q[j] - w_q[j]);
        conv_o += gvFi0[i][j] * (v0_q[j] - w_q[j]);
      }
      mom_val[i] = P.rho_dt * Jd * (v_q[i] - v0_q[i])
                 + rho * (th * Jd * conv_n + one_m_th * J0 * conv_o);
    }

    // momentum: gradient-test terms (viscous stress, implicit pressure)
    T mom_grad[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T sn = T(zero);
        S so = zero;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          sn += mu * (gvFi[i][j] + gvFi[j][i]) * Fi[k][j];
          so += mu * (gvFi0[i][j] + gvFi0[j][i]) * Fi0[k][j];
        }
        mom_grad[i][k] = th * Jd * sn + one_m_th * J0 * so - Jd * p_q * Fi[k][i];
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

    const S wdet = Tab<S>::wq(q) * detJ;
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const S n = Tab<S>::N2(q * 10 + a);
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
    for (int b = 0; b < 4; ++b) r[60 + b] += wdet * divv * Tab<S>::N1(q * 4 + b);
  }
}

// ------------------------------------------------------------- solid --
constexpr int kSVK = 0;
constexpr int kMooneyRivlin = 1;

// E = (H + H^T + H^T H)/2 (cancellation-free, exactly symmetric).
template <class S, class V>
__device__ inline void green_lagrange(const V H[3][3], V E[3][3]) {
  const S half = S(0.5);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      E[i][j] = half * (H[i][j] + H[j][i]
                        + (H[0][i] * H[0][j] + H[1][i] * H[1][j] + H[2][i] * H[2][j]));
}

// St.Venant-Kirchhoff: S = lam tr(E) I + 2 mu E.
template <class S, class V>
__device__ inline void svk_stress(const V E[3][3], const SolidParams<S>& P, V Sm[3][3]) {
  const V trE = E[0][0] + E[1][1] + E[2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Sm[i][j] = (i == j ? P.lam * trE : V(S(0))) + P.two_mu * E[i][j];
}

// Compressible Mooney-Rivlin, S = dW/dE in closed form (the derivation and
// the folding of the constant terms: fem/kinematics.py S_mooney_rivlin):
//   q = (tr E)^2 - tr E^2, x = 2 tr E + 2 q + 8 det E, lnJ = log1p(x)/2,
//   h = (c0 - lam lnJ) / (1 + x),
//   a = 4 C10 tr E + C11 (2 dI2 + dI1 (4 + 4 tr E))
//       + (c0 (2 q + 8 det E) + lam lnJ (1 + 2 tr E)) / (1 + x),
//   S = a I + (-4 C10 - 4 C11 dI1 + 2 h) E - 4 h cof(E).
// No O(1) term is left to cancel, so the float instance is as precise
// relative to |S| as E is; cof(E) is symmetric for symmetric E, so S is
// too, and the symmetrization vasp_tpu applies to its gradient is exact.
template <class S, class V>
__device__ inline void mr_stress(const V E[3][3], const SolidParams<S>& P, V Sm[3][3]) {
  const S one = S(1), two = S(2), four = S(4), eight = S(8);
  const V trE = E[0][0] + E[1][1] + E[2][2];
  V trE2 = V(S(0));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) trE2 += E[i][j] * E[j][i];
  const V q = trE * trE - trE2;
  const V detE = det3(E);
  const V x = two * trE + two * q + eight * detE;
  const V lnJ = S(0.5) * vt_log1p(x);
  const V dI1 = two * trE;
  const V dI2 = four * trE + two * q;
  const V inv = one / (one + x);
  const V h = (P.c0 - P.lam * lnJ) * inv;
  const V a = four * P.C10 * trE + P.C11 * (two * dI2 + dI1 * (four + four * trE))
            + (P.c0 * (two * q + eight * detE) + P.lam * lnJ * (one + two * trE)) * inv;
  const V b = -four * P.C10 - four * P.C11 * dI1 + two * h;
  const V g = -four * h;
  V cof[3][3];
  cof[0][0] = E[1][1] * E[2][2] - E[1][2] * E[2][1];
  cof[0][1] = E[0][2] * E[2][1] - E[0][1] * E[2][2];
  cof[0][2] = E[0][1] * E[1][2] - E[0][2] * E[1][1];
  cof[1][1] = E[0][0] * E[2][2] - E[0][2] * E[2][0];
  cof[1][2] = E[0][2] * E[1][0] - E[0][0] * E[1][2];
  cof[2][2] = E[0][0] * E[1][1] - E[0][1] * E[1][0];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      Sm[i][j] = (i == j ? a : V(S(0))) + b * E[i][j] + g * cof[i][j];
      if (j != i) Sm[j][i] = Sm[i][j];
    }
}

// P = (I + H) S, S of the material MAT.
template <int MAT, class S, class V>
__device__ inline void piola1(const V H[3][3], const SolidParams<S>& P, V Pk[3][3]) {
  const S zero = S(0), one = S(1);
  V E[3][3], Sm[3][3];
  green_lagrange<S>(H, E);
  if constexpr (MAT == kMooneyRivlin)
    mr_stress(E, P, Sm);
  else
    svk_stress(E, P, Sm);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Pk[i][j] = (H[i][0] + (i == 0 ? one : zero)) * Sm[0][j]
               + (H[i][1] + (i == 1 ? one : zero)) * Sm[1][j]
               + (H[i][2] + (i == 2 ? one : zero)) * Sm[2][j];
}

template <int MAT, class T>
__device__ void solid_residual(const T* u, const Real<T>* u0, const Real<T>* Jinv,
                               Real<T> detJ, Real<T> vol, const SolidParams<Real<T>>& P,
                               int nq, T* r) {
  using S = Real<T>;
  (void)vol;
  const S th = P.theta, one_m_th = P.one_m_theta, rho = P.rho;
  const S zero = S(0);
#pragma unroll
  for (int k = 0; k < 64; ++k) r[k] = T(zero);

  for (int q = 0; q < nq; ++q) {
    S G[10][3];
    basis_gradients(q, Jinv, G);

    T d_q[3], v_q[3];
    S d0_q[3], v0_q[3];
    p2_value<S>(q, u, d_q);
    p2_value<S>(q, u + 30, v_q);
    p2_value<S>(q, u0, d0_q);
    p2_value<S>(q, u0 + 30, v0_q);

    T gd[3][3], Pn[3][3];
    S gd0[3][3], Po[3][3];
    p2_grad(u, G, gd);
    p2_grad(u0, G, gd0);
    piola1<MAT>(gd, P, Pn);
    piola1<MAT>(gd0, P, Po);

    T mom_val[3], kin[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mom_val[i] = P.rho_dt * (v_q[i] - v0_q[i]);
      kin[i] = rho * ((d_q[i] - d0_q[i]) / P.dt - (th * v_q[i] + one_m_th * v0_q[i]));
    }

    const S wdet = Tab<S>::wq(q) * detJ;
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const S n = Tab<S>::N2(q * 10 + a);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        T mgG = T(zero);
#pragma unroll
        for (int j = 0; j < 3; ++j) mgG += (th * Pn[i][j] + one_m_th * Po[i][j]) * G[a][j];
        r[a * 3 + i] += (wdet * n) * kin[i];
        r[30 + a * 3 + i] += (wdet * n) * mom_val[i] + wdet * mgG;
      }
    }
  }
}
