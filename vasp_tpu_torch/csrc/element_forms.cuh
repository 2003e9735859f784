// One cell's monolithic FSI element residual, templated on its scalar type
// and factored at the quadrature points.
//
// Replaces the element math of vasp_tpu/fem/forms.py: make_fluid_kernel
// (ALE Navier-Stokes + continuity, with or without the Brezzi-Pitkaranta
// pressure stabilization, + Laplace, elastic or no mesh lifting; the
// biharmonic lifting's element part is the Laplace one) and
// make_solid_kernel with vasp_tpu/fem/kinematics.py (total-Lagrangian
// St.Venant-Kirchhoff or compressible Mooney-Rivlin, gravity, + kinematic
// row). The plain torch twin is
// vasp_tpu_torch/fem/forms.py with fem/kinematics.py; the expressions below
// follow it term for term. vasp_tpu gets S from jax.grad of the strain
// energy and its Jacobian from jax.jacfwd over that; here S is closed form
// for both materials and K3 is forward mode (Dual) over it.
//
// Both forms read the cell's local state at quadrature point q only
// through the point state s_q (the values and physical gradients of d and
// v, the value of p: point_state), and write the residual only through
// point fluxes, each tested against a P2 value, a P2 gradient or a P1
// value (test_contract):
//   r = sum_q w_q detJ Phi_out,q^T flux(s_q, s0_q),   s_q = Phi_in,q u.
// fluid_point_flux and solid_point_flux are the forms' physics, with the
// part that depends on s0 alone apart (fluid_old, solid_old). K1/K2 and
// K13 run state, flux and contraction per point (cell_residual); K3
// (element_kernels.cu) differentiates the same flux functions by forward
// mode over the 25 (solid 15) point quantities and contracts
//   A_e = sum_q w_q detJ Phi_out,q^T D_q Phi_in,q,   D_q = d flux / d s_q.
//
// T is the type of the point state (from u), T0 the type of the previous
// state u0, TR the type of the result r, S = Real<T> the type of
// everything else (geometry, tables, parameters):
// - T = T0 = TR = S = double gives the float64 residual (K1, K2);
// - T = T0 = TR = S = float gives the float32 residual (K1/K2 f32:
//   vasp_tpu's residual(dtype=float32), f32 element work on f32-rounded
//   inputs and f32 tables); every literal and parameter is an S, so no
//   operation of this instance is promoted to double;
// - T = Dual (value + one tangent, over double), T0 = S = double gives one
//   column of D_q (K3), so the Jacobian is the derivative of this very
//   code, as jax.jacfwd is of the JAX kernel;
// - T = Jet3 (an order-3 Taylor series over float), S = float, T0 = float
//   or Jet3, TR = DeltaSum gives K13's delta of the cell along u's
//   series (and u0's, for T0 = Jet3): vasp_tpu's residual_delta and
//   residual_delta2, whose jax.experimental.jet runs the same forms on
//   float32 series.
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
// float32. Every thread of K1/K2/K13 walks the quadrature points in the
// same order, so each read is a broadcast. Static: each source that
// includes this header (element_kernels.cu, delta_kernels.cu, postproc.cu)
// has its own copy, so the objects link into one library;
// element_kernels.cu uploads and reads both sets, delta_kernels.cu the
// float32 one. A rule of more points than a bank holds is read from
// device memory instead (GlobalTab below).
static __constant__ double c_wq[VT_NQ_MAX];
static __constant__ double c_N1[VT_NQ_MAX * 4];
static __constant__ double c_N2[VT_NQ_MAX * 10];
static __constant__ double c_dN2[VT_NQ_MAX * 30];
static __constant__ float c_wq_f[VT_NQ_MAX_F32];
static __constant__ float c_N1_f[VT_NQ_MAX_F32 * 4];
static __constant__ float c_N2_f[VT_NQ_MAX_F32 * 10];
static __constant__ float c_dN2_f[VT_NQ_MAX_F32 * 30];

// Copy the quadrature tables (host pointers: wq (nq,), N1 (nq,4), N2
// (nq,10), dN2 (nq,10,3), float64, C-contiguous) into this source's
// constant memory: the float64 set when f64 is true and nq <= VT_NQ_MAX,
// and their float32 roundings where nq <= VT_NQ_MAX_F32; a set that does
// not fit is left out (its kernels read device memory). Static, as the
// tables are: it fills the copy of the source that calls it.
static inline int upload_element_tables(const double* wq, const double* N1,
                                        const double* N2, const double* dN2, int nq,
                                        bool f64) {
  cudaError_t e;
  if (f64 && nq <= VT_NQ_MAX) {
    if ((e = cudaMemcpyToSymbol(c_wq, wq, sizeof(double) * nq)) != cudaSuccess) return (int)e;
    if ((e = cudaMemcpyToSymbol(c_N1, N1, sizeof(double) * nq * 4)) != cudaSuccess) return (int)e;
    if ((e = cudaMemcpyToSymbol(c_N2, N2, sizeof(double) * nq * 10)) != cudaSuccess) return (int)e;
    if ((e = cudaMemcpyToSymbol(c_dN2, dN2, sizeof(double) * nq * 30)) != cudaSuccess) return (int)e;
  }
  if (nq <= VT_NQ_MAX_F32) {
    float f[VT_NQ_MAX_F32 * 30];
    for (int i = 0; i < nq; ++i) f[i] = (float)wq[i];
    if ((e = cudaMemcpyToSymbol(c_wq_f, f, sizeof(float) * nq)) != cudaSuccess) return (int)e;
    for (int i = 0; i < nq * 4; ++i) f[i] = (float)N1[i];
    if ((e = cudaMemcpyToSymbol(c_N1_f, f, sizeof(float) * nq * 4)) != cudaSuccess) return (int)e;
    for (int i = 0; i < nq * 10; ++i) f[i] = (float)N2[i];
    if ((e = cudaMemcpyToSymbol(c_N2_f, f, sizeof(float) * nq * 10)) != cudaSuccess) return (int)e;
    for (int i = 0; i < nq * 30; ++i) f[i] = (float)dN2[i];
    if ((e = cudaMemcpyToSymbol(c_dN2_f, f, sizeof(float) * nq * 30)) != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Where the forms read the tables: tb.wq(i), tb.N1(i), tb.N2(i), tb.dN2(i)
// with the flat indices of the host arrays above.
// ConstTab: this source's constant bank (the rule must fit it).
template <class S>
struct ConstTab;

template <>
struct ConstTab<double> {
  static constexpr int sum_block = 0;
  __host__ __device__ ConstTab(const void*, int) {}
  __device__ __forceinline__ double wq(int i) const { return c_wq[i]; }
  __device__ __forceinline__ double N1(int i) const { return c_N1[i]; }
  __device__ __forceinline__ double N2(int i) const { return c_N2[i]; }
  __device__ __forceinline__ double dN2(int i) const { return c_dN2[i]; }
};

template <>
struct ConstTab<float> {
  static constexpr int sum_block = 0;
  __host__ __device__ ConstTab(const void*, int) {}
  __device__ __forceinline__ float wq(int i) const { return c_wq_f[i]; }
  __device__ __forceinline__ float N1(int i) const { return c_N1_f[i]; }
  __device__ __forceinline__ float N2(int i) const { return c_N2_f[i]; }
  __device__ __forceinline__ float dN2(int i) const { return c_dN2_f[i]; }
};

// GlobalTab: one packed table in device memory, [wq | N1 | N2 | dN2] of
// nq * 45 entries in S (kernels/element.py table_pack), read through the
// read-only path; any number of points.
// sum_block: the residuals sum the points' contributions in blocks of this
// many points and then the blocks (0: one running sum). The device-memory
// route serves the rules of more than 64 points, over which one running
// float32 sum rounds away the accuracy of the plain version's sums.
template <class S>
struct GlobalTab {
  static constexpr int sum_block = 8;
  const S* __restrict__ p;
  int nq;
  __host__ __device__ GlobalTab(const void* tables, int n)
      : p(static_cast<const S*>(tables)), nq(n) {}
  __device__ __forceinline__ S wq(int i) const { return __ldg(p + i); }
  __device__ __forceinline__ S N1(int i) const { return __ldg(p + nq + i); }
  __device__ __forceinline__ S N2(int i) const { return __ldg(p + 5 * nq + i); }
  __device__ __forceinline__ S dN2(int i) const { return __ldg(p + 15 * nq + i); }
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
// A quotient takes one reciprocal, for its value and its tangent: the
// value is within an ulp of the correctly rounded one, which moves K3's
// derivatives (the only use of Dual) by rounding only, at half the
// divides of two quotients.
__device__ inline Dual operator/(Dual a, Dual b) {
  const double r = 1.0 / b.v, q = a.v * r;
  return Dual(q, (a.d - q * b.d) * r);
}
__device__ inline Dual operator/(Dual a, double b) {
  const double r = 1.0 / b;
  return Dual(a.v * r, a.d * r);
}
__device__ inline Dual operator/(double a, Dual b) {
  const double r = 1.0 / b.v, q = a * r;
  return Dual(q, -q * b.d * r);
}
__device__ inline Dual& operator+=(Dual& a, Dual b) { a = a + b; return a; }

// ----------------------------------------------------------------- jet --
// A truncated Taylor series over float, x(t) = v + c1 t + c2 t^2 + c3 t^3
// with normalised coefficients (c_k = x^(k)(0) / k!), the arithmetic of
// K13. Every operation keeps the terms up to t^3: sums term by term,
// products as the Cauchy product, quotients and log1p by their standard
// recurrences. All of it is float arithmetic (f-suffixed literals), so
// the K13 instances stay free of float64 work as the f32 residuals do.
struct Jet3 {
  float v, c1, c2, c3;
  __device__ Jet3() {}
  __device__ Jet3(float x) : v(x), c1(0.f), c2(0.f), c3(0.f) {}
  __device__ Jet3(float x, float a, float b, float c) : v(x), c1(a), c2(b), c3(c) {}
};

__device__ inline Jet3 operator+(Jet3 a, Jet3 b) {
  return Jet3(a.v + b.v, a.c1 + b.c1, a.c2 + b.c2, a.c3 + b.c3);
}
__device__ inline Jet3 operator+(Jet3 a, float b) { return Jet3(a.v + b, a.c1, a.c2, a.c3); }
__device__ inline Jet3 operator+(float a, Jet3 b) { return Jet3(a + b.v, b.c1, b.c2, b.c3); }
__device__ inline Jet3 operator-(Jet3 a, Jet3 b) {
  return Jet3(a.v - b.v, a.c1 - b.c1, a.c2 - b.c2, a.c3 - b.c3);
}
__device__ inline Jet3 operator-(Jet3 a, float b) { return Jet3(a.v - b, a.c1, a.c2, a.c3); }
__device__ inline Jet3 operator-(float a, Jet3 b) { return Jet3(a - b.v, -b.c1, -b.c2, -b.c3); }
__device__ inline Jet3 operator-(Jet3 a) { return Jet3(-a.v, -a.c1, -a.c2, -a.c3); }
__device__ inline Jet3 operator*(Jet3 a, Jet3 b) {
  return Jet3(a.v * b.v, a.v * b.c1 + a.c1 * b.v, a.v * b.c2 + a.c1 * b.c1 + a.c2 * b.v,
              a.v * b.c3 + a.c1 * b.c2 + a.c2 * b.c1 + a.c3 * b.v);
}
__device__ inline Jet3 operator*(Jet3 a, float b) {
  return Jet3(a.v * b, a.c1 * b, a.c2 * b, a.c3 * b);
}
__device__ inline Jet3 operator*(float a, Jet3 b) {
  return Jet3(a * b.v, a * b.c1, a * b.c2, a * b.c3);
}
// q = a / b from q b = a: q_k = (a_k - sum_{j<k} q_j b_{k-j}) / b_0
__device__ inline Jet3 operator/(Jet3 a, Jet3 b) {
  const float q0 = a.v / b.v;
  const float q1 = (a.c1 - q0 * b.c1) / b.v;
  const float q2 = (a.c2 - q0 * b.c2 - q1 * b.c1) / b.v;
  const float q3 = (a.c3 - q0 * b.c3 - q1 * b.c2 - q2 * b.c1) / b.v;
  return Jet3(q0, q1, q2, q3);
}
__device__ inline Jet3 operator/(Jet3 a, float b) {
  return Jet3(a.v / b, a.c1 / b, a.c2 / b, a.c3 / b);
}
__device__ inline Jet3 operator/(float a, Jet3 b) {
  const float q0 = a / b.v;
  const float q1 = -(q0 * b.c1) / b.v;
  const float q2 = -(q0 * b.c2 + q1 * b.c1) / b.v;
  const float q3 = -(q0 * b.c3 + q1 * b.c2 + q2 * b.c1) / b.v;
  return Jet3(q0, q1, q2, q3);
}
__device__ inline Jet3& operator+=(Jet3& a, Jet3 b) { a = a + b; return a; }

// K13's result entry. vasp_tpu's residual_delta returns the sum of the
// terms jax.experimental.jet gives for a series [du, 0, 0]; those terms are
// the derivatives y_k = k! c_k, not the coefficients, so its delta is
// y1 + y2 + y3 = c1 + 2 c2 + 6 c3 (while R(A + du) - R(A) ~ c1 + c2 + c3).
// The weights 1, 2, 6 live here and only here. The entry is linear in the
// cell's contributions, so each contribution is folded into one float as
// it is added: the cell keeps 64 floats of result instead of 64 jets.
__device__ inline float jet_delta(const Jet3& a) { return a.c1 + 2.f * a.c2 + 6.f * a.c3; }

struct DeltaSum {
  float s;
  __device__ DeltaSum() {}
  __device__ explicit DeltaSum(float x) : s(x) {}
  __device__ DeltaSum& operator+=(const Jet3& a) {
    s += jet_delta(a);
    return *this;
  }
  __device__ DeltaSum& operator+=(const DeltaSum& a) {
    s += a.s;
    return *this;
  }
};

// log1p on each scalar type: float's own (the float instance must stay
// free of float64 arithmetic), double's, its derivative on a Dual, and
// on a Jet3 the series of y = log(w), w = 1 + x, from w y' = w'
__device__ inline float vt_log1p(float a) { return log1pf(a); }
__device__ inline double vt_log1p(double a) { return log1p(a); }
__device__ inline Dual vt_log1p(Dual a) { return Dual(log1p(a.v), a.d / (1.0 + a.v)); }
__device__ inline Jet3 vt_log1p(Jet3 a) {
  const float w0 = 1.f + a.v;
  const float y1 = a.c1 / w0;
  const float y2 = (a.c2 - 0.5f * a.c1 * y1) / w0;
  const float y3 = (a.c3 - (2.f / 3.f) * a.c1 * y2 - (1.f / 3.f) * a.c2 * y1) / w0;
  return Jet3(log1pf(a.v), y1, y2, y3);
}

// pow on the real types (the pressure stabilization's h^2 = (6 vol)^(2/3))
__device__ inline float vt_pow(float a, float b) { return powf(a, b); }
__device__ inline double vt_pow(double a, double b) { return pow(a, b); }

// the type of everything a residual does not differentiate
template <class T>
struct RealOf { using type = T; };
template <>
struct RealOf<Dual> { using type = double; };
template <>
struct RealOf<Jet3> { using type = float; };
template <class T>
using Real = typename RealOf<T>::type;

// ------------------------------------------------------------ params --
// The mesh lifting of the fluid residual, a template parameter (each mode
// is its own kernel instance): Laplace (extrapolation "laplace", and the
// first L application of "biharmonic"), elastic, or none
// ("no_extrapolation": zero d rows).
constexpr int kLiftLaplace = 0;
constexpr int kLiftElastic = 1;
constexpr int kLiftNone = 2;

// lift_sub (Laplace lifting): 0 = constant / small_constant and every other
// sub-type (coefficient baked into lift_coeff), 1 = volume, 2 =
// volume_change. p_stab = 0 skips the pressure stabilization. The derived
// constants (rho/dt, 1 - theta, 2 mu) are formed in double on the host and
// rounded once, as the plain version's Python floats are.
template <class S>
struct FluidParams {
  S rho, mu, dt, theta, one_m_theta, rho_dt, lift_coeff, p_stab;
  int lift_sub;
};

// C01, C10, C11 and c0 = 2 C01 + 4 C10 serve the Mooney-Rivlin material
// only. The material is a template parameter of the solid residual (kSVK,
// kMooneyRivlin below), so each material is its own kernel instance. g is
// the gravity vector of the body force rho g (zero when none is given:
// subtracting rho * 0 leaves the momentum term bitwise as it was).
template <class S>
struct SolidParams {
  S rho, mu, lam, dt, theta, one_m_theta, rho_dt, two_mu;
  S C01, C10, C11, c0;
  S g[3];
};

template <class S>
inline FluidParams<S> make_fluid_params(double rho, double mu, double dt, double theta,
                                        double lift_coeff, int lift_sub, double p_stab) {
  return FluidParams<S>{S(rho),        S(mu),      S(dt),         S(theta),
                        S(1.0 - theta), S(rho / dt), S(lift_coeff), S(p_stab),
                        lift_sub};
}

template <class S>
inline SolidParams<S> make_solid_params(double rho, double mu, double lam, double dt,
                                        double theta, double C01, double C10,
                                        double C11, double gx = 0.0, double gy = 0.0,
                                        double gz = 0.0) {
  return SolidParams<S>{S(rho),       S(mu),         S(lam),      S(dt),
                        S(theta),     S(1.0 - theta), S(rho / dt), S(2.0 * mu),
                        S(C01),       S(C10),        S(C11),      S(2.0 * C01 + 4.0 * C10),
                        {S(gx), S(gy), S(gz)}};
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
template <class S, class Tb>
__device__ inline void basis_gradients(const Tb& tb, int q, const S* Jinv, S G[10][3]) {
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const int o = (q * 10 + a) * 3;
#pragma unroll
    for (int l = 0; l < 3; ++l)
      G[a][l] = tb.dN2(o) * Jinv[l] + tb.dN2(o + 1) * Jinv[3 + l] + tb.dN2(o + 2) * Jinv[6 + l];
  }
}

// ------------------------------------------------------------- slots --
// The point state and the point fluxes share one layout of 25 slots:
// slot(X, i, 0) is the value and slot(X, i, 1 + j) the physical gradient
// d/dx_j of component i of field X (0 = d, 1 = v), kPSlot the pressure.
// A flux in slot(Y, i, 0) is tested against N2[a] on row 30 Y + 3 a + i,
// the three in slot(Y, i, 1 + k) against G[a][k] on the same row, and one
// in kPSlot against N1[b] on row 60 + b. Each form (its cell type below)
// says which slots it reads, state_on(X, b) and p_state, and which it
// writes, flux_on(Y, b) and p_flux; a field's three gradient slots are on
// or off together. A slot that is off is never read or written.
constexpr int kSlots = 25;
constexpr int kPSlot = 24;

__host__ __device__ constexpr int slot(int X, int i, int b) { return X * 12 + i * 4 + b; }

template <class Cell>
__host__ __device__ constexpr bool state_slot_on(int sl) {
  return sl == kPSlot ? Cell::p_state : Cell::state_on(sl / 12, sl % 4);
}

template <class Cell>
__host__ __device__ constexpr bool flux_slot_on(int sl) {
  return sl == kPSlot ? Cell::p_flux : Cell::flux_on(sl / 12, sl % 4);
}

// the number of point quantities the form reads (K3's tangents a point)
template <class Cell>
__host__ __device__ constexpr int n_states() {
  int n = 0;
  for (int sl = 0; sl < kSlots; ++sl) n += state_slot_on<Cell>(sl) ? 1 : 0;
  return n;
}

// the point state of the local vector c (u or u0) at q, in the slots the
// form reads: values sum_a N2[q,a] c[30 X + 3 a + i], gradients sum_a
// c[30 X + 3 a + i] G[a][j], the pressure sum_b N1[q,b] c[60 + b]
template <class Cell, class S, class Tb, class V>
__device__ inline void point_state(const Tb& tb, int q, const V* c, const S G[10][3], V* s) {
#pragma unroll
  for (int sl = 0; sl < kPSlot; ++sl) {
    if (!state_slot_on<Cell>(sl)) continue;
    const int X = sl / 12, i = (sl % 12) / 4, b = sl % 4;
    V x = V(S(0));
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      if (b == 0)
        x += tb.N2(q * 10 + a) * c[X * 30 + a * 3 + i];
      else
        x += c[X * 30 + a * 3 + i] * G[a][b - 1];
    }
    s[sl] = x;
  }
  if (Cell::p_state) {
    V p = V(S(0));
#pragma unroll
    for (int b = 0; b < 4; ++b) p += tb.N1(q * 4 + b) * c[60 + b];
    s[kPSlot] = p;
  }
}

// r += wdet Phi_out^T f at q: each flux the form writes, tested
template <class Cell, class S, class Tb, class T, class TR>
__device__ inline void test_contract(const Tb& tb, int q, const S G[10][3], S wdet, const T* f,
                                     TR* r) {
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const S n = tb.N2(q * 10 + a);
#pragma unroll
    for (int Y = 0; Y < 2; ++Y)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const bool val = Cell::flux_on(Y, 0), grad = Cell::flux_on(Y, 1);
        const int o = slot(Y, i, 0);
        TR& ri = r[Y * 30 + a * 3 + i];
        if (val && grad)
          ri += (wdet * n) * f[o]
              + wdet * (f[o + 1] * G[a][0] + f[o + 2] * G[a][1] + f[o + 3] * G[a][2]);
        else if (val)
          ri += (wdet * n) * f[o];
        else if (grad)
          ri += wdet * (f[o + 1] * G[a][0] + f[o + 2] * G[a][1] + f[o + 3] * G[a][2]);
      }
  }
  if (Cell::p_flux) {
#pragma unroll
    for (int b = 0; b < 4; ++b) r[60 + b] += wdet * f[kPSlot] * tb.N1(q * 4 + b);
  }
}

// ------------------------------------------------------------- fluid --
// The previous state's part of the fluid's point flux, which depends on
// s0 alone (K3 forms it once a point, not once a tangent): J0 = det F0,
// grad v0 F0^-1 and the old viscous term mu (grad v0 F0^-1 + its
// transpose) F0^-T.
template <class T0>
struct FluidOld {
  T0 J0, gvFi0[3][3], so[3][3];
};

template <class T0, class S>
__device__ inline FluidOld<T0> fluid_old(const T0* s0, const FluidParams<S>& P) {
  const S zero = S(0), one = S(1);
  FluidOld<T0> o;
  T0 F0[3][3], Fi0[3][3], gv0[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gv0[i][j] = s0[slot(1, i, 1 + j)];
      F0[i][j] = s0[slot(0, i, 1 + j)] + (i == j ? one : zero);
    }
  o.J0 = det3(F0);
  inv3(F0, o.J0, Fi0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.gvFi0[i][j] = gv0[i][0] * Fi0[0][j] + gv0[i][1] * Fi0[1][j] + gv0[i][2] * Fi0[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T0 so = T0(zero);
#pragma unroll
      for (int j = 0; j < 3; ++j) so += P.mu * (o.gvFi0[i][j] + o.gvFi0[j][i]) * Fi0[k][j];
      o.so[i][k] = so;
    }
  return o;
}

// The fluid's point fluxes from its point state s (T), the previous one
// s0 (T0) and its part o: on the d rows' gradients the lifting's (a_q
// grad d, or the elastic sigma, or none), on the v rows the momentum's
// value-test terms (mass + theta-split convection) and gradient-test terms
// (viscous stress, implicit pressure), on the p rows the continuity
// J tr(grad v F^-1). LIFT: kLiftLaplace, kLiftElastic or kLiftNone.
template <int LIFT, class T, class T0>
__device__ inline void fluid_point_flux(const T* s, const T0* s0, const FluidOld<T0>& o,
                                        Real<T> vol, const FluidParams<Real<T>>& P, T* f) {
  using S = Real<T>;
  const S th = P.theta, one_m_th = P.one_m_theta, rho = P.rho, mu = P.mu;
  const S zero = S(0), one = S(1);

  T v_q[3], w_q[3], gd[3][3], gv[3][3];
  T0 v0_q[3];
  T F[3][3], Fi[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v_q[i] = s[slot(1, i, 0)];
    v0_q[i] = s0[slot(1, i, 0)];
    w_q[i] = (s[slot(0, i, 0)] - s0[slot(0, i, 0)]) / P.dt;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gd[i][j] = s[slot(0, i, 1 + j)];
      gv[i][j] = s[slot(1, i, 1 + j)];
      F[i][j] = gd[i][j] + (i == j ? one : zero);
    }
  }
  const T p_q = s[kPSlot];
  const T Jd = det3(F);
  const T0 J0 = o.J0;
  inv3(F, Jd, Fi);

  // grad v F^-1 (the old one is o's)
  T gvFi[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gvFi[i][j] = gv[i][0] * Fi[0][j] + gv[i][1] * Fi[1][j] + gv[i][2] * Fi[2][j];

  // momentum: value-test terms (mass + theta-split convection)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T conv_n = T(zero), conv_o = T(zero);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      conv_n += gvFi[i][j] * (v_q[j] - w_q[j]);
      conv_o += o.gvFi0[i][j] * (v0_q[j] - w_q[j]);
    }
    f[slot(1, i, 0)] = P.rho_dt * Jd * (v_q[i] - v0_q[i])
                     + rho * (th * Jd * conv_n + one_m_th * J0 * conv_o);
  }

  // momentum: gradient-test terms (viscous stress, implicit pressure)
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T sn = T(zero);
#pragma unroll
      for (int j = 0; j < 3; ++j) sn += mu * (gvFi[i][j] + gvFi[j][i]) * Fi[k][j];
      f[slot(1, i, 1 + k)] = th * Jd * sn + one_m_th * J0 * o.so[i][k] - Jd * p_q * Fi[k][i];
    }

  // continuity: J tr(grad v F^-1)
  f[kPSlot] = Jd * (gvFi[0][0] + gvFi[1][1] + gvFi[2][2]);

  if constexpr (LIFT == kLiftLaplace) {
    // Laplace lifting, a_q grad d
    T a_q;
    if (P.lift_sub == 2)
      a_q = P.lift_coeff / Jd;
    else if (P.lift_sub == 1)
      a_q = T(P.lift_coeff / vol);
    else
      a_q = T(P.lift_coeff);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) f[slot(0, i, 1 + k)] = a_q * gd[i][k];
  } else if constexpr (LIFT == kLiftElastic) {
    // elastic lifting: sigma = 2 eps(d) + tr(eps(d)) I = gd + gd^T + tr(gd) I
    const T tr_gd = gd[0][0] + gd[1][1] + gd[2][2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T sg = gd[i][k] + gd[k][i];
        if (i == k) sg += tr_gd;
        f[slot(0, i, 1 + k)] = P.lift_coeff * sg;
      }
  }
}

// Brezzi-Pitkaranta pressure stabilization, (p_stab h^2 / mu) vol
// G1 G1^T p with G1 = dN1 Jinv the constant P1 gradients and h^2 =
// (6 vol)^(2/3): fills G1 and returns the coefficient
template <class S>
__device__ inline S pstab_setup(const S* Jinv, S vol, const FluidParams<S>& P, S G1[4][3]) {
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    G1[1][l] = Jinv[l];
    G1[2][l] = Jinv[3 + l];
    G1[3][l] = Jinv[6 + l];
    G1[0][l] = -Jinv[l] - Jinv[3 + l] - Jinv[6 + l];
  }
  const S h2 = vt_pow(S(6) * vol, S(2.0 / 3.0));
  return P.p_stab * h2 / P.mu * vol;
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

// The previous state's part of the solid's point flux: its first
// Piola-Kirchhoff stress.
template <class T0>
struct SolidOld {
  T0 Po[3][3];
};

template <int MAT, class T0, class S>
__device__ inline SolidOld<T0> solid_old(const T0* s0, const SolidParams<S>& P) {
  SolidOld<T0> o;
  T0 gd0[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) gd0[i][j] = s0[slot(0, i, 1 + j)];
  piola1<MAT>(gd0, P, o.Po);
  return o;
}

// The solid's point fluxes: the kinematic row's value-test term on the d
// rows, on the v rows the momentum's value-test term (mass, gravity) and
// the theta-split first Piola-Kirchhoff stress on the gradients (the old
// one o's).
template <int MAT, class T, class T0>
__device__ inline void solid_point_flux(const T* s, const T0* s0, const SolidOld<T0>& o,
                                        const SolidParams<Real<T>>& P, T* f) {
  const auto th = P.theta, one_m_th = P.one_m_theta, rho = P.rho;
  T gd[3][3], Pn[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) gd[i][j] = s[slot(0, i, 1 + j)];
  piola1<MAT>(gd, P, Pn);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T v = s[slot(1, i, 0)];
    const T0 v0 = s0[slot(1, i, 0)];
    f[slot(1, i, 0)] = P.rho_dt * (v - v0) - rho * P.g[i];
    f[slot(0, i, 0)] = rho * ((s[slot(0, i, 0)] - s0[slot(0, i, 0)]) / P.dt
                              - (th * v + one_m_th * v0));
#pragma unroll
    for (int j = 0; j < 3; ++j) f[slot(1, i, 1 + j)] = th * Pn[i][j] + one_m_th * o.Po[i][j];
  }
}

// ------------------------------------------------------------- cells --
// The kernels' view of a block: its parameters, which slots its form
// reads and writes, its point flux, and the terms it adds once a cell.
// A fluid cell with the mesh lifting LIFT (kLiftLaplace, kLiftElastic,
// kLiftNone): it reads d, grad d, v, grad v and p, and writes every flux
// but the d rows' values (and their gradients without lifting).
template <class S, int LIFT>
struct FluidCell {
  FluidParams<S> p;
  static constexpr bool p_state = true, p_flux = true;
  __host__ __device__ static constexpr bool state_on(int, int) { return true; }
  __host__ __device__ static constexpr bool flux_on(int Y, int b) {
    return Y == 1 || (LIFT != kLiftNone && b > 0);
  }
};

template <class S, int LIFT>
inline FluidCell<S, LIFT> fluid_cell(double rho, double mu, double dt, double theta,
                                     double lift_coeff, int lift_sub, double p_stab) {
  return FluidCell<S, LIFT>{
      make_fluid_params<S>(rho, mu, dt, theta, lift_coeff, lift_sub, p_stab)};
}

template <class S, int LIFT, class T0>
__device__ inline FluidOld<T0> old_terms(const FluidCell<S, LIFT>& C, const T0* s0) {
  return fluid_old(s0, C.p);
}

template <class S, int LIFT, class T, class T0>
__device__ inline void point_flux(const FluidCell<S, LIFT>& C, const T* s, const T0* s0,
                                  const FluidOld<T0>& o, S vol, T* f) {
  fluid_point_flux<LIFT>(s, s0, o, vol, C.p, f);
}

// the pressure stabilization, once a cell: it reads only p and the geometry
template <class S, int LIFT, class T, class TR>
__device__ inline void cell_tail(const FluidCell<S, LIFT>& C, const S* Jinv, S vol, const T* u,
                                 TR* r) {
  if (C.p.p_stab == S(0)) return;
  S G1[4][3];
  const S c = pstab_setup(Jinv, vol, C.p, G1);
  T gp[3];
#pragma unroll
  for (int l = 0; l < 3; ++l)
    gp[l] = u[60] * G1[0][l] + u[61] * G1[1][l] + u[62] * G1[2][l] + u[63] * G1[3][l];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    r[60 + b] += c * (G1[b][0] * gp[0] + G1[b][1] * gp[1] + G1[b][2] * gp[2]);
}

// A solid cell of material MAT (kSVK or kMooneyRivlin): it reads d, grad d
// and v, and writes the d rows' values and the v rows; its p rows are 0.
template <class S, int MAT>
struct SolidCell {
  SolidParams<S> p;
  static constexpr bool p_state = false, p_flux = false;
  __host__ __device__ static constexpr bool state_on(int X, int b) { return X == 0 || b == 0; }
  __host__ __device__ static constexpr bool flux_on(int Y, int b) { return Y == 1 || b == 0; }
};

template <class S, int MAT>
inline SolidCell<S, MAT> solid_cell(double rho, double mu, double lam, double dt,
                                    double theta, double C01, double C10, double C11,
                                    double gx, double gy, double gz) {
  return SolidCell<S, MAT>{
      make_solid_params<S>(rho, mu, lam, dt, theta, C01, C10, C11, gx, gy, gz)};
}

template <class S, int MAT, class T0>
__device__ inline SolidOld<T0> old_terms(const SolidCell<S, MAT>& C, const T0* s0) {
  return solid_old<MAT>(s0, C.p);
}

template <class S, int MAT, class T, class T0>
__device__ inline void point_flux(const SolidCell<S, MAT>& C, const T* s, const T0* s0,
                                  const SolidOld<T0>& o, S, T* f) {
  solid_point_flux<MAT>(s, s0, o, C.p, f);
}

template <class S, int MAT, class T, class TR>
__device__ inline void cell_tail(const SolidCell<S, MAT>&, const S*, S, const T*, TR*) {}

// One cell's residual r (64 entries, TR) from u (T) and u0 (T0): per point
// the state, the form's flux and the test contraction, then the cell's
// once-a-cell terms. Tb: ConstTab or GlobalTab (with Tb::sum_block points
// summed apart before they join r).
template <class Cell, class Tb, class T, class T0, class TR>
__device__ void cell_residual(const Cell& C, const Tb& tb, const T* u, const T0* u0,
                              const Real<T>* Jinv, Real<T> detJ, Real<T> vol, int nq, TR* r) {
  using S = Real<T>;
  constexpr int B = Tb::sum_block;
#pragma unroll
  for (int k = 0; k < 64; ++k) r[k] = TR(S(0));

  for (int q0 = 0; q0 < nq; q0 += (B > 0 ? B : nq)) {
    TR rb[B > 0 ? 64 : 1];
    TR* acc = B > 0 ? rb : r;
    if (B > 0) {
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[k] = TR(S(0));
    }
    const int q1 = B > 0 && q0 + B < nq ? q0 + B : nq;
    for (int q = q0; q < q1; ++q) {
      S G[10][3];
      basis_gradients(tb, q, Jinv, G);
      T s[kSlots], f[kSlots];
      T0 s0[kSlots];
      point_state<Cell>(tb, q, u, G, s);
      point_state<Cell>(tb, q, u0, G, s0);
      point_flux(C, s, s0, old_terms(C, s0), vol, f);
      test_contract<Cell>(tb, q, G, tb.wq(q) * detJ, f, acc);
    }
    if (B > 0) {
#pragma unroll
      for (int k = 0; k < 64; ++k) r[k] += rb[k];
    }
  }
  cell_tail(C, Jinv, vol, u, r);
}
