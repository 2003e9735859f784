// K1/K2 (element residual + scatter, float64 and float32 element work) and
// K3 (element Jacobians) on Hopper; the fluid with Laplace, elastic or no
// mesh lifting, the solid in St.Venant-Kirchhoff or Mooney-Rivlin, one
// kernel instance per lifting mode and per material; the fluid's pressure
// stabilization (p_stab) and the solid's gravity are parameters of those
// instances, their zero values the old path.
//
// Replaces vasp_tpu/fem/assembly.py: CellBlock.residual_local with
// Assembler.residual (vmapped make_fluid_kernel / make_solid_kernel, then
// a scatter-add into R; with dtype=float32 the element work in float32 on
// float32-rounded inputs, accumulated in float64), and
// CellBlock.jacobian_local (jax.jacfwd through chunked_vmap). Plain torch
// twin: vasp_tpu_torch/kernels/element.py residual_plain / jacobian_plain.
//
// What bounds them on an H100 and what the design does about it:
// - Residual: a few hundred KFLOP per cell against a 64-entry gather and
//   64 scattered f64 atomics. One thread per cell keeps the whole
//   quadrature loop in registers (spills to L1 accepted); the scatter is a
//   native f64 atomicAdd straight into R, so no (K,64) intermediate goes
//   through device memory. The atomics' order varies from run to run,
//   which moves R by rounding only. The float32 instance (S = float) runs
//   the same code at twice the f64 rate with half the registers per
//   value; it reads float32 copies of the tables and keeps the f64 scatter.
// - Jacobian: f64 FLOPs. One block per cell, one thread per column j:
//   the thread runs the residual on Dual numbers seeded with e_j and
//   writes column j of A_e, so a warp's stores to one row are coalesced.
//   The cell's local state is staged once in shared memory. The output
//   type is a template parameter: f64, or f32 for the iterative path's
//   preconditioner and Krylov matrices (jac_dtype="f32"). The f32 output
//   is computed in f64 and rounded once on the write, where vasp_tpu runs
//   jax.jacfwd in f32 arithmetic on f32 inputs.
#include <cstdint>

#include "element_forms.cuh"

namespace {

// a fluid cell with the mesh lifting LIFT (kLiftLaplace, kLiftElastic,
// kLiftNone)
template <class S, int LIFT>
struct FluidCell {
  FluidParams<S> p;
};

template <class T, int LIFT>
__device__ inline void eval_cell(const FluidCell<Real<T>, LIFT>& C, const T* u,
                                 const Real<T>* u0, const Real<T>* Jinv, Real<T> detJ,
                                 Real<T> vol, int nq, T* r) {
  fluid_residual<LIFT>(u, u0, Jinv, detJ, vol, C.p, nq, r);
}

template <class S, int LIFT>
inline FluidCell<S, LIFT> fluid_cell(double rho, double mu, double dt, double theta,
                                     double lift_coeff, int lift_sub, double p_stab) {
  return FluidCell<S, LIFT>{
      make_fluid_params<S>(rho, mu, dt, theta, lift_coeff, lift_sub, p_stab)};
}

// a solid cell of material MAT (kSVK or kMooneyRivlin)
template <class S, int MAT>
struct SolidCell {
  SolidParams<S> p;
};

template <class T, int MAT>
__device__ inline void eval_cell(const SolidCell<Real<T>, MAT>& C, const T* u,
                                 const Real<T>* u0, const Real<T>* Jinv, Real<T> detJ,
                                 Real<T> vol, int nq, T* r) {
  solid_residual<MAT>(u, u0, Jinv, detJ, vol, C.p, nq, r);
}

template <class S, int MAT>
inline SolidCell<S, MAT> solid_cell(double rho, double mu, double lam, double dt,
                                    double theta, double C01, double C10, double C11,
                                    double gx, double gy, double gz) {
  return SolidCell<S, MAT>{
      make_solid_params<S>(rho, mu, lam, dt, theta, C01, C10, C11, gx, gy, gz)};
}

constexpr int kResidualThreads = 64;

// S = double: the float64 residual; S = float: every input rounded to
// float32 on its read, float32 element work, the float64 scatter.
template <class S, class Params>
__global__ void residual_kernel(const double* __restrict__ U,
                                const double* __restrict__ U0,
                                const int64_t* __restrict__ dofs,
                                const double* __restrict__ Jinv,
                                const double* __restrict__ detJ,
                                const double* __restrict__ vol,
                                const double* __restrict__ rowmask,
                                double* __restrict__ R, int K, int nq, Params P) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int64_t* dk = dofs + (int64_t)k * 64;
  S u[64], u0[64], J[9], r[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int64_t g = dk[i];
    u[i] = S(U[g]);
    u0[i] = S(U0[g]);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = S(Jinv[(int64_t)k * 9 + i]);
  eval_cell(P, u, u0, J, S(detJ[k]), S(vol[k]), nq, r);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // the 0/1 row mask applied in S, exactly; only the sum is in double
    const S m = rowmask ? S(rowmask[(int64_t)k * 64 + i]) : S(1);
    atomicAdd(R + dk[i], double(r[i] * m));
  }
}

template <class Params, class TOut>
__global__ void __launch_bounds__(64)
jacobian_kernel(const double* __restrict__ U, const double* __restrict__ U0,
                const int64_t* __restrict__ dofs,
                const double* __restrict__ Jinv,
                const double* __restrict__ detJ,
                const double* __restrict__ vol,
                const double* __restrict__ rowmask,
                TOut* __restrict__ A, int K, int nq, Params P) {
  const int k = blockIdx.x;
  const int j = threadIdx.x;  // the column this thread differentiates by
  if (k >= K) return;
  __shared__ double s_u[64], s_u0[64], s_J[9];
  const int64_t g = dofs[(int64_t)k * 64 + j];
  s_u[j] = U[g];
  s_u0[j] = U0[g];
  if (j < 9) s_J[j] = Jinv[(int64_t)k * 9 + j];
  __syncthreads();

  Dual u[64], r[64];
  double u0[64], J[9];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    u[i] = Dual(s_u[i], i == j ? 1.0 : 0.0);
    u0[i] = s_u0[i];
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = s_J[i];
  eval_cell(P, u, u0, J, detJ[k], vol[k], nq, r);
  TOut* Ak = A + (int64_t)k * 64 * 64;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const double m = rowmask ? rowmask[(int64_t)k * 64 + i] : 1.0;
    Ak[i * 64 + j] = (TOut)(r[i].d * m);
  }
}

template <class S, class Params>
int launch_residual(const double* U, const double* U0, const int64_t* dofs,
                    const double* Jinv, const double* detJ, const double* vol,
                    const double* rowmask, double* R, int K, int nq, Params P,
                    void* stream) {
  if (K > 0) {
    const int blocks = (K + kResidualThreads - 1) / kResidualThreads;
    residual_kernel<S, Params><<<blocks, kResidualThreads, 0, (cudaStream_t)stream>>>(
        U, U0, dofs, Jinv, detJ, vol, rowmask, R, K, nq, P);
  }
  return (int)cudaGetLastError();
}

template <class Params>
int launch_jacobian(const double* U, const double* U0, const int64_t* dofs,
                    const double* Jinv, const double* detJ, const double* vol,
                    const double* rowmask, void* A, int out_f32, int K, int nq,
                    Params P, void* stream) {
  if (K > 0 && out_f32) {
    jacobian_kernel<Params, float><<<K, 64, 0, (cudaStream_t)stream>>>(
        U, U0, dofs, Jinv, detJ, vol, rowmask, (float*)A, K, nq, P);
  } else if (K > 0) {
    jacobian_kernel<Params, double><<<K, 64, 0, (cudaStream_t)stream>>>(
        U, U0, dofs, Jinv, detJ, vol, rowmask, (double*)A, K, nq, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vt_element_nq_max() { return VT_NQ_MAX; }

int vt_element_nq_max_f32() { return VT_NQ_MAX_F32; }

// Upload the quadrature tables (host pointers): wq (nq,), N1 (nq,4),
// N2 (nq,10), dN2 (nq,10,3), all float64 and C-contiguous; their float32
// roundings too where nq <= VT_NQ_MAX_F32.
int vt_set_element_tables(const double* wq, const double* N1, const double* N2,
                          const double* dN2, int nq) {
  if (nq < 1 || nq > VT_NQ_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaMemcpyToSymbol(c_wq, wq, sizeof(double) * nq)) != cudaSuccess) return (int)e;
  if ((e = cudaMemcpyToSymbol(c_N1, N1, sizeof(double) * nq * 4)) != cudaSuccess) return (int)e;
  if ((e = cudaMemcpyToSymbol(c_N2, N2, sizeof(double) * nq * 10)) != cudaSuccess) return (int)e;
  if ((e = cudaMemcpyToSymbol(c_dN2, dN2, sizeof(double) * nq * 30)) != cudaSuccess) return (int)e;
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

// f32 nonzero: the float32 instance (tables of at most VT_NQ_MAX_F32 points).
// lift_mode: kLiftLaplace, kLiftElastic or kLiftNone; any other value is
// refused.
int vt_fluid_residual(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, double* R, int f32, int K, int nq,
                      double rho, double mu, double dt, double theta,
                      double lift_coeff, int lift_sub, int lift_mode, double p_stab,
                      void* stream) {
#define VT_FLUID(S, LIFT)                                                      \
  launch_residual<S>(U, U0, dofs, Jinv, detJ, vol, rowmask, R, K, nq,          \
                     fluid_cell<S, LIFT>(rho, mu, dt, theta, lift_coeff,       \
                                         lift_sub, p_stab),                    \
                     stream)
  if (lift_mode == kLiftLaplace)
    return f32 ? VT_FLUID(float, kLiftLaplace) : VT_FLUID(double, kLiftLaplace);
  if (lift_mode == kLiftElastic)
    return f32 ? VT_FLUID(float, kLiftElastic) : VT_FLUID(double, kLiftElastic);
  if (lift_mode == kLiftNone)
    return f32 ? VT_FLUID(float, kLiftNone) : VT_FLUID(double, kLiftNone);
#undef VT_FLUID
  return (int)cudaErrorInvalidValue;
}

// material: 0 St.Venant-Kirchhoff, 1 Mooney-Rivlin (C01, C10, C11 read
// by it only); any other value is refused. (gx, gy, gz): gravity.
int vt_solid_residual(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, double* R, int f32, int K, int nq,
                      double rho, double mu, double lam, double dt, double theta,
                      int material, double C01, double C10, double C11, double gx,
                      double gy, double gz, void* stream) {
#define VT_SOLID(S, MAT)                                                      \
  launch_residual<S>(U, U0, dofs, Jinv, detJ, vol, rowmask, R, K, nq,         \
                     solid_cell<S, MAT>(rho, mu, lam, dt, theta, C01, C10, C11, \
                                        gx, gy, gz),                          \
                     stream)
  if (material == kSVK) return f32 ? VT_SOLID(float, kSVK) : VT_SOLID(double, kSVK);
  if (material == kMooneyRivlin)
    return f32 ? VT_SOLID(float, kMooneyRivlin) : VT_SOLID(double, kMooneyRivlin);
#undef VT_SOLID
  return (int)cudaErrorInvalidValue;
}

// A (K,64,64) is float32 when out_f32 is nonzero, else float64.
int vt_fluid_jacobian(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, void* A, int out_f32, int K, int nq,
                      double rho, double mu, double dt, double theta,
                      double lift_coeff, int lift_sub, int lift_mode, double p_stab,
                      void* stream) {
#define VT_FLUID(LIFT)                                                           \
  launch_jacobian(U, U0, dofs, Jinv, detJ, vol, rowmask, A, out_f32, K, nq,      \
                  fluid_cell<double, LIFT>(rho, mu, dt, theta, lift_coeff, lift_sub, \
                                           p_stab),                              \
                  stream)
  if (lift_mode == kLiftLaplace) return VT_FLUID(kLiftLaplace);
  if (lift_mode == kLiftElastic) return VT_FLUID(kLiftElastic);
  if (lift_mode == kLiftNone) return VT_FLUID(kLiftNone);
#undef VT_FLUID
  return (int)cudaErrorInvalidValue;
}

int vt_solid_jacobian(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, void* A, int out_f32, int K, int nq,
                      double rho, double mu, double lam, double dt, double theta,
                      int material, double C01, double C10, double C11, double gx,
                      double gy, double gz, void* stream) {
  if (material == kSVK)
    return launch_jacobian(U, U0, dofs, Jinv, detJ, vol, rowmask, A, out_f32, K, nq,
                           solid_cell<double, kSVK>(rho, mu, lam, dt, theta, C01,
                                                    C10, C11, gx, gy, gz),
                           stream);
  if (material == kMooneyRivlin)
    return launch_jacobian(U, U0, dofs, Jinv, detJ, vol, rowmask, A, out_f32, K, nq,
                           solid_cell<double, kMooneyRivlin>(rho, mu, lam, dt, theta,
                                                             C01, C10, C11, gx, gy, gz),
                           stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
