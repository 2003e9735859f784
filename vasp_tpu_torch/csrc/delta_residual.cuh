// K13, the order-3 Taylor delta of the element residual, on one route to
// the quadrature tables: the kernel, its launch and the bodies of the C
// entry points, templated on the table reader (ConstTab or GlobalTab,
// element_forms.cuh). delta_kernels.cu instantiates them on the constant
// bank and delta_global.cu on tables in device memory, each source built
// by its own nvcc process. Design and costs: the head of delta_kernels.cu.
#pragma once

#include <cstdint>
#include <type_traits>

#include "element_forms.cuh"

namespace {

constexpr int kDeltaThreads = 64;

// DELTA2 false: u0 = U0 rounded to float32 (vasp_tpu's residual_delta);
// true: u0 = the series of U0 along U0new - U0 (residual_delta2, U0 being
// its U0old).
template <class Tb, class Cell, bool DELTA2>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const double* __restrict__ U, const double* __restrict__ A,
             const double* __restrict__ U0, const double* __restrict__ U0new,
             const int64_t* __restrict__ dofs, const double* __restrict__ Jinv,
             const double* __restrict__ detJ, const double* __restrict__ vol,
             const double* __restrict__ rowmask, double* __restrict__ R, int K, int nq,
             Tb tb, Cell C) {
  using T0 = typename std::conditional<DELTA2, Jet3, float>::type;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int64_t* dk = dofs + (int64_t)k * 64;
  Jet3 u[64];
  T0 u0[64];
  DeltaSum r[64];
  float J[9];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int64_t g = dk[i];
    const double a = A[g];
    // du = U - A in float64, then rounded, as vasp_tpu's (U - A).astype
    u[i] = Jet3(float(a), float(U[g] - a), 0.f, 0.f);
    if constexpr (DELTA2) {
      const double o = U0[g];
      u0[i] = Jet3(float(o), float(U0new[g] - o), 0.f, 0.f);
    } else {
      u0[i] = float(U0[g]);
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = float(Jinv[(int64_t)k * 9 + i]);
  cell_residual(C, tb, u, u0, J, float(detJ[k]), float(vol[k]), nq, r);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // the 0/1 row mask applied in float, exactly; only the sum is in double
    const float m = rowmask ? float(rowmask[(int64_t)k * 64 + i]) : 1.f;
    atomicAdd(R + dk[i], double(r[i].s * m));
  }
}

template <template <class> class Tab, class Cell>
int launch_delta(const double* U, const double* A, const double* U0, const double* U0new,
                 const int64_t* dofs, const double* Jinv, const double* detJ,
                 const double* vol, const double* rowmask, const void* tables, double* R,
                 int delta2, int K, int nq, Cell C, void* stream) {
  if (K > 0) {
    const int blocks = (K + kDeltaThreads - 1) / kDeltaThreads;
    const Tab<float> tb(tables, nq);
    if (delta2)
      delta_kernel<Tab<float>, Cell, true><<<blocks, kDeltaThreads, 0, (cudaStream_t)stream>>>(
          U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, R, K, nq, tb, C);
    else
      delta_kernel<Tab<float>, Cell, false><<<blocks, kDeltaThreads, 0, (cudaStream_t)stream>>>(
          U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, R, K, nq, tb, C);
  }
  return (int)cudaGetLastError();
}

// the fluid's entry point on the table route Tab (float32 tables):
// lift_mode kLiftLaplace, kLiftElastic or kLiftNone, any other value
// refused
template <template <class> class Tab>
int fluid_delta_entry(const double* U, const double* A, const double* U0, const double* U0new,
                      const int64_t* dofs, const double* Jinv, const double* detJ,
                      const double* vol, const double* rowmask, const void* tables,
                      double* R, int delta2, int K, int nq, double rho, double mu, double dt,
                      double theta, double lift_coeff, int lift_sub, int lift_mode,
                      double p_stab, void* stream) {
#define VT_FLUID(LIFT)                                                                  \
  launch_delta<Tab>(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, tables, R, delta2, \
                    K, nq,                                                              \
                    fluid_cell<float, LIFT>(rho, mu, dt, theta, lift_coeff, lift_sub,   \
                                            p_stab),                                    \
                    stream)
  if (lift_mode == kLiftLaplace) return VT_FLUID(kLiftLaplace);
  if (lift_mode == kLiftElastic) return VT_FLUID(kLiftElastic);
  if (lift_mode == kLiftNone) return VT_FLUID(kLiftNone);
#undef VT_FLUID
  return (int)cudaErrorInvalidValue;
}

// the solid's: material 0 St.Venant-Kirchhoff, 1 Mooney-Rivlin (C01, C10,
// C11 read by it only), any other value refused; (gx, gy, gz) gravity
template <template <class> class Tab>
int solid_delta_entry(const double* U, const double* A, const double* U0, const double* U0new,
                      const int64_t* dofs, const double* Jinv, const double* detJ,
                      const double* vol, const double* rowmask, const void* tables,
                      double* R, int delta2, int K, int nq, double rho, double mu,
                      double lam, double dt, double theta, int material, double C01,
                      double C10, double C11, double gx, double gy, double gz,
                      void* stream) {
#define VT_SOLID(MAT)                                                                   \
  launch_delta<Tab>(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, tables, R, delta2, \
                    K, nq,                                                              \
                    solid_cell<float, MAT>(rho, mu, lam, dt, theta, C01, C10, C11, gx,  \
                                           gy, gz),                                     \
                    stream)
  if (material == kSVK) return VT_SOLID(kSVK);
  if (material == kMooneyRivlin) return VT_SOLID(kMooneyRivlin);
#undef VT_SOLID
  return (int)cudaErrorInvalidValue;
}

}  // namespace
