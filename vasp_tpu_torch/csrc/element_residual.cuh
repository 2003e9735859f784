// K1/K2, the element residual + scatter, on one route to the quadrature
// tables: the kernel, its launch and the bodies of the C entry points,
// templated on the table reader (ConstTab or GlobalTab, element_forms.cuh).
// element_kernels.cu instantiates them on the constant bank and
// element_global.cu on tables in device memory, each source built by its
// own nvcc process, so the second route adds no build time. Design and
// costs: the head of element_kernels.cu.
#pragma once

#include <cstdint>

#include "element_forms.cuh"

namespace {

constexpr int kResidualThreads = 64;

// S = double: the float64 residual; S = float: every input rounded to
// float32 on its read, float32 element work, the float64 scatter.
template <class S, class Tb, class Cell>
__global__ void residual_kernel(const double* __restrict__ U,
                                const double* __restrict__ U0,
                                const int64_t* __restrict__ dofs,
                                const double* __restrict__ Jinv,
                                const double* __restrict__ detJ,
                                const double* __restrict__ vol,
                                const double* __restrict__ rowmask,
                                double* __restrict__ R, int K, int nq, Tb tb, Cell C) {
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
  cell_residual(C, tb, u, u0, J, S(detJ[k]), S(vol[k]), nq, r);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // the 0/1 row mask applied in S, exactly; only the sum is in double
    const S m = rowmask ? S(rowmask[(int64_t)k * 64 + i]) : S(1);
    atomicAdd(R + dk[i], double(r[i] * m));
  }
}

template <class S, template <class> class Tab, class Cell>
int launch_residual(const double* U, const double* U0, const int64_t* dofs,
                    const double* Jinv, const double* detJ, const double* vol,
                    const double* rowmask, double* R, const void* tables, int K, int nq,
                    Cell C, void* stream) {
  if (K > 0) {
    const int blocks = (K + kResidualThreads - 1) / kResidualThreads;
    residual_kernel<S, Tab<S>, Cell><<<blocks, kResidualThreads, 0, (cudaStream_t)stream>>>(
        U, U0, dofs, Jinv, detJ, vol, rowmask, R, K, nq, Tab<S>(tables, nq), C);
  }
  return (int)cudaGetLastError();
}

// the fluid's entry point on the table route Tab: f32 nonzero runs the
// float32 instance; lift_mode kLiftLaplace, kLiftElastic or kLiftNone, any
// other value refused
template <template <class> class Tab>
int fluid_residual_entry(const double* U, const double* U0, const int64_t* dofs,
                         const double* Jinv, const double* detJ, const double* vol,
                         const double* rowmask, const void* tables, double* R, int f32,
                         int K, int nq, double rho, double mu, double dt, double theta,
                         double lift_coeff, int lift_sub, int lift_mode, double p_stab,
                         void* stream) {
#define VT_FLUID(S, LIFT)                                                          \
  launch_residual<S, Tab>(U, U0, dofs, Jinv, detJ, vol, rowmask, R, tables, K, nq, \
                          fluid_cell<S, LIFT>(rho, mu, dt, theta, lift_coeff,     \
                                              lift_sub, p_stab),                  \
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

// the solid's: material 0 St.Venant-Kirchhoff, 1 Mooney-Rivlin (C01, C10,
// C11 read by it only), any other value refused; (gx, gy, gz) gravity
template <template <class> class Tab>
int solid_residual_entry(const double* U, const double* U0, const int64_t* dofs,
                         const double* Jinv, const double* detJ, const double* vol,
                         const double* rowmask, const void* tables, double* R, int f32,
                         int K, int nq, double rho, double mu, double lam, double dt,
                         double theta, int material, double C01, double C10, double C11,
                         double gx, double gy, double gz, void* stream) {
#define VT_SOLID(S, MAT)                                                           \
  launch_residual<S, Tab>(U, U0, dofs, Jinv, detJ, vol, rowmask, R, tables, K, nq, \
                          solid_cell<S, MAT>(rho, mu, lam, dt, theta, C01, C10,    \
                                             C11, gx, gy, gz),                     \
                          stream)
  if (material == kSVK) return f32 ? VT_SOLID(float, kSVK) : VT_SOLID(double, kSVK);
  if (material == kMooneyRivlin)
    return f32 ? VT_SOLID(float, kMooneyRivlin) : VT_SOLID(double, kMooneyRivlin);
#undef VT_SOLID
  return (int)cudaErrorInvalidValue;
}

}  // namespace
