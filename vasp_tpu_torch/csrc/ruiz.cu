// K7 (Ruiz equilibration from element matrices) on Hopper.
//
// Replaces vasp_tpu/fem/scaling.py ruiz_scales (one sweep: the row and
// column maxima of |dr_i A_ij dc_j| over every cell, bc rows and columns
// left out, scatter-maxed into (ndof,) vectors) and
// scale_element_jacobians (A_e <- dr[rows] A_e dc[cols]). Plain torch
// twins: vasp_tpu_torch/kernels/scaling.py ruiz_sweep_plain /
// ruiz_scale_plain. The dr/dc update between sweeps is elementwise on
// ndof and stays torch.
//
// What bounds them on an H100: the read of the f32 element matrices
// (341 MB at 20,832 cells) per sweep, plus their write for the scale:
// 4 sweeps + 1 scale ~ 2 GB, ~0.6 ms at 3.35 TB/s, against a few FLOPs an
// entry. Design: one block of 8 warps per element (cells, N = 64 local
// dofs, or Robin facets, N = 36), the element's dofs, scales and bc flags
// staged in shared memory; a warp reads a row as coalesced 32-wide
// segments (two at N = 64, one and a 4-wide tail at N = 36). The maxima
// are taken on the bit patterns of the non-negative floats (for them,
// unsigned order is float order), reduced in the warp (row) or across
// warps in shared memory (column), and merged into the global vectors with
// atomicMax. A NaN product has fabsf's clear sign bit, so its pattern
// orders above +inf and it propagates as XLA's max does. Max is exact and
// the products are the reference's two f32 multiplies in its order, so the
// result does not depend on the atomics' order.
//
// The sweep also has a float64 instance (64-bit patterns, atomicMax on
// unsigned long long, a shuffle reduction in the warp): the RAS
// preconditioner's rebuild equilibrates float64 element Jacobians, as
// vasp_tpu's _jac_and_ruiz does. It reads twice the bytes, ~0.2 ms a sweep
// at 20,832 cells.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

// The order-preserving bit pattern of a non-negative float or double, its
// product in the reference's rounding, and a warp's maximum of patterns.
__device__ __forceinline__ unsigned int bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned long long bits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float absv(float a) { return fabsf(a); }
__device__ __forceinline__ double absv(double a) { return ::fabs(a); }
__device__ __forceinline__ unsigned int warp_max(unsigned int u) {
  return __reduce_max_sync(0xffffffffu, u);
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long u) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) u = max(u, __shfl_xor_sync(0xffffffffu, u, off));
  return u;
}

template <int N, class T>
__global__ void __launch_bounds__(kWarps * 32)
ruiz_sweep_kernel(const T* __restrict__ A, const int64_t* __restrict__ dofs,
                  const T* __restrict__ dr, const T* __restrict__ dc,
                  const bool* __restrict__ mask, decltype(bits(T())) * __restrict__ rmax,
                  decltype(bits(T())) * __restrict__ cmax) {
  static_assert(N > 32 && N <= 64, "a row is read as one or two 32-wide segments");
  using U = decltype(bits(T()));
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ int64_t s_d[N];
  __shared__ T s_dr[N], s_dc[N];
  __shared__ bool s_m[N];
  __shared__ U s_cm[kWarps][N];
  if (t < N) {
    const int64_t g = dofs[(int64_t)k * N + t];
    s_d[t] = g;
    s_dr[t] = dr[g];
    s_dc[t] = dc[g];
    s_m[t] = mask[g];
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  const bool tail = lane + 32 < N;
  const T dc0 = s_dc[lane], dc1 = tail ? s_dc[lane + 32] : T(0);
  const bool m0 = s_m[lane], m1 = tail ? s_m[lane + 32] : true;
  const T* Ak = A + (int64_t)k * N * N;
  U cm0 = 0u, cm1 = 0u;
  for (int i = warp; i < N; i += kWarps) {
    const T dri = s_dr[i];
    const T v0 = absv(mul_rn(mul_rn(dri, Ak[i * N + lane]), dc0));
    const U u0 = (s_m[i] || m0) ? U(0) : bits(v0);
    U u1 = 0u;
    if (tail) {
      const T v1 = absv(mul_rn(mul_rn(dri, Ak[i * N + lane + 32]), dc1));
      u1 = (s_m[i] || m1) ? U(0) : bits(v1);
    }
    cm0 = max(cm0, u0);
    cm1 = max(cm1, u1);
    const U rm = warp_max(max(u0, u1));
    if (lane == 0 && rm) atomicMax(rmax + s_d[i], rm);
  }
  s_cm[warp][lane] = cm0;
  if (tail) s_cm[warp][lane + 32] = cm1;
  __syncthreads();
  if (t < N) {
    U c = s_cm[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) c = max(c, s_cm[w][t]);
    if (c) atomicMax(cmax + s_d[t], c);
  }
}

template <int N>
__global__ void __launch_bounds__(256)
ruiz_scale_kernel(const float* __restrict__ A, const int64_t* __restrict__ dofs,
                  const float* __restrict__ dr, const float* __restrict__ dc,
                  float* __restrict__ out) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ float s_dr[N], s_dc[N];
  if (t < N) {
    const int64_t g = dofs[(int64_t)k * N + t];
    s_dr[t] = dr[g];
    s_dc[t] = dc[g];
  }
  __syncthreads();
  const int64_t base = (int64_t)k * N * N;
#pragma unroll 4
  for (int e = t; e < N * N; e += 256) {
    out[base + e] = __fmul_rn(__fmul_rn(s_dr[e / N], A[base + e]), s_dc[e % N]);
  }
}

template <int N, class T>
void sweep(const T* A, const int64_t* dofs, const T* dr, const T* dc,
           const bool* mask, T* rmax, T* cmax, int K, cudaStream_t s) {
  using U = decltype(bits(T()));
  ruiz_sweep_kernel<N, T><<<K, kWarps * 32, 0, s>>>(
      A, dofs, dr, dc, mask, (U*)rmax, (U*)cmax);
}

template <class T>
int sweep_entry(const T* A, const int64_t* dofs, const T* dr, const T* dc,
                const bool* mask, T* rmax, T* cmax, int K, int nloc,
                void* stream) {
  if (nloc != 64 && nloc != 36) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nloc == 64) sweep<64>(A, dofs, dr, dc, mask, rmax, cmax, K, s);
    else sweep<36>(A, dofs, dr, dc, mask, rmax, cmax, K, s);
  }
  return (int)cudaGetLastError();
}

template <int N>
void scale(const float* A, const int64_t* dofs, const float* dr, const float* dc,
           float* out, int K, cudaStream_t s) {
  ruiz_scale_kernel<N><<<K, 256, 0, s>>>(A, dofs, dr, dc, out);
}

}  // namespace

extern "C" {

// One sweep. A (K,nloc,nloc) with nloc 64 or 36, dofs (K,nloc) int64,
// dr/dc (ndof,), mask (ndof,) bool; rmax/cmax (ndof,), zeroed by the
// caller, maxed into; all f64 (f64) or all f32.
int vt_ruiz_sweep(const void* A, const int64_t* dofs, const void* dr,
                  const void* dc, const bool* mask, void* rmax, void* cmax,
                  int K, int nloc, int f64, void* stream) {
  if (f64)
    return sweep_entry((const double*)A, dofs, (const double*)dr,
                       (const double*)dc, mask, (double*)rmax, (double*)cmax,
                       K, nloc, stream);
  return sweep_entry((const float*)A, dofs, (const float*)dr,
                     (const float*)dc, mask, (float*)rmax, (float*)cmax, K,
                     nloc, stream);
}

// out (K,nloc,nloc) f32 = dr[rows] A dc[cols].
int vt_ruiz_scale(const float* A, const int64_t* dofs, const float* dr,
                  const float* dc, float* out, int K, int nloc, void* stream) {
  if (nloc != 64 && nloc != 36) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nloc == 64) scale<64>(A, dofs, dr, dc, out, K, s);
    else scale<36>(A, dofs, dr, dc, out, K, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
