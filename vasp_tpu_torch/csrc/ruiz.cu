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
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
ruiz_sweep_kernel(const float* __restrict__ A, const int64_t* __restrict__ dofs,
                  const float* __restrict__ dr, const float* __restrict__ dc,
                  const bool* __restrict__ mask, unsigned int* __restrict__ rmax,
                  unsigned int* __restrict__ cmax) {
  static_assert(N > 32 && N <= 64, "a row is read as one or two 32-wide segments");
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ int64_t s_d[N];
  __shared__ float s_dr[N], s_dc[N];
  __shared__ bool s_m[N];
  __shared__ unsigned int s_cm[kWarps][N];
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
  const float dc0 = s_dc[lane], dc1 = tail ? s_dc[lane + 32] : 0.0f;
  const bool m0 = s_m[lane], m1 = tail ? s_m[lane + 32] : true;
  const float* Ak = A + (int64_t)k * N * N;
  unsigned int cm0 = 0u, cm1 = 0u;
  for (int i = warp; i < N; i += kWarps) {
    const float dri = s_dr[i];
    const float v0 = fabsf(__fmul_rn(__fmul_rn(dri, Ak[i * N + lane]), dc0));
    const unsigned int u0 = (s_m[i] || m0) ? 0u : __float_as_uint(v0);
    unsigned int u1 = 0u;
    if (tail) {
      const float v1 = fabsf(__fmul_rn(__fmul_rn(dri, Ak[i * N + lane + 32]), dc1));
      u1 = (s_m[i] || m1) ? 0u : __float_as_uint(v1);
    }
    cm0 = max(cm0, u0);
    cm1 = max(cm1, u1);
    const unsigned int rm = __reduce_max_sync(0xffffffffu, max(u0, u1));
    if (lane == 0 && rm) atomicMax(rmax + s_d[i], rm);
  }
  s_cm[warp][lane] = cm0;
  if (tail) s_cm[warp][lane + 32] = cm1;
  __syncthreads();
  if (t < N) {
    unsigned int c = s_cm[0][t];
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

template <int N>
void sweep(const float* A, const int64_t* dofs, const float* dr, const float* dc,
           const bool* mask, float* rmax, float* cmax, int K, cudaStream_t s) {
  ruiz_sweep_kernel<N><<<K, kWarps * 32, 0, s>>>(
      A, dofs, dr, dc, mask, (unsigned int*)rmax, (unsigned int*)cmax);
}

template <int N>
void scale(const float* A, const int64_t* dofs, const float* dr, const float* dc,
           float* out, int K, cudaStream_t s) {
  ruiz_scale_kernel<N><<<K, 256, 0, s>>>(A, dofs, dr, dc, out);
}

}  // namespace

extern "C" {

// One sweep. A (K,nloc,nloc) f32 with nloc 64 or 36, dofs (K,nloc) int64,
// dr/dc (ndof,) f32, mask (ndof,) bool; rmax/cmax (ndof,) f32, zeroed by the
// caller, maxed into.
int vt_ruiz_sweep(const float* A, const int64_t* dofs, const float* dr,
                  const float* dc, const bool* mask, float* rmax, float* cmax,
                  int K, int nloc, void* stream) {
  if (nloc != 64 && nloc != 36) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nloc == 64) sweep<64>(A, dofs, dr, dc, mask, rmax, cmax, K, s);
    else sweep<36>(A, dofs, dr, dc, mask, rmax, cmax, K, s);
  }
  return (int)cudaGetLastError();
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
