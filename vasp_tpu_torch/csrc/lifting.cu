// K16 (biharmonic lifting correction) on Hopper:
//   out[d rows] = dmask * (beta L (wfree * minv * L d) - beta_gamma L d),
//   out[other rows] = 0,
// with L the P2 vector Laplacian of the fluid cells (per cell a 10x10
// stiffness Ke gathered and scattered through p2dofs), minv the lumped
// inverse mass, wfree the fluid-node mask of w and dmask the mask of the
// solid-owned d rows, in that order.
//
// Replaces vasp_tpu/fem/biharmonic.py _L_apply / correction_apply, the
// term the biharmonic lifting adds to every residual (on the float64 U)
// and to every Krylov matvec (on the Krylov vector: float32 under
// krylov_dtype="f32"). Plain torch twin: vasp_tpu_torch/kernels/lifting.py
// correction_plain. Two instances, T = double and T = float; the float one
// rounds Ke, minv, beta and beta_gamma to float on their read, as
// vasp_tpu's Ke.astype(dvec.dtype) does, and sums in float.
//
// What bounds it on an H100: bytes. Per call it reads Ke (K*100 doubles,
// 11.9 MB at the 14,880 fluid cells of the 20,832-cell tube), the cell
// node table and the d rows, and writes the output vector: ~15 MB, a few
// microseconds at 3.35 TB/s, against 1,200 FLOPs a cell. So the four
// steps below are bound by their launches. Design:
// - the scratch Ld is zeroed on the stream (cudaMemsetAsync);
// - launch 1, Ld = L d: one thread per (cell, local row a) gathers the
//   cell's 10 nodes x 3 components, takes row a of Ke and scatter-adds its
//   three sums into Ld with native atomics (f64 or f32);
// - launch 2 writes the whole output once: -beta_gamma dmask Ld on the d
//   rows, zero elsewhere;
// - launch 3, the second L: one thread per (cell, row a) forms
//   w = wfree ? Ld minv : 0 at gather time (no w vector goes through
//   memory), takes row a of Ke and adds beta dmask (Ke w) into the output.
// The atomics' order varies from run to run, which moves the result by
// rounding only.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// y[3 n_a + i] += sum_b Ke[k, a, b] x[3 n_b + i] for one (cell, row) pair;
// LOAD(n, i) reads component i of node n of x
template <class T, class Load>
__device__ inline void ke_row(const double* __restrict__ Ke, const int* __restrict__ nodes,
                              int64_t k, int a, Load load, T y[3]) {
  const double* row = Ke + (k * 10 + a) * 10;
  y[0] = y[1] = y[2] = T(0);
#pragma unroll
  for (int b = 0; b < 10; ++b) {
    const int n = nodes[b];
    const T kab = T(row[b]);
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] += kab * load(n, i);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
lift_first_kernel(const T* __restrict__ U, const double* __restrict__ Ke,
                  const int* __restrict__ p2dofs, T* __restrict__ Ld, int K) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)K * 10) return;
  const int64_t k = t / 10;
  const int a = (int)(t % 10);
  const int* nodes = p2dofs + k * 10;
  T y[3];
  ke_row<T>(Ke, nodes, k, a, [&](int n, int i) { return U[3 * (int64_t)n + i]; }, y);
  const int64_t r = 3 * (int64_t)nodes[a];
#pragma unroll
  for (int i = 0; i < 3; ++i) atomicAdd(Ld + r + i, y[i]);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
lift_init_kernel(const T* __restrict__ Ld, const double* __restrict__ dmask, T beta_gamma,
                 T* __restrict__ out, int64_t n_d, int64_t ndof) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ndof) return;
  out[j] = j < n_d ? -(beta_gamma * Ld[j]) * T(dmask[j / 3]) : T(0);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
lift_second_kernel(const T* __restrict__ Ld, const double* __restrict__ Ke,
                   const int* __restrict__ p2dofs, const double* __restrict__ minv,
                   const bool* __restrict__ wfree, const double* __restrict__ dmask,
                   T beta, T* __restrict__ out, int K) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)K * 10) return;
  const int64_t k = t / 10;
  const int a = (int)(t % 10);
  const int* nodes = p2dofs + k * 10;
  const int64_t r = 3 * (int64_t)nodes[a];
  const T m = T(dmask[nodes[a]]);
  if (m == T(0)) return;  // a solid-owned d row: no lifting
  T y[3];
  ke_row<T>(Ke, nodes, k, a,
            [&](int n, int i) {
              return wfree[n] ? Ld[3 * (int64_t)n + i] * T(minv[n]) : T(0);
            },
            y);
#pragma unroll
  for (int i = 0; i < 3; ++i) atomicAdd(out + r + i, beta * y[i] * m);
}

template <class T>
int launch(const T* U, const double* Ke, const int* p2dofs, const double* minv,
           const bool* wfree, const double* dmask, double beta, double beta_gamma, T* Ld,
           T* out, int K, int n_p2, int64_t ndof, cudaStream_t stream) {
  const int64_t n_d = 3 * (int64_t)n_p2;
  cudaError_t e = cudaMemsetAsync(Ld, 0, sizeof(T) * n_d, stream);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)K * 10;
  const int row_blocks = (int)((rows + kThreads - 1) / kThreads);
  const int out_blocks = (int)((ndof + kThreads - 1) / kThreads);
  if (K > 0)
    lift_first_kernel<T><<<row_blocks, kThreads, 0, stream>>>(U, Ke, p2dofs, Ld, K);
  if (ndof > 0)
    lift_init_kernel<T><<<out_blocks, kThreads, 0, stream>>>(Ld, dmask, T(beta_gamma), out,
                                                             n_d, ndof);
  if (K > 0)
    lift_second_kernel<T><<<row_blocks, kThreads, 0, stream>>>(Ld, Ke, p2dofs, minv, wfree,
                                                              dmask, T(beta), out, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// U and out (ndof,) and the scratch Ld (3 n_p2,) are float32 when f32 is
// nonzero, else float64; Ke (K,10,10), minv and dmask (n_p2,) float64,
// p2dofs (K,10) int32, wfree (n_p2,) bool; ndof >= 3 n_p2.
int vt_lift_correction(const void* U, const double* Ke, const int* p2dofs,
                       const double* minv, const bool* wfree, const double* dmask,
                       double beta, double beta_gamma, void* Ld, void* out, int f32,
                       int K, int n_p2, int64_t ndof, void* stream) {
  if (ndof < 3 * (int64_t)n_p2) return (int)cudaErrorInvalidValue;
  if (f32)
    return launch<float>((const float*)U, Ke, p2dofs, minv, wfree, dmask, beta, beta_gamma,
                         (float*)Ld, (float*)out, K, n_p2, ndof, (cudaStream_t)stream);
  return launch<double>((const double*)U, Ke, p2dofs, minv, wfree, dmask, beta, beta_gamma,
                        (double*)Ld, (double*)out, K, n_p2, ndof, (cudaStream_t)stream);
}

}  // extern "C"
