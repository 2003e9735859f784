// K4 (element matvec) on Hopper: y[dofs_e] += A_e x[dofs_e] for every cell
// or facet of a block.
//
// Replaces vasp_tpu/fem/assembly.py Assembler.matvec with _elem_gemv (the
// Krylov operator of the iterative Newton path, applied once per GMRES
// iteration and once per restart). Plain torch twin:
// vasp_tpu_torch/kernels/matvec.py elem_matvec_plain.
//
// Semantics kept from vasp_tpu: the gathered x_e is cast to A's dtype, the
// N-term row products are summed in A's dtype, and the sums are
// accumulated into y in y's dtype. Template instances: A f32 / y f64 (the
// default path: f32 Jacobians, f64 Krylov), A f32 / y f32
// (krylov_dtype="f32"), A f64 / y f64 (jac_dtype=None or the exact tier)
// and A f64 / y f32, each at the local size N of the cell blocks (64) and
// of the Robin facet blocks (36).
//
// What bounds it on an H100: the read of the element matrices, N*N*4
// bytes an element in f32 (341 MB at 20,832 cells, ~0.10 ms at 3.35 TB/s),
// against 2 FLOPs per entry. Design: one block of 8 warps per element; the
// element's N dof indices and x_e are staged once in shared memory; each
// warp takes every 8th row, its 32 lanes read the row's entries as
// coalesced 32-wide segments (two at N = 64; one and a 4-wide tail at
// N = 36), and a shuffle reduction leaves the row sum in lane 0, which
// issues one atomicAdd into y (native f64 atomics on Hopper). The atomics'
// order varies from run to run, which moves y by rounding only.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

template <int N, class TA, class TY>
__global__ void __launch_bounds__(kWarps * 32)
elem_matvec_kernel(const TA* __restrict__ A, const int64_t* __restrict__ dofs,
                   const TY* __restrict__ x, TY* __restrict__ y) {
  static_assert(N > 32 && N <= 64, "a row is read as one or two 32-wide segments");
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ TA s_x[N];
  __shared__ int64_t s_d[N];
  if (t < N) {
    const int64_t g = dofs[(int64_t)k * N + t];
    s_d[t] = g;
    s_x[t] = (TA)x[g];
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  const bool tail = lane + 32 < N;
  const TA x0 = s_x[lane], x1 = tail ? s_x[lane + 32] : TA(0);
  const TA* Ak = A + (int64_t)k * N * N;
  for (int i = warp; i < N; i += kWarps) {
    TA s = Ak[i * N + lane] * x0;
    if (tail) s += Ak[i * N + lane + 32] * x1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) atomicAdd(y + s_d[i], (TY)s);
  }
}

template <int N, class TA, class TY>
int launch(const void* A, const int64_t* dofs, const void* x, void* y, int K,
           void* stream) {
  if (K > 0) {
    elem_matvec_kernel<N, TA, TY><<<K, kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const TA*)A, dofs, (const TY*)x, (TY*)y);
  }
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const void* A, int a_f64, const int64_t* dofs, const void* x, void* y,
             int y_f64, int K, void* stream) {
  if (a_f64) {
    return y_f64 ? launch<N, double, double>(A, dofs, x, y, K, stream)
                 : launch<N, double, float>(A, dofs, x, y, K, stream);
  }
  return y_f64 ? launch<N, float, double>(A, dofs, x, y, K, stream)
               : launch<N, float, float>(A, dofs, x, y, K, stream);
}

}  // namespace

extern "C" {

// A (K,nloc,nloc) f32 or f64 (a_f64), dofs (K,nloc) int64 with nloc 64 or
// 36, x and y (ndof,) of one dtype (y_f64); y is accumulated into, not
// overwritten.
int vt_elem_matvec(const void* A, int a_f64, const int64_t* dofs,
                   const void* x, void* y, int y_f64, int K, int nloc,
                   void* stream) {
  if (nloc == 64) return launch_n<64>(A, a_f64, dofs, x, y, y_f64, K, stream);
  if (nloc == 36) return launch_n<36>(A, a_f64, dofs, x, y, y_f64, K, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
