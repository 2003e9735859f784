// K22 (element-block additive Schwarz) on Hopper: the build pass and the
// apply of NewtonSolver's Krylov-branch preconditioner.
//
// Replaces vasp_tpu/fem/solver.py NewtonSolver._build_schwarz (:153-175)
// and _precond (:177-184), and vasp_tpu/fem/preconditioner.py
// build_schwarz / apply_schwarz (:16-47). Plain torch twins:
// vasp_tpu_torch/kernels/schwarz.py build_plain, apply_plain.
//
// Build (vt_schwarz_build), one fused pass over a block's (K, N, N)
// float64 element Jacobians, N = 64 (cells) or 36 (Robin facets): the
// rows of constrained dofs become identity rows, the constrained columns
// of the other rows zero, and eps * max(|a_ii|, 1) is added to every
// diagonal entry (vasp_tpu's regularization of the zero pressure diagonal
// of the saddle blocks), written to a new (K, N, N) tensor; each
// element's dofs add 1.0 to their multiplicity with a float64 atomicAdd.
// The batched inverse stays torch.linalg.inv (cuSOLVER), as the RAS
// inverses (K18) and the LU do.
//   Bound: the read and the write of the blocks, 2 N^2 8 bytes an element
//   (0.98 GB at 14,880 fluid cells, ~0.29 ms at 3.35 TB/s). Design: one
//   block of 256 threads per element; the element's N mask bits are staged
//   in shared memory, then the threads stride over the N^2 entries in
//   row-major order, so that neighbouring threads read and write
//   neighbouring addresses.
//
// Apply (vt_schwarz_apply): y[dofs_e] += P_e r[dofs_e] over a block's
// elements in float64, then (vt_schwarz_divide) y /= multiplicity, once
// after every block has been summed: vasp_tpu's sum-then-divide.
//   Bound: the read of the inverses, N^2 8 bytes an element (0.49 GB at
//   14,880 fluid cells, ~0.15 ms). Design: K4's (csrc/matvec.cu) in float64
//   only: one block of 8 warps per element, the dofs and r_e staged in
//   shared memory, a warp per row taking 32-wide coalesced segments, a
//   shuffle reduction, one float64 atomicAdd per row. The atomics' order
//   varies from run to run, which moves y by rounding only.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;

template <int N>
__global__ void __launch_bounds__(kThreads)
schwarz_build_kernel(const double* __restrict__ A,
                     const int64_t* __restrict__ dofs,
                     const bool* __restrict__ mask, double eps,
                     double* __restrict__ out, double* __restrict__ mult) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ bool s_m[N];
  if (t < N) {
    const int64_t g = dofs[(int64_t)k * N + t];
    s_m[t] = mask[g];
    atomicAdd(mult + g, 1.0);
  }
  __syncthreads();
  const double* Ak = A + (int64_t)k * N * N;
  double* Ok = out + (int64_t)k * N * N;
  for (int e = t; e < N * N; e += kThreads) {
    const int i = e / N, j = e - i * N;
    double v = Ak[e];
    if (s_m[i]) {
      v = (i == j) ? 1.0 : 0.0;
    } else if (s_m[j]) {
      v = 0.0;
    }
    // rounded as vasp_tpu's separate product and sum (no FMA contraction)
    if (i == j) v = __dadd_rn(v, __dmul_rn(eps, fmax(fabs(v), 1.0)));
    Ok[e] = v;
  }
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
schwarz_apply_kernel(const double* __restrict__ P,
                     const int64_t* __restrict__ dofs,
                     const double* __restrict__ r, double* __restrict__ y) {
  static_assert(N > 32 && N <= 64, "a row is read as one or two 32-wide segments");
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ double s_r[N];
  __shared__ int64_t s_d[N];
  if (t < N) {
    const int64_t g = dofs[(int64_t)k * N + t];
    s_d[t] = g;
    s_r[t] = r[g];
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  const bool tail = lane + 32 < N;
  const double r0 = s_r[lane], r1 = tail ? s_r[lane + 32] : 0.0;
  const double* Pk = P + (int64_t)k * N * N;
  for (int i = warp; i < N; i += kWarps) {
    double s = Pk[i * N + lane] * r0;
    if (tail) s += Pk[i * N + lane + 32] * r1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) atomicAdd(y + s_d[i], s);
  }
}

__global__ void schwarz_divide_kernel(double* __restrict__ y,
                                      const double* __restrict__ mult,
                                      int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = y[i] / mult[i];
}

}  // namespace

extern "C" {

// A and out (K,nloc,nloc) float64, dofs (K,nloc) int64 with nloc 64 or 36,
// mask (ndof,) bool, mult (ndof,) float64 accumulated into.
int vt_schwarz_build(const double* A, const int64_t* dofs, const bool* mask,
                     double eps, double* out, double* mult, int K, int nloc,
                     void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (nloc == 64) {
    schwarz_build_kernel<64><<<K, kThreads, 0, s>>>(A, dofs, mask, eps, out, mult);
  } else if (nloc == 36) {
    schwarz_build_kernel<36><<<K, kThreads, 0, s>>>(A, dofs, mask, eps, out, mult);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// P (K,nloc,nloc) float64, dofs (K,nloc) int64, r and y (ndof,) float64; y
// is accumulated into, not overwritten.
int vt_schwarz_apply(const double* P, const int64_t* dofs, const double* r,
                     double* y, int K, int nloc, void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (nloc == 64) {
    schwarz_apply_kernel<64><<<K, kWarps * 32, 0, s>>>(P, dofs, r, y);
  } else if (nloc == 36) {
    schwarz_apply_kernel<36><<<K, kWarps * 32, 0, s>>>(P, dofs, r, y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y (n,) float64 divided in place by mult (n,) float64.
int vt_schwarz_divide(double* y, const double* mult, int64_t n, void* stream) {
  if (n > 0) {
    schwarz_divide_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                            (cudaStream_t)stream>>>(y, mult, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
