// K18 (the restricted additive Schwarz apply) on Hopper.
//
// Replaces vasp_tpu/fem/ras.py make_apply: gather r at each subdomain's
// dofs (idx, padded with the dof ndof that reads 0), cast to the stored
// inverses' type, the batched dense products pinv_s r_s, and the
// restricted scatter that keeps each real dof's row from the one
// subdomain that owns it. Plain torch twin:
// vasp_tpu_torch/kernels/ras.py apply_plain.
//   Bound: the read of the owned rows of pinv, ndof m entries of 4 or 8 B
// (m <= 2048 local dofs: ~1.5 GB in f32 at 184,845 dofs, ~0.45 ms), against
// 2 flops an entry. Design: a block per (subdomain, 64 rows); the block
// gathers r[idx[s]] in pinv's type into shared memory (m entries: 8 KB in
// f32, 16 KB in f64 at m = 2048), each of its 8 warps takes a row, reads it
// with coalesced loads (rows are contiguous), sums in pinv's type with a
// shuffle reduction and stores the result in r's type. Rows a subdomain
// does not own are skipped. Each real dof has exactly one owner (checked
// when the pattern is built), so the stores need no atomics and no zero
// fill, the result does not depend on launch order, and the pad slot is
// never written.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 64;  // rows of one subdomain per block

template <class TP, class TR>
__global__ void __launch_bounds__(kWarps * 32)
ras_apply_kernel(const TP* __restrict__ pinv, const int64_t* __restrict__ idx,
                 const bool* __restrict__ own, const TR* __restrict__ r,
                 TR* __restrict__ y, int m, int64_t ndof) {
  extern __shared__ unsigned char smem[];
  TP* s_r = reinterpret_cast<TP*>(smem);
  const int64_t s = blockIdx.x;
  const int64_t* ids = idx + s * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int64_t g = ids[j];
    s_r[j] = g < ndof ? static_cast<TP>(r[g]) : TP(0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i1 = min(m, (int)(blockIdx.y + 1) * kRows);
  for (int i = blockIdx.y * kRows + warp; i < i1; i += kWarps) {
    if (!own[s * m + i]) continue;
    const TP* row = pinv + (s * m + i) * (int64_t)m;
    TP acc = 0;
    for (int j = lane; j < m; j += 32) acc += row[j] * s_r[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) y[ids[i]] = static_cast<TR>(acc);
  }
}

template <class TP, class TR>
int launch(const TP* pinv, const int64_t* idx, const bool* own, const TR* r,
           TR* y, int S, int m, int64_t ndof, cudaStream_t stream) {
  const size_t smem = sizeof(TP) * (size_t)m;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ras_apply_kernel<TP, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(S, (m + kRows - 1) / kRows);
  ras_apply_kernel<TP, TR><<<grid, kWarps * 32, smem, stream>>>(
      pinv, idx, own, r, y, m, ndof);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (ndof,) = the restricted RAS apply of r (ndof,): pinv (S, m, m) f64
// (p_f64) or f32, idx (S, m) int64 padded with ndof, own (S, m) bool; r and
// y f64 (r_f64) or f32. Rows no subdomain owns are not written.
int vt_ras_apply(const void* pinv, const int64_t* idx, const bool* own,
                 const void* r, void* y, int S, int m, int64_t ndof,
                 int p_f64, int r_f64, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0 || m == 0) return 0;
  if (p_f64 && r_f64)
    return launch((const double*)pinv, idx, own, (const double*)r, (double*)y,
                  S, m, ndof, st);
  if (p_f64)
    return launch((const double*)pinv, idx, own, (const float*)r, (float*)y,
                  S, m, ndof, st);
  if (r_f64)
    return launch((const float*)pinv, idx, own, (const double*)r, (double*)y,
                  S, m, ndof, st);
  return launch((const float*)pinv, idx, own, (const float*)r, (float*)y, S,
                m, ndof, st);
}

}  // extern "C"
