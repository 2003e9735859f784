// K8 (banded assembly) and K6 (banded apply) on Hopper.
//
// K8 replaces vasp_tpu/fem/banded.py assemble_banded_planned (scatter
// mode): the in-band entries of the Ruiz-scaled f32 element matrices are
// summed into the block-tridiagonal storage C/D/B (nb, c, c) by a host
// plan sorted by destination (build_banded_assembly_plan: src, udst,
// starts). Plain torch twin: vasp_tpu_torch/kernels/banded.py
// assemble_plain.
//   Bound: the write of C/D/B (3 nb c^2 f32: 10.15 GB at 20,832 cells,
//   done by the zero fill) plus ~1 GB of values and plan, ~3.3 ms at
//   3.35 TB/s. Design: a segmented sum with no atomics. One thread per
//   unique destination slot reads the slot, adds its run of values in plan
//   order and writes it back, so every slot sees the same sequence of f32
//   additions as vasp_tpu's sequential sorted scatter, on any device and in
//   every run.
//
// K6 replaces vasp_tpu/fem/banded.py make_banded_apply with bgemv: the
// block-Thomas solve with the stored factors (permute r into f32 blocks,
// t_k = Sinv_k r_k for all k, forward scan w_k = t_k - H_k w_{k-1},
// backward scan x_k = w_k - G_k x_{k+1}, unpermute). Plain torch twin:
// vasp_tpu_torch/kernels/banded.py solve_blocks_plain / apply_plain.
//   Bound: the read of Sinv, H and G (3 nb c^2 f32, 10.15 GB), ~3.0 ms.
//   Design (simple first): one GEMV kernel y = M v or y = a - M v on c x c
//   f32 blocks, v staged in shared memory (c floats), one warp per row
//   reading the row with coalesced 16-byte loads and a shuffle reduction.
//   The batched t = Sinv r is one launch over all nb blocks; each scan
//   step is one launch, issued in order from the host entry point
//   (2 nb - 1 launches in all), in place in one (nb, c) buffer. A
//   persistent single-launch scan is later work.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGemvWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kGemvWarps * kRowsPerWarp;

__global__ void banded_segsum_kernel(const float* __restrict__ v,
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ udst,
                                     const int32_t* __restrict__ starts,
                                     int nseg, int nsrc, float* __restrict__ buf) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= nseg) return;
  const int s1 = (u + 1 < nseg) ? starts[u + 1] : nsrc;
  float* slot = buf + (int64_t)udst[u];
  float acc = *slot;
  for (int s = starts[u]; s < s1; ++s) acc = __fadd_rn(acc, v[src[s]]);
  *slot = acc;
}

// y[b] = M[b] v[b] (a == nullptr) or a[b] - M[b] v[b]; M (batch, c, c),
// v/a/y (batch, c), c % 4 == 0. a and y may alias (in-place scan step).
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_kernel(const float* __restrict__ M, const float* __restrict__ v,
            const float* a, float* y, int c) {
  extern __shared__ float s_v[];
  const int64_t b = blockIdx.y;
  const float* vb = v + b * c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) s_v[j] = vb[j];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* s_v4 = reinterpret_cast<const float4*>(s_v);
  const int c4 = c >> 2;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + r;
    if (i >= c) break;
    const float4* row = reinterpret_cast<const float4*>(M + (b * c + i) * (int64_t)c);
    float s = 0.f;
    for (int j = lane; j < c4; j += 32) {
      const float4 m = row[j];
      const float4 x = s_v4[j];
      s += m.x * x.x + m.y * x.y + m.z * x.z + m.w * x.w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) y[b * c + i] = a ? a[b * c + i] - s : s;
  }
}

int gemv(const float* M, const float* v, const float* a, float* y, int batch,
         int c, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)c;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((c + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  gemv_kernel<<<grid, kGemvWarps * 32, smem, stream>>>(M, v, a, y, c);
  return (int)cudaGetLastError();
}

template <class T>
__global__ void permute_pad_kernel(const T* __restrict__ r,
                                   const int64_t* __restrict__ perm, int ndof,
                                   int npad, float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < npad) out[q] = q < ndof ? (float)r[perm[q]] : 0.f;
}

template <class T>
__global__ void unpermute_kernel(const float* __restrict__ x,
                                 const int64_t* __restrict__ perm, int ndof,
                                 T* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < ndof) out[perm[q]] = (T)x[q];
}

}  // namespace

extern "C" {

// One (block, target) part of the assembly: buf[udst[u]] += the values
// v[src[s]] of run u, s in [starts[u], starts[u+1]) (nsrc ends the last).
int vt_banded_segsum(const float* v, const int32_t* src, const int32_t* udst,
                     const int32_t* starts, int nseg, int nsrc, float* buf,
                     void* stream) {
  if (nseg > 0) {
    banded_segsum_kernel<<<(nseg + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        v, src, udst, starts, nseg, nsrc, buf);
  }
  return (int)cudaGetLastError();
}

// The two scans in place: x (nb, c) f32 holds r on entry and M r on exit;
// w (nb, c) is scratch.
int vt_banded_solve(const float* Sinv, const float* H, const float* G,
                    float* x, float* w, int nb, int c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t cc = (int64_t)c * c;
  int e = gemv(Sinv, x, nullptr, w, nb, c, s);  // t_k = Sinv_k r_k
  for (int k = 1; k < nb && !e; ++k)           // w_k = t_k - H_k w_{k-1}
    e = gemv(H + k * cc, w + (int64_t)(k - 1) * c, w + (int64_t)k * c,
             w + (int64_t)k * c, 1, c, s);
  for (int k = nb - 2; k >= 0 && !e; --k)      // x_k = w_k - G_k x_{k+1}
    e = gemv(G + k * cc, w + (int64_t)(k + 1) * c, w + (int64_t)k * c,
             w + (int64_t)k * c, 1, c, s);
  if (!e) e = (int)cudaMemcpyAsync(x, w, sizeof(float) * nb * (size_t)c,
                                   cudaMemcpyDeviceToDevice, s);
  return e;
}

// out (npad,) f32 = r[perm] padded with zeros; r f64 (r_f64) or f32.
int vt_banded_permute(const void* r, int r_f64, const int64_t* perm, int ndof,
                      int npad, float* out, void* stream) {
  const int blocks = (npad + 255) / 256;
  if (r_f64) {
    permute_pad_kernel<double><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const double*)r, perm, ndof, npad, out);
  } else {
    permute_pad_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)r, perm, ndof, npad, out);
  }
  return (int)cudaGetLastError();
}

// out[perm[q]] = x[q] for q < ndof, in out's dtype (out_f64).
int vt_banded_unpermute(const float* x, const int64_t* perm, int ndof,
                        void* out, int out_f64, void* stream) {
  const int blocks = (ndof + 255) / 256;
  if (out_f64) {
    unpermute_kernel<double><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        x, perm, ndof, (double*)out);
  } else {
    unpermute_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        x, perm, ndof, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
