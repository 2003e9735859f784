// K8 (banded assembly), K6 (banded apply), K12 (folded apply), K21a
// (one rank's stage of the sharded applies) and K21f-a (the SPIKE
// refinement's block-tridiagonal residual) on Hopper.
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
//   Bound: the read of Sinv, H and G, 12 B per block slot in f32
//   (10.15 GB at 20,832 cells, ~3.0 ms), 8 B in the hybrid layout (f32
//   Sinv, bf16 H/G; ~2.0 ms), 6 B with all three in bf16 (~1.5 ms).
//   Design (simple first): one GEMV kernel y = M v or y = a - M v on c x c
//   blocks, templated on M's storage (float, or __nv_bfloat16 widened to
//   float exactly; the vector and the sums are float32, as vasp_tpu's
//   bgemv promotes bf16 * f32), v staged in shared memory (c floats), one
//   warp per row reading the row with coalesced 16-byte loads (4 floats or
//   8 bf16; c is a multiple of 8) and a shuffle reduction. In the f32
//   instance each lane chains a chunk's products by FMA and adds the chunk
//   to its running sum; the hybrid and bf16 instances sum in
//   compensated float32 as K12 does (below): with plain sums the hybrid
//   ended farther from the float64 scans than twice the plain version's
//   distance on the small tube of tests/test_torch_kernels_cuda.py. Sinv
//   and H/G each pick their storage. The batched t = Sinv r is one launch
//   over all nb blocks; each scan step is one launch, issued in order from
//   the host entry point (2 nb - 1 launches in all), in place in one
//   (nb, c) buffer. A persistent single-launch scan is later work.
//
// K12 replaces vasp_tpu/fem/banded.py make_banded_apply_lowmem: the same
// solve with H = Sinv C and G = Sinv B folded in, from Sinv (bf16 or f32)
// and the bf16 C/B of the low-memory layouts: w_k = Sinv_k (r_k - C_k
// w_{k-1}), x_k = w_k - Sinv_k (B_k x_{k+1}). Plain torch twin:
// solve_blocks_lowmem_plain / apply_lowmem_plain.
//   Bound: each input read once, 6 B per slot with bf16 Sinv (~1.5 ms at
//   20,832 cells) and 8 B with f32 Sinv (~2.0 ms); the scans below read
//   Sinv twice (8 and 12 B). Design: two GEMVs of the same template per
//   scan step (u = r_k - C_k w_{k-1}, then w_k = Sinv_k u; u = B_k
//   x_{k+1}, then x_k = w_k - Sinv_k u), 4 nb - 3 launches, u a c-vector
//   of scratch. Its sums are compensated (Dot2: each product split by an
//   FMA, each addition by TwoSum, about 10 float32 operations per entry,
//   under the memory bound): over twice K6's GEMVs a solve, plain float32
//   sums ended 2.4x as far from the float64 scans as the plain version on
//   the small tube of tests/test_torch_kernels_cuda.py (an H100), while
//   these are as accurate as sums in twice float32's precision. A fused
//   or persistent step is later work.
//
// K21a replaces one rank's part of the sharded applies of
// vasp_tpu/parallel/banded_shard.py: make_sharded_chain_apply (:676, the
// default) and make_sharded_banded_apply (:846, algo="thomas"). A rank
// holds nb_loc blocks of the factors, whose first H_0 couples to rank
// p - 1 and whose last G_{nb_loc-1} couples to rank p + 1, so each scan
// starts from an incoming carry instead of K6's k = 1 and nb - 2: one
// stage per call, t = Sinv r (batched), the forward scan w_0 = t_0 - H_0
// w_in, w_k = t_k - H_k w_{k-1}, or the backward scan x_{m-1} = w_{m-1} -
// G_{m-1} x_in, x_k = w_k - G_k x_{k+1} (a null carry is zero: the first
// block is copied). The chain's carry update w_last + Tf carry (Tf the
// float32 product of the -H_k) is one GEMV-with-add. Plain torch twins:
// carry_stage_plain, carry_update_plain, solve_blocks_carry_plain.
//   Bound: the bytes of the rank's factors read over 3.35 TB/s: Sinv + 2H
//   + 2G for an interior rank's chain apply (its zero-carry forward and
//   backward scans run again with the true carries), Sinv + H + G for an
//   end rank's (one scan each way) and for the Thomas apply; at c = 4,488
//   and 21 float32 blocks a rank (20,832 cells on two ranks) 3 x 21 c x c
//   blocks, 1.52 ms (5 x 21, 2.53 ms, an interior rank's, from three
//   ranks on). Design: K6's gemv_kernel and its
//   instances (plain float32 sums with float32 factors, compensated sums
//   where H/G are bf16), one launch per scan step issued from the host
//   entry point; the carry update is gemv_kernel with a + M v.
//
// K21f-a replaces the refinement residual of vasp_tpu/parallel/
// banded_shard.py make_sharded_spike_apply (:775-777, the SPIKE apply's
// iterative refinement): over a rank's m blocks, y_k = r_k - (D_k x_k +
// C_k x_{k-1} + B_k x_{k+1}), x_{-1} and x_m the neighbours' boundary rows
// (null: zero, the end ranks). C/D/B float32 (m, c, c), x, r, y float32.
// Plain torch twin: vasp_tpu_torch/kernels/banded.py tri_residual_plain
// (kb.bgemv three times).
//   Bound: the read of C, D and B (3 m c^2 f32: 5.08 GB at c = 4,488 and
//   21 blocks a rank, 1.52 ms at 3.35 TB/s). Design: K6's GEMV layout (a
//   warp per row, coalesced 16-byte loads, the vectors staged in shared
//   memory, here x_{k-1}, x_k and x_{k+1}), but every product is formed
//   exactly in double (two floats' product has 48 significant bits) and
//   each row's three products and r_k are summed in double and rounded
//   once: y is a small difference of large terms, where float32 sums lose
//   the 2x rule K6 and K12 are held to. A warp's rows share each
//   x chunk's conversion to double.
#include <cstdint>

#include <cuda_bf16.h>
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

// Entry q of a 16-byte chunk of M widened to float exactly: 4 floats, or 8
// bf16 (a bf16 is the high half of its float, as __bfloat162float gives
// it).
__device__ __forceinline__ float entry(const float*, const uint4& m, int q) {
  return __uint_as_float(q == 0 ? m.x : q == 1 ? m.y : q == 2 ? m.z : m.w);
}

__device__ __forceinline__ float entry(const __nv_bfloat16*, const uint4& m,
                                       int q) {
  const unsigned int u = (q >> 1) == 0 ? m.x : (q >> 1) == 1 ? m.y
                         : (q >> 1) == 2 ? m.z : m.w;
  return __uint_as_float((q & 1) ? (u & 0xffff0000u) : (u << 16));
}

// A float32 running sum with its compensation: Ogita, Rump and Oishi's
// Dot2, every product split exactly by an FMA and every addition by
// TwoSum, so the sum is as accurate as one in twice float32's precision.
// The _rn intrinsics keep the compiler from contracting the error-free
// transforms into FMAs.
struct Comp {
  float s, c;
};

__device__ __forceinline__ void two_sum(Comp& a, float p, float e) {
  const float t = __fadd_rn(a.s, p);
  const float z = __fsub_rn(t, a.s);
  const float err = __fadd_rn(__fsub_rn(a.s, __fsub_rn(t, z)), __fsub_rn(p, z));
  a.c = __fadd_rn(a.c, __fadd_rn(err, e));
  a.s = t;
}

__device__ __forceinline__ void add_product(Comp& a, float m, float x) {
  const float p = __fmul_rn(m, x);
  two_sum(a, p, __fmaf_rn(m, x, -p));
}

__device__ __forceinline__ void add_product(float& a, float m, float x) {
  a = __fmaf_rn(m, x, a);
}

__device__ __forceinline__ float shfl_down(float v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}

__device__ __forceinline__ void warp_sum(float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += shfl_down(s, off);
}

__device__ __forceinline__ void warp_sum(Comp& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float c = shfl_down(a.c, off);
    two_sum(a, shfl_down(a.s, off), c);
  }
}

// a - s (a == nullptr: s) rounded to float.
__device__ __forceinline__ float finish(const float* a, float s) {
  return a ? *a - s : s;
}

__device__ __forceinline__ float finish(const float* a, Comp s) {
  if (!a) return __fadd_rn(s.s, s.c);
  Comp d{*a, 0.f};
  two_sum(d, -s.s, 0.f);
  return __fadd_rn(d.s, __fsub_rn(d.c, s.c));
}

// y[b] = M[b] v[b] (a == nullptr), a[b] - M[b] v[b], or a[b] + M[b] v[b]
// (kAdd, plain float sums only); M (batch, c, c) of TM, v/a/y (batch, c)
// float, c a multiple of 16 / sizeof(TM). a and y may alias (in-place scan
// step). Acc is the lane's float32 sum: a plain float (each 16-byte
// chunk's products chained by FMA, then added) or a compensated Comp.
template <class TM, class Acc, bool kAdd = false>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_kernel(const TM* __restrict__ M, const float* __restrict__ v,
            const float* a, float* y, int c) {
  extern __shared__ float4 s_v4[];
  constexpr int kPer = 16 / sizeof(TM);  // entries per 16-byte load
  const int64_t b = blockIdx.y;
  const float* vb = v + b * c;
  float* s_v = reinterpret_cast<float*>(s_v4);
  for (int j = threadIdx.x; j < c; j += blockDim.x) s_v[j] = vb[j];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cv = c / kPer;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + r;
    if (i >= c) break;
    const uint4* row = reinterpret_cast<const uint4*>(M + (b * c + i) * (int64_t)c);
    Acc s{};
    for (int j = lane; j < cv; j += 32) {
      const uint4 m = row[j];
      float x[kPer];
#pragma unroll
      for (int h = 0; h < kPer / 4; ++h) {
        const float4 f = s_v4[j * (kPer / 4) + h];
        x[4 * h] = f.x, x[4 * h + 1] = f.y, x[4 * h + 2] = f.z, x[4 * h + 3] = f.w;
      }
      if constexpr (sizeof(Acc) == sizeof(float)) {
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < kPer; ++q) add_product(t, entry(M, m, q), x[q]);
        s += t;
      } else {
#pragma unroll
        for (int q = 0; q < kPer; ++q) add_product(s, entry(M, m, q), x[q]);
      }
    }
    warp_sum(s);
    if (lane == 0) {
      if constexpr (kAdd) {
        static_assert(sizeof(Acc) == sizeof(float), "a + M v sums plainly");
        y[b * c + i] = a[b * c + i] + s;
      } else {
        y[b * c + i] = finish(a ? a + b * c + i : nullptr, s);
      }
    }
  }
}

template <class Acc, bool kAdd = false, class TM>
int gemv(const TM* M, const float* v, const float* a, float* y, int batch,
         int c, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)c;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<TM, Acc, kAdd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((c + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  gemv_kernel<TM, Acc, kAdd>
      <<<grid, kGemvWarps * 32, smem, stream>>>(M, v, a, y, c);
  return (int)cudaGetLastError();
}

// The two scans of K6 in place: x (nb, c) holds r on entry and M r on
// exit; w (nb, c) is scratch; Acc the GEMVs' sums.
template <class Acc, class TS, class THG>
int solve(const TS* Sinv, const THG* H, const THG* G, float* x, float* w,
          int nb, int c, cudaStream_t s) {
  const int64_t cc = (int64_t)c * c;
  int e = gemv<Acc>(Sinv, x, nullptr, w, nb, c, s);  // t_k = Sinv_k r_k
  for (int k = 1; k < nb && !e; ++k)  // w_k = t_k - H_k w_{k-1}
    e = gemv<Acc>(H + k * cc, w + (int64_t)(k - 1) * c, w + (int64_t)k * c,
                  w + (int64_t)k * c, 1, c, s);
  for (int k = nb - 2; k >= 0 && !e; --k)  // x_k = w_k - G_k x_{k+1}
    e = gemv<Acc>(G + k * cc, w + (int64_t)(k + 1) * c, w + (int64_t)k * c,
                  w + (int64_t)k * c, 1, c, s);
  if (!e) e = (int)cudaMemcpyAsync(x, w, sizeof(float) * nb * (size_t)c,
                                   cudaMemcpyDeviceToDevice, s);
  return e;
}

// The folded scans of K12 in place: x (nb, c) holds r on entry and M r on
// exit; w (nb, c) and u (c) are scratch.
template <class TS, class TCB>
int solve_lowmem(const TS* Sinv, const TCB* C, const TCB* B, float* x,
                 float* w, float* u, int nb, int c, cudaStream_t s) {
  const int64_t cc = (int64_t)c * c;
  int e = gemv<Comp>(Sinv, x, nullptr, w, 1, c, s);  // w_0 = Sinv_0 r_0
  for (int k = 1; k < nb && !e; ++k) {
    // u = r_k - C_k w_{k-1}, then w_k = Sinv_k u
    e = gemv<Comp>(C + k * cc, w + (int64_t)(k - 1) * c, x + (int64_t)k * c,
                   u, 1, c, s);
    if (!e)
      e = gemv<Comp>(Sinv + k * cc, u, nullptr, w + (int64_t)k * c, 1, c, s);
  }
  for (int k = nb - 2; k >= 0 && !e; --k) {
    // u = B_k x_{k+1}, then x_k = w_k - Sinv_k u (x_k overwrites w_k)
    e = gemv<Comp>(B + k * cc, w + (int64_t)(k + 1) * c, nullptr, u, 1, c, s);
    if (!e)
      e = gemv<Comp>(Sinv + k * cc, u, w + (int64_t)k * c,
                     w + (int64_t)k * c, 1, c, s);
  }
  if (!e) e = (int)cudaMemcpyAsync(x, w, sizeof(float) * nb * (size_t)c,
                                   cudaMemcpyDeviceToDevice, s);
  return e;
}

// One stage of K21a: mode 0, y = M a for all nb blocks; mode 1, the
// forward scan y_0 = a_0 - M_0 carry, y_k = a_k - M_k y_{k-1}; mode 2, the
// backward scan y_{nb-1} = a_{nb-1} - M_{nb-1} carry, y_k = a_k - M_k
// y_{k+1}. A null carry is zero: the first block of the scan is a's. y may
// alias a (in place), not the carry.
template <class Acc, class TM>
int carry_stage(const TM* M, const float* a, float* y, const float* carry,
                int nb, int c, int mode, cudaStream_t s) {
  if (mode == 0) return gemv<Acc>(M, a, nullptr, y, nb, c, s);
  const int64_t cc = (int64_t)c * c;
  int e = 0;
  for (int i = 0; i < nb && !e; ++i) {
    const int k = mode == 2 ? nb - 1 - i : i;
    const float* v = i == 0 ? carry
                            : y + (int64_t)(mode == 2 ? k + 1 : k - 1) * c;
    if (v)
      e = gemv<Acc>(M + k * cc, v, a + (int64_t)k * c, y + (int64_t)k * c, 1,
                    c, s);
    else if (y != a)
      e = (int)cudaMemcpyAsync(y + (int64_t)k * c, a + (int64_t)k * c,
                               sizeof(float) * (size_t)c,
                               cudaMemcpyDeviceToDevice, s);
  }
  return e;
}

// K21f-a: one warp per kTriRows rows of block k = blockIdx.y; the three
// vectors x_{k-1}, x_k, x_{k+1} in shared memory (a null neighbour zero).
constexpr int kTriRows = 2;
constexpr int kTriRowsPerBlock = kGemvWarps * kTriRows;

__global__ void __launch_bounds__(kGemvWarps * 32)
tri_residual_kernel(const float* __restrict__ C, const float* __restrict__ D,
                    const float* __restrict__ B, const float* __restrict__ x,
                    const float* __restrict__ xprev,
                    const float* __restrict__ xnext,
                    const float* __restrict__ r, float* __restrict__ y, int m,
                    int c) {
  extern __shared__ float4 s_v4[];
  float* s_v = reinterpret_cast<float*>(s_v4);  // [x_{k-1} | x_k | x_{k+1}]
  const int64_t k = blockIdx.y;
  const float* src[3] = {k > 0 ? x + (k - 1) * c : xprev, x + k * c,
                         k + 1 < m ? x + (k + 1) * c : xnext};
  for (int t = 0; t < 3; ++t)
    for (int j = threadIdx.x; j < c; j += blockDim.x)
      s_v[t * c + j] = src[t] ? src[t][j] : 0.f;
  __syncthreads();
  const float* Mt[3] = {C + k * c * (int64_t)c, D + k * c * (int64_t)c,
                        B + k * c * (int64_t)c};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = blockIdx.x * kTriRowsPerBlock + warp * kTriRows;
  if (i0 >= c) return;
  const int cv = c / 4;
  double s[kTriRows] = {};
  for (int t = 0; t < 3; ++t) {
    if (!src[t]) continue;
    const float4* v4 = s_v4 + t * cv;
    for (int j = lane; j < cv; j += 32) {
      const float4 f = v4[j];
      const double xv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int q = 0; q < kTriRows; ++q) {
        const int i = i0 + q;
        if (i >= c) break;
        const float4 mv =
            reinterpret_cast<const float4*>(Mt[t] + (int64_t)i * c)[j];
        s[q] = fma((double)mv.x, xv[0], s[q]);
        s[q] = fma((double)mv.y, xv[1], s[q]);
        s[q] = fma((double)mv.z, xv[2], s[q]);
        s[q] = fma((double)mv.w, xv[3], s[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kTriRows; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[q] += __shfl_down_sync(0xffffffffu, s[q], off);
    const int i = i0 + q;
    if (lane == 0 && i < c)
      y[k * c + i] = (float)((double)r[k * c + i] - s[q]);
  }
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

// K6: the two scans in place, x (nb, c) f32 holds r on entry and M r on
// exit, w (nb, c) f32 scratch. Storage: all f32 (plain float32 sums), f32
// Sinv with bf16 H/G (hg_bf16), or all bf16 (s_bf16 and hg_bf16), these
// two with compensated sums.
int vt_banded_solve(const void* Sinv, const void* H, const void* G, float* x,
                    float* w, int nb, int c, int s_bf16, int hg_bf16,
                    void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = (cudaStream_t)stream;
  if (s_bf16 && hg_bf16)
    return solve<Comp>((const bf*)Sinv, (const bf*)H, (const bf*)G, x, w, nb,
                       c, s);
  if (hg_bf16)
    return solve<Comp>((const float*)Sinv, (const bf*)H, (const bf*)G, x, w,
                       nb, c, s);
  if (s_bf16) return (int)cudaErrorInvalidValue;
  return solve<float>((const float*)Sinv, (const float*)H, (const float*)G, x,
                      w, nb, c, s);
}

// K12: the folded scans in place, x (nb, c) f32 holds r on entry and M r
// on exit, w (nb, c) and u (c,) f32 scratch; Sinv in bf16 (s_bf16) or
// f32, C and B in bf16.
int vt_banded_solve_lowmem(const void* Sinv, const void* C, const void* B,
                           float* x, float* w, float* u, int nb, int c,
                           int s_bf16, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = (cudaStream_t)stream;
  if (s_bf16)
    return solve_lowmem((const bf*)Sinv, (const bf*)C, (const bf*)B, x, w, u,
                        nb, c, s);
  return solve_lowmem((const float*)Sinv, (const bf*)C, (const bf*)B, x, w, u,
                      nb, c, s);
}

// K21a: one stage of a rank's solve (carry_stage: mode 0 t = Sinv r, 1
// forward, 2 backward) on (nb, c) f32 blocks; M in bf16 (m_bf16) or f32,
// summed in compensated float32 (comp, the hybrid and bf16 layouts, as
// K6) or plainly (f32 M only).
int vt_banded_carry(const void* M, const float* a, float* y,
                    const float* carry, int nb, int c, int m_bf16, int comp,
                    int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (m_bf16) {
    if (!comp) return (int)cudaErrorInvalidValue;
    return carry_stage<Comp>((const __nv_bfloat16*)M, a, y, carry, nb, c,
                             mode, s);
  }
  if (comp)
    return carry_stage<Comp>((const float*)M, a, y, carry, nb, c, mode, s);
  return carry_stage<float>((const float*)M, a, y, carry, nb, c, mode, s);
}

// K21a's chain carry update: y (c,) = a + T v, T (c, c) f32, plain float32
// sums; y may alias a.
int vt_banded_carry_update(const float* T, const float* v, const float* a,
                           float* y, int c, void* stream) {
  return gemv<float, true>(T, v, a, y, 1, c, (cudaStream_t)stream);
}

// K21f-a: y (m, c) = r - (D x + C x_{-1..m-2} + B x_{1..m}) per block,
// xprev / xnext the rows x_{-1} and x_m (null: zero); all float32, c a
// multiple of 4; y must not alias x.
int vt_banded_tri_residual(const float* C, const float* D, const float* B,
                           const float* x, const float* xprev,
                           const float* xnext, const float* r, float* y,
                           int m, int c, void* stream) {
  if (c % 4 || m < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * sizeof(float) * (size_t)c;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tri_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((c + kTriRowsPerBlock - 1) / kTriRowsPerBlock, m);
  tri_residual_kernel<<<grid, kGemvWarps * 32, smem, (cudaStream_t)stream>>>(
      C, D, B, x, xprev, xnext, r, y, m, c);
  return (int)cudaGetLastError();
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
