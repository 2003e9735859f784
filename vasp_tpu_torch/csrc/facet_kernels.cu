// K14 (the Robin facet term of the solid's outer wall: residual + scatter,
// float64 and float32 facet work, and its facet Jacobians) on Hopper.
//
// Replaces vasp_tpu/fem/forms.py make_robin_kernel through
// vasp_tpu/fem/assembly.py FacetBlock.residual_local (vmapped kernel, then
// the scatter-add of Assembler.residual; with dtype=float32 the facet work
// in float32 on float32-rounded inputs, accumulated in float64) and
// FacetBlock.jacobian_local (jax.jacfwd through chunked_vmap). Plain torch
// twin: vasp_tpu_torch/kernels/facet.py residual_plain / jacobian_plain.
//
// The local vector is u (36,) = [d (6x3), v (6x3)] on a P2 triangle; the
// residual's d rows are zero and its v rows take
//   r[a][i] = sum_q w_q area2 N_a(q) (k_s d_q,i + c_s v_q,i).
// The term is linear, so its 36x36 Jacobian is constant in u:
//   [[0, 0], [k_s M (x) I3, c_s M (x) I3]],  M_ab = area2 sum_q w_q N_a N_b.
//
// What bounds them on an H100 and what the design does about it: a few
// thousand facets (1,984 on the 20,832-cell aneurysm tube) of a 36-entry
// gather and 18 scattered f64 atomics, or 1,296 written entries, each: the
// bytes are microseconds, so a launch is latency-bound. The residual runs
// one thread per facet with its quadrature loop in registers and scatters
// by native f64 atomicAdd into R (the atomics' order varies, which moves R
// by rounding only); the float32 instance (S = float) rounds every input on
// its read, reads float32 tables and does float32 arithmetic, with the f64
// scatter. The Jacobian is written from its closed form: one block per
// facet forms M in float64 in shared memory, then its threads write the
// block's entries row-major (coalesced), in float64 or rounded once to
// float32 (as K3 rounds its Jacobians). The rule's few-hundred-byte tables
// come as device pointers in the work's type; every thread of a warp reads
// the same entry, a cached broadcast, so there is no upload and no state
// between calls.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kResidualThreads = 128;

template <class S>
__global__ void __launch_bounds__(kResidualThreads)
robin_residual_kernel(const double* __restrict__ U, const int64_t* __restrict__ dofs,
                      const double* __restrict__ area2, const S* __restrict__ wq,
                      const S* __restrict__ N2t, double* __restrict__ R, int K, int nq,
                      S ks, S cs) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int64_t* dk = dofs + (int64_t)k * 36;
  S d[18], v[18], r[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    d[i] = S(U[dk[i]]);
    v[i] = S(U[dk[18 + i]]);
    r[i] = S(0);
  }
  const S a2 = S(area2[k]);
  for (int q = 0; q < nq; ++q) {
    S dq[3] = {S(0), S(0), S(0)}, vq[3] = {S(0), S(0), S(0)};
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      const S n = N2t[q * 6 + b];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dq[i] += n * d[b * 3 + i];
        vq[i] += n * v[b * 3 + i];
      }
    }
    const S wa = wq[q] * a2;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const S val = ks * dq[i] + cs * vq[i];
#pragma unroll
      for (int a = 0; a < 6; ++a) r[a * 3 + i] += wa * N2t[q * 6 + a] * val;
    }
  }
  // the d rows are zero: only the v rows are scattered
#pragma unroll
  for (int i = 0; i < 18; ++i) atomicAdd(R + dk[18 + i], double(r[i]));
}

constexpr int kJacobianThreads = 128;

template <class TOut>
__global__ void __launch_bounds__(kJacobianThreads)
robin_jacobian_kernel(const double* __restrict__ area2, const double* __restrict__ wq,
                      const double* __restrict__ N2t, TOut* __restrict__ A, int nq,
                      double ks, double cs) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  __shared__ double s_M[36];
  if (t < 36) {
    const int a = t / 6, b = t % 6;
    double m = 0.0;
    for (int q = 0; q < nq; ++q) m += wq[q] * N2t[q * 6 + a] * N2t[q * 6 + b];
    s_M[t] = area2[k] * m;
  }
  __syncthreads();
  TOut* Ak = A + (int64_t)k * 36 * 36;
  for (int e = t; e < 36 * 36; e += kJacobianThreads) {
    const int i = e / 36, j = e % 36;
    double val = 0.0;
    if (i >= 18) {
      const int a = (i - 18) / 3, ii = (i - 18) % 3;
      const int b = (j % 18) / 3, jj = j % 3;
      if (ii == jj) val = (j < 18 ? ks : cs) * s_M[a * 6 + b];
    }
    Ak[e] = (TOut)val;
  }
}

}  // namespace

extern "C" {

// U (ndof,) f64, dofs (K,36) int64, area2 (K,) f64, and the rule's wq
// (nq,) and N2t (nq,6) as device tensors of the work's type (float32 when
// f32 is nonzero, else float64); R (ndof,) f64 is accumulated into.
int vt_robin_residual(const double* U, const int64_t* dofs, const double* area2,
                      const void* wq, const void* N2t, int nq, double* R, int f32,
                      int K, double ks, double cs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K > 0) {
    const int blocks = (K + kResidualThreads - 1) / kResidualThreads;
    if (f32) {
      robin_residual_kernel<float><<<blocks, kResidualThreads, 0, s>>>(
          U, dofs, area2, (const float*)wq, (const float*)N2t, R, K, nq, (float)ks,
          (float)cs);
    } else {
      robin_residual_kernel<double><<<blocks, kResidualThreads, 0, s>>>(
          U, dofs, area2, (const double*)wq, (const double*)N2t, R, K, nq, ks, cs);
    }
  }
  return (int)cudaGetLastError();
}

// area2 (K,) f64 and the rule's float64 wq (nq,) and N2t (nq,6) as device
// tensors -> A (K,36,36), float32 when out_f32 is nonzero, else float64.
int vt_robin_jacobian(const double* area2, const double* wq, const double* N2t,
                      int nq, void* A, int out_f32, int K, double ks, double cs,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K > 0 && out_f32) {
    robin_jacobian_kernel<float><<<K, kJacobianThreads, 0, s>>>(
        area2, wq, N2t, (float*)A, nq, ks, cs);
  } else if (K > 0) {
    robin_jacobian_kernel<double><<<K, kJacobianThreads, 0, s>>>(
        area2, wq, N2t, (double*)A, nq, ks, cs);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
