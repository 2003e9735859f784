// K17 (node-block preconditioner) on Hopper: extract, invert and apply the
// 6x6 (d, v) diagonal node blocks of the Ruiz-scaled element Jacobians,
// the preconditioner of make_step_fn's Newton step.
//
// Replaces vasp_tpu/fem/scaling.py build_node_block (:80-118),
// apply_node_block (:121-131) and vasp_tpu/fem/smallmat.py inv6 (:42).
// Plain torch twins: vasp_tpu_torch/kernels/nodeblock.py extract_plain,
// invert_plain, apply_plain.
//
// Extract (vt_node_block_extract): one thread per (cell, local P2 node k);
// it reads the node's 36 (d, v) entries of the cell's scaled float64
// Jacobian, rows and columns at the local indices 3k..3k+2 (d) and
// 30+3k..30+3k+2 (v), and adds them with float64 atomicAdd into the 6x6
// block of the global P2 node dofs[3k] / 3. Facet blocks (fewer than 60
// local dofs) are not launched, as vasp_tpu skips them.
//   Bound: the bytes it must move, 10 x 36 x 8 read a cell (360 of the
//   cell's 4,096 entries) and 36 x 8 written a node: ~60 MB at 20,832
//   cells, ~0.02 ms at 3.35 TB/s. Design: the threads of a cell are
//   neighbours, so a row's three entries share a sector; the atomics on
//   a node collide only between the cells that share it.
//
// Invert (vt_node_block_invert): one thread per P2 node: the bc masking
// (constrained rows become identity rows, constrained columns of the
// other rows zero), + 1e-8 on the diagonal, then the closed-form inverse
// in float64: A^-1 by its adjugate, the 3x3 Schur complement S = D - C A^-1
// B and its adjugate inverse, and the four blocks, with vasp_tpu's
// association of every product. Products and sums are rounded one by one
// (no FMA contraction), each 3-term dot product summed in index order,
// so that the kernel rounds as the plain version's separate operations.
//   Bound: 2 x 36 x 8 bytes a node read and written against ~700
//   operations a node: the operations, ~0.02 ms at 67 TFLOP/s at 93,000
//   nodes.
//
// Apply (vt_node_block_apply): one thread per P2 node does the 6x6 float64
// GEMV on [r_d, r_v] of its node; the threads past the last node copy the
// pressure entries r[off_p:] through. Bound: the read of the inverses (36 x
// 8 bytes a node) and of r, the write of y.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// c = a @ b for row-major 3x3 blocks, each entry summed in index order
__device__ void matmul3(const double a[9], const double b[9], double c[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[3 * i + j] = add(add(mul(a[3 * i], b[j]), mul(a[3 * i + 1], b[3 + j])),
                         mul(a[3 * i + 2], b[6 + j]));
    }
  }
}

// the adjugate inverse of a 3x3 block, as fem/smallmat.py det3 / adj3 / inv3
__device__ void inv3(const double A[9], double out[9]) {
  const double a00 = A[0], a01 = A[1], a02 = A[2];
  const double a10 = A[3], a11 = A[4], a12 = A[5];
  const double a20 = A[6], a21 = A[7], a22 = A[8];
  const double det = add(sub(mul(a00, sub(mul(a11, a22), mul(a12, a21))),
                             mul(a01, sub(mul(a10, a22), mul(a12, a20)))),
                         mul(a02, sub(mul(a10, a21), mul(a11, a20))));
  const double c[9] = {
      sub(mul(a11, a22), mul(a12, a21)), sub(mul(a02, a21), mul(a01, a22)),
      sub(mul(a01, a12), mul(a02, a11)), sub(mul(a12, a20), mul(a10, a22)),
      sub(mul(a00, a22), mul(a02, a20)), sub(mul(a02, a10), mul(a00, a12)),
      sub(mul(a10, a21), mul(a11, a20)), sub(mul(a01, a20), mul(a00, a21)),
      sub(mul(a00, a11), mul(a01, a10))};
#pragma unroll
  for (int e = 0; e < 9; ++e) out[e] = __ddiv_rn(c[e], det);
}

__global__ void __launch_bounds__(kThreads)
extract_kernel(const double* __restrict__ A, const int64_t* __restrict__ dofs,
               int K, int nloc, double* __restrict__ nb) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)K * 10) return;
  const int64_t cell = t / 10;
  const int k = (int)(t - cell * 10);
  const int64_t node = dofs[cell * nloc + 3 * k] / 3;
  const double* Ac = A + cell * nloc * nloc;
  double* out = nb + node * 36;
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int row = (s < 3 ? 3 * k + s : 30 + 3 * k + s - 3);
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const int col = (u < 3 ? 3 * k + u : 30 + 3 * k + u - 3);
      atomicAdd(out + 6 * s + u, Ac[row * nloc + col]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
invert_kernel(const double* __restrict__ nb, const bool* __restrict__ mask,
              int64_t n_p2, double* __restrict__ pinv) {
  const int64_t node = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_p2) return;
  bool m[6];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    m[s] = mask[3 * node + s];
    m[3 + s] = mask[3 * n_p2 + 3 * node + s];
  }
  double M[36];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      double v = nb[node * 36 + 6 * i + j];
      if (m[i]) {
        v = (i == j) ? 1.0 : 0.0;
      } else if (m[j]) {
        v = 0.0;
      }
      if (i == j) v = add(v, 1e-8);
      M[6 * i + j] = v;
    }
  }
  double A[9], B[9], C[9], D[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = M[6 * i + j];
      B[3 * i + j] = M[6 * i + 3 + j];
      C[3 * i + j] = M[6 * (3 + i) + j];
      D[3 * i + j] = M[6 * (3 + i) + 3 + j];
    }
  }
  double Ai[9], AiB[9], CAiB[9], S[9], Si[9], CAi[9], T[9], TL[9], TR[9],
      BL[9];
  inv3(A, Ai);
  matmul3(Ai, B, AiB);
  matmul3(C, AiB, CAiB);
#pragma unroll
  for (int e = 0; e < 9; ++e) S[e] = sub(D[e], CAiB[e]);
  inv3(S, Si);
  matmul3(C, Ai, CAi);
  matmul3(AiB, Si, TR);  // AiB @ Si, negated below
  matmul3(TR, CAi, T);   // (AiB @ Si) @ CAi
  matmul3(Si, CAi, BL);  // Si @ CAi, negated below
#pragma unroll
  for (int e = 0; e < 9; ++e) TL[e] = add(Ai[e], T[e]);
  double* out = pinv + node * 36;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[6 * i + j] = TL[3 * i + j];
      out[6 * i + 3 + j] = -TR[3 * i + j];
      out[6 * (3 + i) + j] = -BL[3 * i + j];
      out[6 * (3 + i) + 3 + j] = Si[3 * i + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const double* __restrict__ pinv, const double* __restrict__ r,
             int64_t n_p2, int64_t off_p, int64_t ndof, double* __restrict__ y) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_p2) {
    double rb[6];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      rb[s] = r[3 * t + s];
      rb[3 + s] = r[3 * n_p2 + 3 * t + s];
    }
    const double* P = pinv + t * 36;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      double s = 0.0;
#pragma unroll
      for (int j = 0; j < 6; ++j) s += P[6 * i + j] * rb[j];
      y[i < 3 ? 3 * t + i : 3 * n_p2 + 3 * t + i - 3] = s;
    }
  } else if (off_p + (t - n_p2) < ndof) {
    y[off_p + (t - n_p2)] = r[off_p + (t - n_p2)];
  }
}

}  // namespace

extern "C" {

// A (K,nloc,nloc) float64 with nloc >= 60, dofs (K,nloc) int64, nb (n_p2,6,6)
// float64 accumulated into.
int vt_node_block_extract(const double* A, const int64_t* dofs, int K, int nloc,
                          double* nb, void* stream) {
  const int64_t n = (int64_t)K * 10;
  if (n > 0) {
    extract_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(A, dofs, K, nloc, nb);
  }
  return (int)cudaGetLastError();
}

// nb and pinv (n_p2,6,6) float64, mask (ndof,) bool.
int vt_node_block_invert(const double* nb, const bool* mask, int64_t n_p2,
                         double* pinv, void* stream) {
  if (n_p2 > 0) {
    invert_kernel<<<(unsigned)((n_p2 + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(nb, mask, n_p2, pinv);
  }
  return (int)cudaGetLastError();
}

// pinv (n_p2,6,6), r and y (ndof,) float64; off_p = 6 n_p2.
int vt_node_block_apply(const double* pinv, const double* r, int64_t n_p2,
                        int64_t off_p, int64_t ndof, double* y, void* stream) {
  const int64_t n = n_p2 + (ndof - off_p);
  if (n > 0) {
    apply_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(pinv, r, n_p2, off_p, ndof, y);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
