// K19 on Hopper: the per-step flow measures and the minimum-Jacobian guard
// of the models' post_solve.
//
// Replaces vasp_tpu/fem/measures.py: dg0_project_speed (cell average of
// |v| for a P2 field), BoundaryMeasure.integrate_p2_dot_n (the inlet flow
// rate, int v.n ds) and dg0_project_jacobian (cell average of
// det(I + grad d) for a P2 displacement). Plain torch twins:
// vasp_tpu_torch/kernels/measures.py dg0_project_speed_plain /
// integrate_p2_dot_n_plain / dg0_project_jacobian_plain.
//
// All three are bound by their gathers (10x3 or 6x3 doubles per item, plus
// the cell's 3x3 Jinv for the Jacobian, against a few hundred FLOPs) and,
// for the flux, by the reduction to one number. One thread per cell or
// facet; the flux sums each block in registers and shared memory and issues
// one f64 atomicAdd per block. The rules' tables come as device pointers;
// every thread of a warp reads the same entry, a cached broadcast.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void dg0_speed_kernel(const double* __restrict__ v,
                                 const int64_t* __restrict__ cell_dofs,
                                 const double* __restrict__ N2,
                                 const double* __restrict__ wq, int nq,
                                 double wsum, double* __restrict__ out, int Nc) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= Nc) return;
  double ve[10][3];
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const int64_t g = cell_dofs[(int64_t)k * 10 + a];
#pragma unroll
    for (int i = 0; i < 3; ++i) ve[a][i] = v[g * 3 + i];
  }
  double s = 0.0;
  for (int q = 0; q < nq; ++q) {
    double vq[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const double n = N2[q * 10 + a];
#pragma unroll
      for (int i = 0; i < 3; ++i) vq[i] += n * ve[a][i];
    }
    s += wq[q] * sqrt(vq[0] * vq[0] + vq[1] * vq[1] + vq[2] * vq[2]);
  }
  out[k] = s / wsum;
}

constexpr int kFluxThreads = 256;

__global__ void __launch_bounds__(kFluxThreads)
p2_flux_kernel(const double* __restrict__ field, const int64_t* __restrict__ dofs,
               const double* __restrict__ normals, const double* __restrict__ area2,
               const double* __restrict__ N2t, const double* __restrict__ wq,
               int nq, int K, double* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  double s = 0.0;
  if (k < K) {
    double ue[6][3];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int64_t g = dofs[(int64_t)k * 6 + a];
#pragma unroll
      for (int i = 0; i < 3; ++i) ue[a][i] = field[g * 3 + i];
    }
    const double n0 = normals[k * 3], n1 = normals[k * 3 + 1], n2 = normals[k * 3 + 2];
    for (int q = 0; q < nq; ++q) {
      double uq[3] = {0.0, 0.0, 0.0};
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const double n = N2t[q * 6 + a];
#pragma unroll
        for (int i = 0; i < 3; ++i) uq[i] += n * ue[a][i];
      }
      s += wq[q] * (uq[0] * n0 + uq[1] * n1 + uq[2] * n2);
    }
    s *= area2[k];
  }
  // block reduction: warp shuffles, then one warp over the warp sums
  __shared__ double warp_sums[kFluxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kFluxThreads / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) atomicAdd(out, s);
  }
}

__global__ void dg0_jacobian_kernel(const double* __restrict__ d,
                                    const int64_t* __restrict__ cell_dofs,
                                    const double* __restrict__ Jinv,
                                    const double* __restrict__ dN2,
                                    const double* __restrict__ wq, int nq,
                                    double* __restrict__ out, int Nc) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= Nc) return;
  double de[10][3], J[9];
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const int64_t g = cell_dofs[(int64_t)k * 10 + a];
#pragma unroll
    for (int i = 0; i < 3; ++i) de[a][i] = d[g * 3 + i];
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = Jinv[(int64_t)k * 9 + i];
  double s = 0.0, wsum = 0.0;
  for (int q = 0; q < nq; ++q) {
    // F = I + grad d, grad d[i][l] = sum_a d_a,i G2[a][l] with
    // G2[a][l] = sum_j dN2[q][a][j] Jinv[j][l]
    double F[3][3] = {};
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const double* dn = dN2 + (q * 10 + a) * 3;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const double g = dn[0] * J[l] + dn[1] * J[3 + l] + dn[2] * J[6 + l];
#pragma unroll
        for (int i = 0; i < 3; ++i) F[i][l] += de[a][i] * g;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) F[i][i] += 1.0;
    const double det = F[0][0] * (F[1][1] * F[2][2] - F[1][2] * F[2][1]) -
                       F[0][1] * (F[1][0] * F[2][2] - F[1][2] * F[2][0]) +
                       F[0][2] * (F[1][0] * F[2][1] - F[1][1] * F[2][0]);
    s += wq[q] * det;
    wsum += wq[q];
  }
  out[k] = s / wsum;
}

}  // namespace

extern "C" {

// d (n2,3), cell_dofs (Nc,10) int64, Jinv (Nc,3,3), and the rule's dN2
// (nq,10,3) and wq (nq,) as device tensors -> out (Nc,); all float64.
int vt_dg0_project_jacobian(const double* d, const int64_t* cell_dofs,
                            const double* Jinv, const double* dN2,
                            const double* wq, int nq, double* out, int Nc,
                            void* stream) {
  if (Nc > 0) {
    const int threads = 128;
    dg0_jacobian_kernel<<<(Nc + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        d, cell_dofs, Jinv, dN2, wq, nq, out, Nc);
  }
  return (int)cudaGetLastError();
}


// v (n2,3), cell_dofs (Nc,10) int64, N2 (nq,10), wq (nq,) -> out (Nc,)
int vt_dg0_project_speed(const double* v, const int64_t* cell_dofs,
                         const double* N2, const double* wq, int nq, double wsum,
                         double* out, int Nc, void* stream) {
  if (Nc > 0) {
    const int threads = 128;
    dg0_speed_kernel<<<(Nc + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        v, cell_dofs, N2, wq, nq, wsum, out, Nc);
  }
  return (int)cudaGetLastError();
}

// field (n2,3), dofs (K,6) int64, normals (K,3), area2 (K,), N2t (nq,6),
// wq (nq,) -> out (1,), which the caller zeroes first.
int vt_integrate_p2_dot_n(const double* field, const int64_t* dofs,
                          const double* normals, const double* area2,
                          const double* N2t, const double* wq, int nq, int K,
                          double* out, void* stream) {
  if (K > 0) {
    p2_flux_kernel<<<(K + kFluxThreads - 1) / kFluxThreads, kFluxThreads, 0,
                     (cudaStream_t)stream>>>(field, dofs, normals, area2, N2t, wq, nq, K, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
