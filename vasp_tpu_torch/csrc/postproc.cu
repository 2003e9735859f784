// K20 (the device code of postprocessing) on Hopper, float64 throughout:
//
// K20a wss_load: the wall-shear-stress load of the fluid boundary.
//   Replaces vasp_tpu/postprocessing/fields/hemodynamics.py
//   FluidBoundaryTables.wss_series (its jitted one_step, :143-153). Per
//   marked fluid-boundary facet k and timestep t: gather the attached fluid
//   cell's 10 P2 velocities, grad u at the nq facet points from the
//   tabulated physical gradients G2 (K,nq,10,3), sigma = mu (grad u +
//   grad u^T), the traction sigma n, its tangential part tau, and the P1
//   load sum_q w_q N_a(q) tau area2 scatter-added into the (T, n_bnodes, 3)
//   load. The consistent boundary-mass solve stays on the host (splu).
// K20b stress_strain: stress and strain of the solid at its cell vertices.
//   Replaces vasp_tpu/postprocessing/fields/stress_strain.py one_step_full
//   (:166-182) with cellvert (:112-120) and vasp_tpu/fem/kinematics.py
//   get_eig (:133). Per solid (cell, vertex) and timestep: grad d from the
//   P2 gather and G (K,4,10,3), F = I + grad d, J = det F, E, S (SVK or
//   Mooney-Rivlin: the device functions of element_forms.cuh, one kernel
//   instance per material), sigma = F S F^T / J, and the Cardano largest
//   eigenvalue of sigma and of E. E is the cancellation-free
//   (H + H^T + H^T H)/2 of element_forms.cuh, where vasp_tpu writes
//   (F^T F - I)/2: they agree to rounding, absolute ~1e-16.
//   vt_max_eig is the eigenvalue alone, for the band-pass strain amplitude
//   tensors of spectral/hi_pass_viz.py.
// K20c spectral_power: the power pass of the PSD and the spectrogram.
//   Replaces vasp_tpu/postprocessing/spectral/core.py get_psd (:34-55) and
//   get_spectrogram (:57-103) after their rfft: from the complex128
//   spectrum X (n, B, F), out[f, b] = scale c_f / n sum_node |X[node,b,f]|^2
//   with the one-sided correction c_f = 2 except at DC and, for an even
//   FFT length, at Nyquist. The FFT itself is cuFFT through torch.fft, as
//   vasp_tpu leaves it to XLA's FFT.
//
// What bounds them on an H100 and what the design does about it:
// - K20a: ~1 KB of gathered velocities and tables and ~80 FLOP x nq x 30
//   per (facet, step): both tiny; a few thousand facets x T steps. One
//   thread per (facet, step), the steps on the grid's second axis (a
//   stride loop past its 65,535 blocks), the quadrature loop in registers,
//   the load scattered by native f64 atomicAdd (its order varies from run
//   to run, which moves the load by rounding only). The tables come as
//   device pointers.
// - K20b: bytes. It writes 20 doubles per (cell, vertex, step) and reads a
//   30-double gather and a 30-double G row. One thread per (cell, vertex,
//   step), the steps on the grid's second axis as in K20a; every output
//   is written once, threads of a warp on neighbouring (cell, vertex) rows.
// - K20c: bytes. It reads the whole spectrum once and writes F x B doubles.
//   One block per (frequency tile of 32, frame), the frames strided as
//   K20a's steps: 32 x 16 threads, the 32 frequencies of a tile contiguous
//   in memory, 16 lanes over the nodes in a fixed order, then a
//   fixed-order tree over the lanes in shared memory. No atomics, so
//   repeated runs give the same bits.
#include <cstdint>

#include "element_forms.cuh"

namespace {

// Cardano largest eigenvalue of a symmetric 3x3 tensor, as vasp_tpu's
// get_eig: q = tr/3, B = A - q I, p2 = sum(B*B)/2, p = sqrt(max(p2/3,
// 1e-300)), r = det(B) / max(2 p^3, 1e-300) clipped to [-1, 1],
// q + 2 p cos(acos(r)/3), and q itself when p2 <= 1e-30 (isotropic).
__device__ inline double max_eig(const double A[3][3]) {
  const double q = (A[0][0] + A[1][1] + A[2][2]) / 3.0;
  double B[3][3];
  double p2 = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      B[i][j] = A[i][j] - (i == j ? q : 0.0);
      p2 += B[i][j] * B[i][j];
    }
  p2 *= 0.5;
  const double p = sqrt(fmax(p2 / 3.0, 1e-300));
  double r = det3(B) / fmax(2.0 * p * p * p, 1e-300);
  r = fmin(fmax(r, -1.0), 1.0);
  const double eig = q + 2.0 * p * cos(acos(r) / 3.0);
  return p2 <= 1e-30 ? q : eig;
}

constexpr int kWssThreads = 128;

__global__ void __launch_bounds__(kWssThreads)
wss_load_kernel(const double* __restrict__ u, const int64_t* __restrict__ dofs,
                const double* __restrict__ G2, const double* __restrict__ normals,
                const double* __restrict__ wq, const double* __restrict__ N1f,
                const double* __restrict__ area2, const int64_t* __restrict__ fb,
                double* __restrict__ load, int K, int nq, int T, int64_t n_p2,
                int nb, double mu) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const double n[3] = {normals[k * 3], normals[k * 3 + 1], normals[k * 3 + 2]};
  const double a2 = area2[k];
  for (int64_t t = blockIdx.y; t < T; t += gridDim.y) {
    const double* ut = u + t * n_p2 * 3;
    double ue[10][3];
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      const int64_t node = dofs[(int64_t)k * 10 + a];
#pragma unroll
      for (int i = 0; i < 3; ++i) ue[a][i] = ut[node * 3 + i];
    }
    double b[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
    for (int q = 0; q < nq; ++q) {
      const double* G = G2 + ((int64_t)k * nq + q) * 30;
      double g[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          double s = 0.0;
#pragma unroll
          for (int a = 0; a < 10; ++a) s += ue[a][i] * G[a * 3 + j];
          g[i][j] = s;
        }
      double tr[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < 3; ++j) s += mu * (g[i][j] + g[j][i]) * n[j];
        tr[i] = s;
      }
      const double tn = tr[0] * n[0] + tr[1] * n[1] + tr[2] * n[2];
      const double w = wq[q] * a2;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const double wn = w * N1f[q * 3 + a];
#pragma unroll
        for (int i = 0; i < 3; ++i) b[a][i] += wn * (tr[i] - tn * n[i]);
      }
    }
    double* lt = load + t * (int64_t)nb * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int64_t node = fb[(int64_t)k * 3 + a];
#pragma unroll
      for (int i = 0; i < 3; ++i) atomicAdd(lt + node * 3 + i, b[a][i]);
    }
  }
}

constexpr int kStressThreads = 128;

// One (cell, vertex) row of one step: dt the step's displacement rows,
// dk the cell's 10 P2 dofs, Gk the vertex's physical gradients (10, 3).
template <int MAT>
__device__ inline void stress_strain_row(const double* __restrict__ dt,
                                         const int64_t* __restrict__ dk,
                                         const double* __restrict__ Gk,
                                         const SolidParams<double>& P, int64_t row,
                                         double* __restrict__ sig, double* __restrict__ eps,
                                         double* __restrict__ mps,
                                         double* __restrict__ mpe) {
  double H[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const int64_t node = dk[a];
    const double da[3] = {dt[node * 3], dt[node * 3 + 1], dt[node * 3 + 2]};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) H[i][j] += da[i] * Gk[a * 3 + j];
  }
  double E[3][3], S[3][3], F[3][3];
  green_lagrange<double>(H, E);
  if constexpr (MAT == kMooneyRivlin)
    mr_stress(E, P, S);
  else
    svk_stress(E, P, S);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) F[i][j] = H[i][j] + (i == j ? 1.0 : 0.0);
  const double J = det3(F);
  double FS[3][3], s[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      FS[i][j] = F[i][0] * S[0][j] + F[i][1] * S[1][j] + F[i][2] * S[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s[i][j] = (FS[i][0] * F[j][0] + FS[i][1] * F[j][1] + FS[i][2] * F[j][2]) / J;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sig[row * 9 + i * 3 + j] = s[i][j];
      eps[row * 9 + i * 3 + j] = E[i][j];
    }
  mps[row] = max_eig(s);
  mpe[row] = max_eig(E);
}

// Cells k0 .. k0 + Kseg - 1 of the (T, Ktot, 4, ...) outputs, one material.
template <int MAT>
__global__ void __launch_bounds__(kStressThreads)
stress_strain_kernel(const double* __restrict__ d, const int64_t* __restrict__ dofs,
                     const double* __restrict__ G, SolidParams<double> P,
                     double* __restrict__ sig, double* __restrict__ eps,
                     double* __restrict__ mps, double* __restrict__ mpe, int k0,
                     int Kseg, int Ktot, int T, int64_t n_p2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Kseg * 4) return;
  const int64_t k = k0 + e / 4;
  const int v = e % 4;
  for (int64_t t = blockIdx.y; t < T; t += gridDim.y)
    stress_strain_row<MAT>(d + t * n_p2 * 3, dofs + k * 10, G + (k * 4 + v) * 30, P,
                           (t * Ktot + k) * 4 + v, sig, eps, mps, mpe);
}

__global__ void __launch_bounds__(kStressThreads)
max_eig_kernel(const double* __restrict__ A, double* __restrict__ out, int64_t N) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  double M[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) M[r][c] = A[i * 9 + r * 3 + c];
  out[i] = max_eig(M);
}

constexpr int kFreqTile = 32;
constexpr int kNodeLanes = 16;

__global__ void __launch_bounds__(kFreqTile * kNodeLanes)
spectral_power_kernel(const double2* __restrict__ X, double* __restrict__ out, int n,
                      int B, int F, double scale, int even) {
  __shared__ double part[kNodeLanes][kFreqTile];
  const int f = blockIdx.x * kFreqTile + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    double s = 0.0;
    if (f < F) {
      for (int node = threadIdx.y; node < n; node += kNodeLanes) {
        const double2 x = X[((int64_t)node * B + b) * F + f];
        s += x.x * x.x + x.y * x.y;
      }
    }
    part[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
#pragma unroll
    for (int h = kNodeLanes / 2; h > 0; h /= 2) {
      if (threadIdx.y < h) part[threadIdx.y][threadIdx.x] += part[threadIdx.y + h][threadIdx.x];
      __syncthreads();
    }
    if (threadIdx.y == 0 && f < F) {
      const double c = (f == 0 || (even && f == F - 1)) ? 1.0 : 2.0;
      out[(int64_t)f * B + b] = part[0][threadIdx.x] * scale * c / n;
    }
    __syncthreads();  // part is refilled for the next frame
  }
}

// Blocks on the grid's second axis (at most 65,535); the kernels stride
// over the steps (frames) past it.
inline unsigned grid_steps(int T) { return T < 65535 ? (unsigned)T : 65535u; }

}  // namespace

extern "C" {

// u (T, n_p2, 3) f64; dofs (K,10) int64; G2 (K,nq,10,3), normals (K,3),
// wq (nq,), N1f (nq,3), area2 (K,) f64; fb (K,3) int64 boundary-node ids;
// load (T, nb, 3) f64, zeroed by the caller, is accumulated into.
int vt_wss_load(const double* u, const int64_t* dofs, const double* G2,
                const double* normals, const double* wq, const double* N1f,
                const double* area2, const int64_t* fb, double* load, int K, int nq,
                int T, int64_t n_p2, int nb, double mu, void* stream) {
  if (K > 0 && T > 0) {
    const dim3 grid((K + kWssThreads - 1) / kWssThreads, grid_steps(T));
    wss_load_kernel<<<grid, kWssThreads, 0, (cudaStream_t)stream>>>(
        u, dofs, G2, normals, wq, N1f, area2, fb, load, K, nq, T, n_p2, nb, mu);
  }
  return (int)cudaGetLastError();
}

// d (T, n_p2, 3) f64; dofs (Ktot,10) int64; G (Ktot,4,10,3) f64; the
// material mat (0 SVK, 1 Mooney-Rivlin) with its constants; cells k0 ..
// k0 + Kseg - 1 of sig, eps (T,Ktot,4,3,3) and mps, mpe (T,Ktot,4) f64.
int vt_stress_strain(const double* d, const int64_t* dofs, const double* G, int mat,
                     double mu, double lam, double C01, double C10, double C11,
                     double* sig, double* eps, double* mps, double* mpe, int k0,
                     int Kseg, int Ktot, int T, int64_t n_p2, void* stream) {
  if (Kseg > 0 && T > 0) {
    // rho, dt and theta serve the residual only
    const SolidParams<double> P =
        make_solid_params<double>(1.0, mu, lam, 1.0, 1.0, C01, C10, C11);
    const dim3 grid((Kseg * 4 + kStressThreads - 1) / kStressThreads, grid_steps(T));
    cudaStream_t s = (cudaStream_t)stream;
    if (mat == kMooneyRivlin)
      stress_strain_kernel<kMooneyRivlin><<<grid, kStressThreads, 0, s>>>(
          d, dofs, G, P, sig, eps, mps, mpe, k0, Kseg, Ktot, T, n_p2);
    else
      stress_strain_kernel<kSVK><<<grid, kStressThreads, 0, s>>>(
          d, dofs, G, P, sig, eps, mps, mpe, k0, Kseg, Ktot, T, n_p2);
  }
  return (int)cudaGetLastError();
}

// A (N,3,3) symmetric f64 -> out (N,) its largest eigenvalue.
int vt_max_eig(const double* A, double* out, int64_t N, void* stream) {
  if (N > 0) {
    const int64_t blocks = (N + kStressThreads - 1) / kStressThreads;
    max_eig_kernel<<<(unsigned)blocks, kStressThreads, 0, (cudaStream_t)stream>>>(A, out,
                                                                                  N);
  }
  return (int)cudaGetLastError();
}

// X (n, B, F) complex128 -> out (F, B) f64: the node mean of scale |X|^2
// with the one-sided correction (even: the FFT length is even).
int vt_spectral_power(const void* X, double* out, int n, int B, int F, double scale,
                      int even, void* stream) {
  if (n > 0 && B > 0 && F > 0) {
    const dim3 grid((F + kFreqTile - 1) / kFreqTile, grid_steps(B));
    const dim3 block(kFreqTile, kNodeLanes);
    spectral_power_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const double2*)X, out, n, B, F, scale, even);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
