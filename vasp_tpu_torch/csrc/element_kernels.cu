// K1/K2 (element residual + scatter, float64 and float32 element work) and
// K3 (element Jacobians) on Hopper; the fluid with Laplace, elastic or no
// mesh lifting, the solid in St.Venant-Kirchhoff or Mooney-Rivlin, one
// kernel instance per lifting mode and per material; the fluid's pressure
// stabilization (p_stab) and the solid's gravity are parameters of those
// instances, their zero values the old path.
//
// Replaces vasp_tpu/fem/assembly.py: CellBlock.residual_local with
// Assembler.residual (vmapped make_fluid_kernel / make_solid_kernel, then
// a scatter-add into R; with dtype=float32 the element work in float32 on
// float32-rounded inputs, accumulated in float64), and
// CellBlock.jacobian_local (jax.jacfwd through chunked_vmap). Plain torch
// twin: vasp_tpu_torch/kernels/element.py residual_plain / jacobian_plain.
//
// What bounds them on an H100 and what the design does about it:
// - Residual (element_residual.cuh): a few hundred KFLOP per cell against
//   a 64-entry gather and 64 scattered f64 atomics. One thread per cell
//   keeps the whole quadrature loop in registers (spills to L1 accepted);
//   the scatter is a native f64 atomicAdd straight into R, so no (K,64)
//   intermediate goes through device memory. The atomics' order varies
//   from run to run, which moves R by rounding only. The float32 instance
//   (S = float) runs the same code at twice the f64 rate with half the
//   registers per value; it reads float32 copies of the tables and keeps
//   the f64 scatter. The tables sit in the constant bank (every thread
//   reads the same entry: a broadcast) where the rule fits it, else in
//   device memory (element_global.cu's instances).
// - Jacobian: f64 operations. The forms are linearised at the quadrature
//   points (element_forms.cuh): A_e = sum_q w_q detJ Phi_out^T D_q Phi_in,
//   D_q the derivative of the point flux by the point state. One block of
//   256 threads per cell walks the points in chunks of qc (10 fluid, 17
//   solid points: one tangent a thread), each chunk in four steps with the
//   results in shared memory:
//   1. the chunk's P2 values and physical gradients, N1 and w_q detJ;
//   2. its point states s_q and s0_q, a thread a slot, and the previous
//      state's part of the flux, a thread a point;
//   3. D_q w_q detJ: a thread a (point, state slot) runs the form's own
//      point flux on Dual numbers seeded with that slot's unit tangent, 25
//      (solid 15) tangents a point, each through one point's flux (the
//      cell-level forward mode it replaces ran 64 tangents, each through
//      the whole cell's residual, and spilled its 64-entry Dual arrays);
//   4. the contraction into registers: 180 threads each own (component i
//      of the rows, i2 of the columns, column node b, half the row nodes)
//      and its 20 entries in the four (d/v rows, d/v columns) blocks;
//      per point each forms U = D_q(Y i ., X i2 .) phi_b and adds phi_a . U.
//      Which slots a form reads and writes is known at compile time, so a
//      structural zero costs nothing. 25 more threads own the p rows and
//      columns. D_q and the basis sit in rows of even length, read in
//      128-bit loads.
//   After the last chunk the 4096 entries are staged in shared memory and
//   written once, in row order (coalesced), row-masked, as TOut: f64, or
//   the f64 value rounded once to f32 for the iterative path's
//   preconditioner and Krylov matrices (jac_dtype="f32"), where vasp_tpu
//   runs jax.jacfwd in f32 arithmetic on f32 inputs. Shared memory
//   8 (144 + max(770 qc, 4096)) bytes, dynamic (62 KB fluid, 104 KB solid);
//   the tables come from device memory through the read-only path, so any
//   degree runs. What holds it back (H100, the 20,832-cell tube's fluid
//   block, 7.2 ms against a 1.10 ms bound): the contraction takes ~3.1 ms
//   at ~40 % of the f64 FMA rate, the Dual flux ~1.6 ms, steps 1-2 and the
//   write ~1.3 ms; two blocks an SM (128 registers, ~500 bytes of spill)
//   and five block barriers a chunk leave the FP64 pipes idle between the
//   steps (PERF.md §6).
#include "element_residual.cuh"

extern "C" {
int vt_fluid_residual_global(const double* U, const double* U0, const int64_t* dofs,
                             const double* Jinv, const double* detJ, const double* vol,
                             const double* rowmask, const void* tables, double* R,
                             int f32, int K, int nq, double rho, double mu, double dt,
                             double theta, double lift_coeff, int lift_sub,
                             int lift_mode, double p_stab, void* stream);
int vt_solid_residual_global(const double* U, const double* U0, const int64_t* dofs,
                             const double* Jinv, const double* detJ, const double* vol,
                             const double* rowmask, const void* tables, double* R,
                             int f32, int K, int nq, double rho, double mu, double lam,
                             double dt, double theta, int material, double C01,
                             double C10, double C11, double gx, double gy, double gz,
                             void* stream);
}

namespace {

constexpr int kJacThreads = 256;
// shared memory in doubles: u, u0 (64 each) and Jinv (9), padded; then a
// point's basis [10][4] (N2, G), its N1 and w_q detJ [8], its two states
// [kRow], its previous state's flux terms [kOld] and its D_q [25][kRow].
// Rows padded to an even count keep every block of a D_q row and every
// basis row 16-byte aligned, for 128-bit loads.
constexpr int kJacHead = 144;
constexpr int kRow = kSlots + 1;
constexpr int kOld = 20;  // FluidOld<double>: 19 doubles; SolidOld: 9
constexpr int kJacPoint = 40 + 8 + 2 * kRow + kOld + kSlots * kRow;
constexpr int kJacEntries = 64 * 64;
// the contraction's items (threads): the d/v blocks, the p columns, the p
// rows, the p-p block; the threads past them only load and differentiate
constexpr int kBlockItems = 180;
constexpr int kPColItems = 12;
constexpr int kPRowItems = 12;
constexpr int kPPItem = kBlockItems + kPColItems + kPRowItems;

// the most points a chunk of a form takes: one tangent a thread
template <class Cell>
__host__ __device__ constexpr int jac_chunk() {
  return kJacThreads / n_states<Cell>();
}

// the chunk buffers double as the staging of the finished A_e
__host__ __device__ constexpr int jac_smem_doubles(int qc) {
  return kJacHead + (qc * kJacPoint > kJacEntries ? qc * kJacPoint : kJacEntries);
}

// the n-th slot the form reads
template <class Cell>
__device__ inline int nth_state_slot(int n) {
  for (int sl = 0; sl < kSlots; ++sl)
    if (state_slot_on<Cell>(sl) && n-- == 0) return sl;
  return 0;
}

// four doubles at a 16-byte aligned address of shared memory, in two
// 128-bit loads; the second left out where the form needs only the first
// two (lo_only)
__device__ inline void load4(const double* p, double* x, bool lo_only = false) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  x[0] = a.x;
  x[1] = a.y;
  if (lo_only) return;
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  x[2] = b.x;
  x[3] = b.y;
}

// acc[(2 Y + X) * 5 + aa] += the points' terms of A at row 30 Y + 3 (5 h +
// aa) + i, column 30 X + 3 b + i2, for Y, X in {d, v}
template <class Cell>
__device__ inline void contract_blocks(int i, int i2, int b, int h, int nc,
                                       const double* phi, const double* D, double* acc) {
  for (int c = 0; c < nc; ++c) {
    const double* ph = phi + c * 40;
    const double* Dc = D + c * kSlots * kRow;
    double pb[4];
    load4(ph + b * 4, pb);
    // U = D_q(Y i ., X i2 .) phi_b for the four (Y, X) first, then one row
    // node's basis at a time: fewer live registers than all five rows'
    double Uv[2][2][4];
#pragma unroll
    for (int Y = 0; Y < 2; ++Y)
#pragma unroll
      for (int X = 0; X < 2; ++X)
#pragma unroll
        for (int al = 0; al < 4; ++al) {
          Uv[Y][X][al] = 0.0;
          if (!Cell::flux_on(Y, al)) continue;
          double Dr[4];
          load4(Dc + slot(Y, i, al) * kRow + slot(X, i2, 0), Dr,
                !Cell::state_on(X, 2) && !Cell::state_on(X, 3));
#pragma unroll
          for (int be = 0; be < 4; ++be)
            if (Cell::state_on(X, be)) Uv[Y][X][al] = fma(Dr[be], pb[be], Uv[Y][X][al]);
        }
#pragma unroll
    for (int aa = 0; aa < 5; ++aa) {
      double pa[4];
      load4(ph + (h * 5 + aa) * 4, pa);
#pragma unroll
      for (int Y = 0; Y < 2; ++Y)
#pragma unroll
        for (int X = 0; X < 2; ++X) {
          double y = acc[(2 * Y + X) * 5 + aa];
#pragma unroll
          for (int al = 0; al < 4; ++al)
            if (Cell::flux_on(Y, al)) y = fma(pa[al], Uv[Y][X][al], y);
          acc[(2 * Y + X) * 5 + aa] = y;
        }
    }
  }
}

// acc[aa * 4 + bb] += the terms at row 30 Y + 3 (5 h + aa) + i, column 60 + bb
template <class Cell, int Y>
__device__ inline void contract_pcol(int i, int h, int nc, const double* phi,
                                     const double* nw, const double* D, double* acc) {
  if (!Cell::p_state) return;
  for (int c = 0; c < nc; ++c) {
    const double* ph = phi + c * 40;
    const double* Dc = D + c * kSlots * kRow;
    const double* n1 = nw + c * 8;
#pragma unroll
    for (int aa = 0; aa < 5; ++aa) {
      double g = 0.0;
#pragma unroll
      for (int al = 0; al < 4; ++al)
        if (Cell::flux_on(Y, al))
          g = fma(ph[(h * 5 + aa) * 4 + al], Dc[slot(Y, i, al) * kRow + kPSlot], g);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[aa * 4 + bb] = fma(g, n1[bb], acc[aa * 4 + bb]);
    }
  }
}

// acc[bb * 5 + aa] += the terms at row 60 + bb, column 30 X + 3 (5 h + aa) + i2
template <class Cell, int X>
__device__ inline void contract_prow(int i2, int h, int nc, const double* phi,
                                     const double* nw, const double* D, double* acc) {
  if (!Cell::p_flux) return;
  for (int c = 0; c < nc; ++c) {
    const double* ph = phi + c * 40;
    const double* Dp = D + c * kSlots * kRow + kPSlot * kRow + slot(X, i2, 0);
    const double* n1 = nw + c * 8;
#pragma unroll
    for (int aa = 0; aa < 5; ++aa) {
      double g = 0.0;
#pragma unroll
      for (int be = 0; be < 4; ++be)
        if (Cell::state_on(X, be)) g = fma(Dp[be], ph[(h * 5 + aa) * 4 + be], g);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[bb * 5 + aa] = fma(n1[bb], g, acc[bb * 5 + aa]);
    }
  }
}

// acc[b * 4 + b2] += the terms at row 60 + b, column 60 + b2
template <class Cell>
__device__ inline void contract_pp(int nc, const double* nw, const double* D, double* acc) {
  if (!(Cell::p_state && Cell::p_flux)) return;
  for (int c = 0; c < nc; ++c) {
    const double dpp = D[c * kSlots * kRow + kPSlot * kRow + kPSlot];
    const double* n1 = nw + c * 8;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const double x = n1[b] * dpp;
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2) acc[b * 4 + b2] = fma(x, n1[b2], acc[b * 4 + b2]);
    }
  }
}

// the once-a-cell terms of the p-p block: the pressure stabilization's
// c G1 G1^T (linear in p), none for the solid
template <class S, int LIFT>
__device__ inline void cell_pp_tail(const FluidCell<S, LIFT>& C, const S* Jinv, S vol,
                                    double* acc) {
  if (C.p.p_stab == S(0)) return;
  S G1[4][3];
  const S c = pstab_setup(Jinv, vol, C.p, G1);
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int b2 = 0; b2 < 4; ++b2)
      acc[b * 4 + b2] += c * (G1[b][0] * G1[b2][0] + G1[b][1] * G1[b2][1]
                              + G1[b][2] * G1[b2][2]);
}

template <class S, int MAT>
__device__ inline void cell_pp_tail(const SolidCell<S, MAT>&, const S*, S, double*) {}

template <class Cell, class TOut>
__global__ void __launch_bounds__(kJacThreads, 2)
jacobian_kernel(const double* __restrict__ U, const double* __restrict__ U0,
                const int64_t* __restrict__ dofs, const double* __restrict__ Jinv,
                const double* __restrict__ detJ, const double* __restrict__ vol,
                const double* __restrict__ rowmask, const double* __restrict__ tables,
                TOut* __restrict__ A, int nq, int qc, Cell C) {
  extern __shared__ __align__(16) double sm[];
  constexpr int NS = n_states<Cell>();
  const int k = blockIdx.x, t = threadIdx.x;
  const GlobalTab<double> tb(tables, nq);
  double* s_u = sm;
  double* s_u0 = sm + 64;
  double* s_J = sm + 128;
  double* s_phi = sm + kJacHead;   // [qc][10][4]: N2, G
  double* s_nw = s_phi + qc * 40;  // [qc][8]: N1, w_q detJ
  double* s_st = s_nw + qc * 8;    // [qc][kRow]
  double* s_st0 = s_st + qc * kRow;
  double* s_old = s_st0 + qc * kRow;  // [qc][kOld]
  double* s_D = s_old + qc * kOld;    // [qc][25 fluxes][kRow: 25 states]
  if (t < 64) {
    const int64_t g = dofs[(int64_t)k * 64 + t];
    s_u[t] = U[g];
    s_u0[t] = U0[g];
  } else if (t < 73) {
    s_J[t - 64] = Jinv[(int64_t)k * 9 + t - 64];
  }
  const double dJ = detJ[k], vk = vol[k];
  const int my_slot = nth_state_slot<Cell>(t % NS);
  // this thread's item of the contraction
  const int i = t / 60, i2 = (t % 60) / 20, bh = (t % 20) / 10, b = t % 10;
  const int u = t - kBlockItems, v = t - kBlockItems - kPColItems;
  double acc[20];
#pragma unroll
  for (int e = 0; e < 20; ++e) acc[e] = 0.0;
  __syncthreads();

  for (int q0 = 0; q0 < nq; q0 += qc) {
    const int nc = min(qc, nq - q0);
    // 1. the chunk's basis
    for (int e = t; e < nc * 10; e += kJacThreads) {
      const int q = q0 + e / 10, a = e % 10, o = (q * 10 + a) * 3;
      double* ph = s_phi + e * 4;
      ph[0] = tb.N2(q * 10 + a);
#pragma unroll
      for (int l = 0; l < 3; ++l)
        ph[1 + l] = tb.dN2(o) * s_J[l] + tb.dN2(o + 1) * s_J[3 + l] + tb.dN2(o + 2) * s_J[6 + l];
    }
    for (int e = t; e < nc * 5; e += kJacThreads) {
      const int c = e / 5, j = e % 5, q = q0 + c;
      s_nw[c * 8 + j] = j < 4 ? tb.N1(q * 4 + j) : tb.wq(q) * dJ;
    }
    __syncthreads();
    // 2. the point states, a thread a slot (the previous state's pressure
    // is read by no form)
    for (int e = t; e < nc * 2 * kSlots; e += kJacThreads) {
      const int c = e / (2 * kSlots), sl = e % kSlots;
      const bool old = e % (2 * kSlots) >= kSlots;
      if (!state_slot_on<Cell>(sl) || (old && sl == kPSlot)) continue;
      const double* uu = old ? s_u0 : s_u;
      const double* ph = s_phi + c * 40;
      double x = 0.0;
      if (sl == kPSlot) {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) x += s_nw[c * 8 + bb] * uu[60 + bb];
      } else {
        const int X = sl / 12, ic = (sl % 12) / 4, be = sl % 4;
        const double* ux = uu + X * 30 + ic;
        if (be == 0) {
#pragma unroll
          for (int a = 0; a < 10; ++a) x += ph[a * 4] * ux[a * 3];
        } else {
#pragma unroll
          for (int a = 0; a < 10; ++a) x += ux[a * 3] * ph[a * 4 + be];
        }
      }
      (old ? s_st0 : s_st)[c * kRow + sl] = x;
    }
    __syncthreads();
    // the previous state's flux terms, once a point
    using Old = decltype(old_terms(C, s_st0));
    static_assert(sizeof(Old) <= kOld * sizeof(double), "kOld too small");
    if (t < nc) *reinterpret_cast<Old*>(s_old + t * kOld) = old_terms(C, s_st0 + t * kRow);
    __syncthreads();
    // 3. D_q w_q detJ, a thread a (point, state slot): forward mode over
    // the form's point flux
    if (t < nc * NS) {
      const int c = t / NS;
      Dual s[kSlots], f[kSlots];
      double s0[kSlots];
#pragma unroll
      for (int sl = 0; sl < kSlots; ++sl) {
        if (!state_slot_on<Cell>(sl)) continue;
        s[sl] = Dual(s_st[c * kRow + sl], sl == my_slot ? 1.0 : 0.0);
        if (sl != kPSlot) s0[sl] = s_st0[c * kRow + sl];
      }
      point_flux(C, s, s0, *reinterpret_cast<const Old*>(s_old + c * kOld), vk, f);
      const double wd = s_nw[c * 8 + 4];
      double* Dc = s_D + c * kSlots * kRow + my_slot;
#pragma unroll
      for (int fs = 0; fs < kSlots; ++fs)
        if (flux_slot_on<Cell>(fs)) Dc[fs * kRow] = wd * f[fs].d;
    }
    __syncthreads();
    // 4. the contraction into this thread's entries
    if (t < kBlockItems) {
      contract_blocks<Cell>(i, i2, b, bh, nc, s_phi, s_D, acc);
    } else if (u < kPColItems) {
      if (u < 6)
        contract_pcol<Cell, 0>((u % 6) / 2, u % 2, nc, s_phi, s_nw, s_D, acc);
      else
        contract_pcol<Cell, 1>((u % 6) / 2, u % 2, nc, s_phi, s_nw, s_D, acc);
    } else if (v < kPRowItems) {
      if (v < 6)
        contract_prow<Cell, 0>((v % 6) / 2, v % 2, nc, s_phi, s_nw, s_D, acc);
      else
        contract_prow<Cell, 1>((v % 6) / 2, v % 2, nc, s_phi, s_nw, s_D, acc);
    } else if (t == kPPItem) {
      contract_pp<Cell>(nc, s_nw, s_D, acc);
    }
    __syncthreads();
  }

  // stage A_e in the chunk buffers, then write it in row order
  double* s_A = sm + kJacHead;
  if (t < kBlockItems) {
#pragma unroll
    for (int Y = 0; Y < 2; ++Y)
#pragma unroll
      for (int X = 0; X < 2; ++X)
#pragma unroll
        for (int aa = 0; aa < 5; ++aa)
          s_A[(Y * 30 + (bh * 5 + aa) * 3 + i) * 64 + X * 30 + b * 3 + i2] =
              acc[(2 * Y + X) * 5 + aa];
  } else if (u < kPColItems) {
    const int Y = u / 6, ic = (u % 6) / 2, h = u % 2;
#pragma unroll
    for (int aa = 0; aa < 5; ++aa)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        s_A[(Y * 30 + (h * 5 + aa) * 3 + ic) * 64 + 60 + bb] = acc[aa * 4 + bb];
  } else if (v < kPRowItems) {
    const int X = v / 6, ic = (v % 6) / 2, h = v % 2;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int aa = 0; aa < 5; ++aa)
        s_A[(60 + bb) * 64 + X * 30 + (h * 5 + aa) * 3 + ic] = acc[bb * 5 + aa];
  } else if (t == kPPItem) {
    cell_pp_tail(C, s_J, vk, acc);
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2) s_A[(60 + bb) * 64 + 60 + b2] = acc[bb * 4 + b2];
  }
  __syncthreads();
  const double* mk = rowmask ? rowmask + (int64_t)k * 64 : nullptr;
  TOut* Ak = A + (int64_t)k * kJacEntries;
  for (int e = t; e < kJacEntries; e += kJacThreads) {
    const double m = mk ? mk[e >> 6] : 1.0;
    Ak[e] = (TOut)(s_A[e] * m);
  }
}

template <class Cell, class TOut>
int launch_jacobian_as(const double* U, const double* U0, const int64_t* dofs,
                       const double* Jinv, const double* detJ, const double* vol,
                       const double* rowmask, const double* tables, TOut* A, int K, int nq,
                       int qc, int smem, Cell C, void* stream) {
  const auto kern = jacobian_kernel<Cell, TOut>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<K, kJacThreads, smem, (cudaStream_t)stream>>>(U, U0, dofs, Jinv, detJ, vol, rowmask,
                                                      tables, A, nq, qc, C);
  return (int)cudaGetLastError();
}

// qc points a chunk and smem bytes of shared memory, as
// vt_jacobian_chunk and vt_jacobian_smem_bytes give them; refused if they
// do not fit the form
template <class Cell>
int launch_jacobian(const double* U, const double* U0, const int64_t* dofs,
                    const double* Jinv, const double* detJ, const double* vol,
                    const double* rowmask, const double* tables, void* A, int out_f32,
                    int K, int nq, int qc, int smem, Cell C, void* stream) {
  if (!tables || nq < 1 || qc < 1 || qc > jac_chunk<Cell>() || qc > nq ||
      smem < 8 * jac_smem_doubles(qc))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  if (out_f32)
    return launch_jacobian_as(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, (float*)A, K,
                              nq, qc, smem, C, stream);
  return launch_jacobian_as(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, (double*)A, K,
                            nq, qc, smem, C, stream);
}

using FluidForm = FluidCell<double, kLiftLaplace>;
using SolidForm = SolidCell<double, kSVK>;

int jac_qc(int solid, int nq) {
  const int most = solid ? jac_chunk<SolidForm>() : jac_chunk<FluidForm>();
  return nq < most ? nq : most;
}

}  // namespace

extern "C" {

int vt_element_nq_max() { return VT_NQ_MAX; }

int vt_element_nq_max_f32() { return VT_NQ_MAX_F32; }

// K3's chunk of points and its dynamic shared memory in bytes, for the
// fluid (solid 0) or the solid form at nq points
int vt_jacobian_chunk(int solid, int nq) { return jac_qc(solid, nq); }

int vt_jacobian_smem_bytes(int solid, int nq) {
  return 8 * jac_smem_doubles(jac_qc(solid, nq));
}

// Upload the quadrature tables (host pointers): wq (nq,), N1 (nq,4),
// N2 (nq,10), dN2 (nq,10,3), all float64 and C-contiguous, into the
// constant bank where they fit it (float64 up to VT_NQ_MAX points, their
// float32 roundings up to VT_NQ_MAX_F32); a set that does not fit is read
// from device memory by its kernels.
int vt_set_element_tables(const double* wq, const double* N1, const double* N2,
                          const double* dN2, int nq) {
  if (nq < 1) return (int)cudaErrorInvalidValue;
  return upload_element_tables(wq, N1, N2, dN2, nq, true);
}

// tables: NULL to read the constant bank (uploaded for this nq), else the
// device pointer of the packed tables (element_forms.cuh GlobalTab; float64,
// or float32 for f32 nonzero). f32 nonzero: the float32 instance.
// lift_mode: kLiftLaplace, kLiftElastic or kLiftNone; any other value is
// refused.
int vt_fluid_residual(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, const void* tables, double* R, int f32, int K,
                      int nq, double rho, double mu, double dt, double theta,
                      double lift_coeff, int lift_sub, int lift_mode, double p_stab,
                      void* stream) {
  if (tables)
    return vt_fluid_residual_global(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, R, f32, K,
                                    nq, rho, mu, dt, theta, lift_coeff, lift_sub, lift_mode,
                                    p_stab, stream);
  if (nq > (f32 ? VT_NQ_MAX_F32 : VT_NQ_MAX)) return (int)cudaErrorInvalidValue;
  return fluid_residual_entry<ConstTab>(U, U0, dofs, Jinv, detJ, vol, rowmask, nullptr, R,
                                        f32, K, nq, rho, mu, dt, theta, lift_coeff, lift_sub,
                                        lift_mode, p_stab, stream);
}

// material: 0 St.Venant-Kirchhoff, 1 Mooney-Rivlin (C01, C10, C11 read
// by it only); any other value is refused. (gx, gy, gz): gravity.
// tables as for the fluid.
int vt_solid_residual(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, const void* tables, double* R, int f32, int K,
                      int nq, double rho, double mu, double lam, double dt, double theta,
                      int material, double C01, double C10, double C11, double gx,
                      double gy, double gz, void* stream) {
  if (tables)
    return vt_solid_residual_global(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, R, f32, K,
                                    nq, rho, mu, lam, dt, theta, material, C01, C10, C11, gx,
                                    gy, gz, stream);
  if (nq > (f32 ? VT_NQ_MAX_F32 : VT_NQ_MAX)) return (int)cudaErrorInvalidValue;
  return solid_residual_entry<ConstTab>(U, U0, dofs, Jinv, detJ, vol, rowmask, nullptr, R,
                                        f32, K, nq, rho, mu, lam, dt, theta, material, C01,
                                        C10, C11, gx, gy, gz, stream);
}

// A (K,64,64) is float32 when out_f32 is nonzero, else float64; tables the
// packed float64 tables in device memory (any nq); qc and smem as
// vt_jacobian_chunk and vt_jacobian_smem_bytes give them.
int vt_fluid_jacobian(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, const double* tables, void* A, int out_f32,
                      int K, int nq, int qc, int smem, double rho, double mu, double dt,
                      double theta, double lift_coeff, int lift_sub, int lift_mode,
                      double p_stab, void* stream) {
#define VT_FLUID(LIFT)                                                                   \
  launch_jacobian(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, A, out_f32, K, nq, qc,  \
                  smem,                                                                  \
                  fluid_cell<double, LIFT>(rho, mu, dt, theta, lift_coeff, lift_sub,     \
                                           p_stab),                                      \
                  stream)
  if (lift_mode == kLiftLaplace) return VT_FLUID(kLiftLaplace);
  if (lift_mode == kLiftElastic) return VT_FLUID(kLiftElastic);
  if (lift_mode == kLiftNone) return VT_FLUID(kLiftNone);
#undef VT_FLUID
  return (int)cudaErrorInvalidValue;
}

int vt_solid_jacobian(const double* U, const double* U0, const int64_t* dofs,
                      const double* Jinv, const double* detJ, const double* vol,
                      const double* rowmask, const double* tables, void* A, int out_f32,
                      int K, int nq, int qc, int smem, double rho, double mu, double lam,
                      double dt, double theta, int material, double C01, double C10,
                      double C11, double gx, double gy, double gz, void* stream) {
#define VT_SOLID(MAT)                                                                    \
  launch_jacobian(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, A, out_f32, K, nq, qc,  \
                  smem,                                                                  \
                  solid_cell<double, MAT>(rho, mu, lam, dt, theta, C01, C10, C11, gx, gy, \
                                          gz),                                           \
                  stream)
  if (material == kSVK) return VT_SOLID(kSVK);
  if (material == kMooneyRivlin) return VT_SOLID(kMooneyRivlin);
#undef VT_SOLID
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
