// K13 on Hopper: the order-3 Taylor delta of the element residual,
// R(U) - R(A) as vasp_tpu's residual_delta computes it, and its
// two-argument form residual_delta2 (the previous state moves too),
// float32 series, float64 scatter; the fluid with Laplace, elastic or no
// mesh lifting (p_stab a parameter), the solid in St.Venant-Kirchhoff or
// Mooney-Rivlin (gravity a parameter), one instance per lifting mode,
// material and form.
//
// Replaces vasp_tpu/fem/assembly.py Assembler.residual_delta and
// residual_delta2 on the cell blocks: jax.experimental.jet of each
// vmapped element kernel at A (and U0old) rounded to float32 with the
// series [du, 0, 0] (and [du0, 0, 0]), the sum of its output terms masked
// by the row mask and accumulated in float64. Plain torch twin:
// vasp_tpu_torch/kernels/element.py delta_plain / delta2_plain (three
// nested torch.func.jvp). The facet blocks' part goes through K14's
// float32 residual (kernels/facet.py), their term being linear.
//
// The forms are element_forms.cuh's, on T = Jet3: every scalar that
// depends on u (and on u0 under delta2) carries its value and three
// normalised Taylor coefficients, everything else stays a float, so the
// instances do float arithmetic only (the float32 residuals' rule). A
// jet costs a few times the float32 residual's arithmetic: a product is
// ten multiply-adds where the float32 residual does one.
//
// What bounds it on an H100 and what the design does about it: the
// arithmetic of the series, on one thread per cell as K1/K2. A cell's
// state as jets (u: 64 jets, 256 floats; u0 under delta2 as many) and
// its result as jets would be far past the 255 registers of a thread.
// The seeds have c2 = c3 = 0, so u holds two live floats per entry (the
// compiler keeps the zero coefficients as constants), and the result is
// linear in the cell's contributions, so each contribution is folded into
// its entry's one float as it is added (DeltaSum, element_forms.cuh): the
// thread keeps 64 floats of result, not 256. What is left spills to the
// L1-cached local memory, as the float64 residual's state does.
#include <cstdint>
#include <type_traits>

#include "element_forms.cuh"

namespace {

constexpr int kDeltaThreads = 64;

// DELTA2 false: u0 = U0 rounded to float32 (vasp_tpu's residual_delta);
// true: u0 = the series of U0 along U0new - U0 (residual_delta2, U0 being
// its U0old).
template <class Params, bool DELTA2>
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const double* __restrict__ U, const double* __restrict__ A,
             const double* __restrict__ U0, const double* __restrict__ U0new,
             const int64_t* __restrict__ dofs, const double* __restrict__ Jinv,
             const double* __restrict__ detJ, const double* __restrict__ vol,
             const double* __restrict__ rowmask, double* __restrict__ R, int K, int nq,
             Params P) {
  using T0 = typename std::conditional<DELTA2, Jet3, float>::type;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int64_t* dk = dofs + (int64_t)k * 64;
  Jet3 u[64];
  T0 u0[64];
  DeltaSum r[64];
  float J[9];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int64_t g = dk[i];
    const double a = A[g];
    // du = U - A in float64, then rounded, as vasp_tpu's (U - A).astype
    u[i] = Jet3(float(a), float(U[g] - a), 0.f, 0.f);
    if constexpr (DELTA2) {
      const double o = U0[g];
      u0[i] = Jet3(float(o), float(U0new[g] - o), 0.f, 0.f);
    } else {
      u0[i] = float(U0[g]);
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = float(Jinv[(int64_t)k * 9 + i]);
  eval_cell(P, u, u0, J, float(detJ[k]), float(vol[k]), nq, r);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // the 0/1 row mask applied in float, exactly; only the sum is in double
    const float m = rowmask ? float(rowmask[(int64_t)k * 64 + i]) : 1.f;
    atomicAdd(R + dk[i], double(r[i].s * m));
  }
}

template <class Params>
int launch_delta(const double* U, const double* A, const double* U0, const double* U0new,
                 const int64_t* dofs, const double* Jinv, const double* detJ,
                 const double* vol, const double* rowmask, double* R, int delta2, int K,
                 int nq, Params P, void* stream) {
  if (K > 0) {
    const int blocks = (K + kDeltaThreads - 1) / kDeltaThreads;
    if (delta2)
      delta_kernel<Params, true><<<blocks, kDeltaThreads, 0, (cudaStream_t)stream>>>(
          U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, R, K, nq, P);
    else
      delta_kernel<Params, false><<<blocks, kDeltaThreads, 0, (cudaStream_t)stream>>>(
          U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, R, K, nq, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vt_delta_nq_max() { return VT_NQ_MAX_F32; }

// Upload the float32 roundings of the quadrature tables (host pointers, as
// vt_set_element_tables takes them) into this source's constant memory.
int vt_set_delta_tables(const double* wq, const double* N1, const double* N2,
                        const double* dN2, int nq) {
  if (nq < 1 || nq > VT_NQ_MAX_F32) return (int)cudaErrorInvalidValue;
  return upload_element_tables(wq, N1, N2, dN2, nq, false);
}

// R += the masked delta of the fluid cells: residual_delta(U, A, U0) for
// delta2 = 0; residual_delta2(U, A, U0new, U0) for delta2 nonzero (U0new
// is read only then). lift_mode: kLiftLaplace, kLiftElastic or kLiftNone;
// any other value is refused.
int vt_fluid_delta(const double* U, const double* A, const double* U0,
                   const double* U0new, const int64_t* dofs, const double* Jinv,
                   const double* detJ, const double* vol, const double* rowmask,
                   double* R, int delta2, int K, int nq, double rho, double mu,
                   double dt, double theta, double lift_coeff, int lift_sub,
                   int lift_mode, double p_stab, void* stream) {
#define VT_FLUID(LIFT)                                                          \
  launch_delta(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, R, delta2, K, nq, \
               fluid_cell<float, LIFT>(rho, mu, dt, theta, lift_coeff, lift_sub,  \
                                       p_stab),                                   \
               stream)
  if (lift_mode == kLiftLaplace) return VT_FLUID(kLiftLaplace);
  if (lift_mode == kLiftElastic) return VT_FLUID(kLiftElastic);
  if (lift_mode == kLiftNone) return VT_FLUID(kLiftNone);
#undef VT_FLUID
  return (int)cudaErrorInvalidValue;
}

// The same on the solid cells; material: 0 St.Venant-Kirchhoff, 1
// Mooney-Rivlin (C01, C10, C11 read by it only); any other value is
// refused. (gx, gy, gz): gravity.
int vt_solid_delta(const double* U, const double* A, const double* U0,
                   const double* U0new, const int64_t* dofs, const double* Jinv,
                   const double* detJ, const double* vol, const double* rowmask,
                   double* R, int delta2, int K, int nq, double rho, double mu,
                   double lam, double dt, double theta, int material, double C01,
                   double C10, double C11, double gx, double gy, double gz,
                   void* stream) {
#define VT_SOLID(MAT)                                                            \
  launch_delta(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, R, delta2, K, nq, \
               solid_cell<float, MAT>(rho, mu, lam, dt, theta, C01, C10, C11, gx,  \
                                      gy, gz),                                     \
               stream)
  if (material == kSVK) return VT_SOLID(kSVK);
  if (material == kMooneyRivlin) return VT_SOLID(kMooneyRivlin);
#undef VT_SOLID
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
