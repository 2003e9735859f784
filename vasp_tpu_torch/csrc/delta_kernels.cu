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
#include "delta_residual.cuh"

extern "C" {
int vt_fluid_delta_global(const double* U, const double* A, const double* U0,
                          const double* U0new, const int64_t* dofs, const double* Jinv,
                          const double* detJ, const double* vol, const double* rowmask,
                          const void* tables, double* R, int delta2, int K, int nq,
                          double rho, double mu, double dt, double theta, double lift_coeff,
                          int lift_sub, int lift_mode, double p_stab, void* stream);
int vt_solid_delta_global(const double* U, const double* A, const double* U0,
                          const double* U0new, const int64_t* dofs, const double* Jinv,
                          const double* detJ, const double* vol, const double* rowmask,
                          const void* tables, double* R, int delta2, int K, int nq,
                          double rho, double mu, double lam, double dt, double theta,
                          int material, double C01, double C10, double C11, double gx,
                          double gy, double gz, void* stream);

int vt_delta_nq_max() { return VT_NQ_MAX_F32; }

// Upload the float32 roundings of the quadrature tables (host pointers, as
// vt_set_element_tables takes them) into this source's constant memory,
// where they fit it (nq <= VT_NQ_MAX_F32).
int vt_set_delta_tables(const double* wq, const double* N1, const double* N2,
                        const double* dN2, int nq) {
  if (nq < 1) return (int)cudaErrorInvalidValue;
  return upload_element_tables(wq, N1, N2, dN2, nq, false);
}

// R += the masked delta of the fluid cells: residual_delta(U, A, U0) for
// delta2 = 0; residual_delta2(U, A, U0new, U0) for delta2 nonzero (U0new
// is read only then). tables: NULL to read the constant bank (uploaded for
// this nq), else the device pointer of the packed float32 tables
// (element_forms.cuh GlobalTab). lift_mode: kLiftLaplace, kLiftElastic or
// kLiftNone; any other value is refused.
int vt_fluid_delta(const double* U, const double* A, const double* U0,
                   const double* U0new, const int64_t* dofs, const double* Jinv,
                   const double* detJ, const double* vol, const double* rowmask,
                   const void* tables, double* R, int delta2, int K, int nq, double rho,
                   double mu, double dt, double theta, double lift_coeff, int lift_sub,
                   int lift_mode, double p_stab, void* stream) {
  if (tables)
    return vt_fluid_delta_global(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, tables, R,
                                 delta2, K, nq, rho, mu, dt, theta, lift_coeff, lift_sub,
                                 lift_mode, p_stab, stream);
  if (nq > VT_NQ_MAX_F32) return (int)cudaErrorInvalidValue;
  return fluid_delta_entry<ConstTab>(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask,
                                     nullptr, R, delta2, K, nq, rho, mu, dt, theta,
                                     lift_coeff, lift_sub, lift_mode, p_stab, stream);
}

// The same on the solid cells; material: 0 St.Venant-Kirchhoff, 1
// Mooney-Rivlin (C01, C10, C11 read by it only); any other value is
// refused. (gx, gy, gz): gravity.
int vt_solid_delta(const double* U, const double* A, const double* U0,
                   const double* U0new, const int64_t* dofs, const double* Jinv,
                   const double* detJ, const double* vol, const double* rowmask,
                   const void* tables, double* R, int delta2, int K, int nq, double rho,
                   double mu, double lam, double dt, double theta, int material, double C01,
                   double C10, double C11, double gx, double gy, double gz, void* stream) {
  if (tables)
    return vt_solid_delta_global(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask, tables, R,
                                 delta2, K, nq, rho, mu, lam, dt, theta, material, C01, C10,
                                 C11, gx, gy, gz, stream);
  if (nq > VT_NQ_MAX_F32) return (int)cudaErrorInvalidValue;
  return solid_delta_entry<ConstTab>(U, A, U0, U0new, dofs, Jinv, detJ, vol, rowmask,
                                     nullptr, R, delta2, K, nq, rho, mu, lam, dt, theta,
                                     material, C01, C10, C11, gx, gy, gz, stream);
}

}  // extern "C"
