// K1/K2 with the quadrature tables in device memory: the instances that
// serve rules of more points than the constant bank holds (VT_NQ_MAX in
// float64, VT_NQ_MAX_F32 in float32), reached through element_kernels.cu's
// entry points. A source of their own, so that nvcc builds them beside
// the constant-bank instances and not after them.
#include "element_residual.cuh"

extern "C" {

int vt_fluid_residual_global(const double* U, const double* U0, const int64_t* dofs,
                             const double* Jinv, const double* detJ, const double* vol,
                             const double* rowmask, const void* tables, double* R,
                             int f32, int K, int nq, double rho, double mu, double dt,
                             double theta, double lift_coeff, int lift_sub,
                             int lift_mode, double p_stab, void* stream) {
  return fluid_residual_entry<GlobalTab>(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, R,
                                         f32, K, nq, rho, mu, dt, theta, lift_coeff,
                                         lift_sub, lift_mode, p_stab, stream);
}

int vt_solid_residual_global(const double* U, const double* U0, const int64_t* dofs,
                             const double* Jinv, const double* detJ, const double* vol,
                             const double* rowmask, const void* tables, double* R,
                             int f32, int K, int nq, double rho, double mu, double lam,
                             double dt, double theta, int material, double C01,
                             double C10, double C11, double gx, double gy, double gz,
                             void* stream) {
  return solid_residual_entry<GlobalTab>(U, U0, dofs, Jinv, detJ, vol, rowmask, tables, R,
                                         f32, K, nq, rho, mu, lam, dt, theta, material,
                                         C01, C10, C11, gx, gy, gz, stream);
}

}  // extern "C"
