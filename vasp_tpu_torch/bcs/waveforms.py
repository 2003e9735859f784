"""Inflow / pressure waveform expressions.

Reimplements (from the published formulas and documented behavior, not the
code) the boundary-condition expressions the reference uses:

- parabolic ramped inflow VelInPara
  (reference: src/vasp/simulations/cylinder.py:89-131),
- Womersley velocity profile from complex Fourier flow-rate coefficients
  (formula documented at reference: docs/aneurysm.md:48-70; VaSP consumes
  vampy.simulation.Womersley — rebuilt here from the Bessel-series formula),
- pulsatile interface pressure from Fourier coefficients with cosine ramp
  (reference: src/vasp/simulations/simulation_common.py:351-401),
- patient CSV waveform interpolation (reference: src/vasp/simulations/avf.py:237-253).

All expressions are host-side: they produce Dirichlet values at boundary dof
coordinates (or a scalar load factor) per timestep; the device never sees
Bessel functions.
"""
import numpy as np
from scipy.special import jv


class CosineRamp:
    """ramp(t): 0 before t0, smooth half-cosine rise on [t0, t1], 1 after."""

    def __init__(self, t_start, t_end):
        self.t0 = float(t_start)
        self.t1 = float(t_end)

    def __call__(self, t):
        if t < self.t0:
            return 0.0
        if t < self.t1:
            return -0.5 * np.cos(np.pi * (t - self.t0) / (self.t1 - self.t0)) + 0.5
        return 1.0


class ParabolicInflow:
    """Ramped parabolic (Poiseuille) inlet profile along -normal
    (reference VelInPara, src/vasp/simulations/cylinder.py:89-131).

    The radius is derived from the inlet area (r = sqrt(A/pi)) and the
    barycenter from facet integrals, exactly as the reference does."""

    def __init__(self, v_max_final, t_ramp, normal, center, area,
                 t_ramp_start=0.0):
        self.v_max_final = float(v_max_final)
        self.ramp = CosineRamp(t_ramp_start, t_ramp_start + t_ramp) \
            if t_ramp > 0 else (lambda t: 1.0)
        self.n = np.asarray(normal, float)
        self.c = np.asarray(center, float)
        self.r = np.sqrt(area / np.pi)
        self.v = 0.0

    def update(self, t):
        self.v = self.ramp(t) * self.v_max_final
        return self.v

    def __call__(self, coords):
        """coords (K,3) -> velocity values (K,3)."""
        r2 = np.sum((coords - self.c) ** 2, axis=1)
        fact = 1.0 - r2 / self.r ** 2
        return -self.n[None, :] * (self.v * fact)[:, None]


class FourierFlowWaveform:
    """Q(t) = Re{ sum_n Cn e^{i n w t} } with Cn = (An - i Bn) * Q_mean."""

    def __init__(self, An, Bn, period, Q_mean=1.0):
        self.Cn = (np.asarray(An) - 1j * np.asarray(Bn)) * Q_mean
        self.omega = 2.0 * np.pi / period

    def __call__(self, t):
        n = np.arange(len(self.Cn))
        return float(np.real(np.sum(self.Cn * np.exp(1j * n * self.omega * t))))


class WomersleyInflow:
    """Womersley velocity profile (reference formula, docs/aneurysm.md:48-61):

      u(r,t) = 2 C0/(pi R^2) [1-(r/R)^2]
             + sum_n Cn/(pi R^2) [ (J0(a_n i^1.5) - J0(a_n (r/R) i^1.5))
                                 / (J0(a_n i^1.5) - 2/(a_n i^1.5) J1(a_n i^1.5)) ] e^{i n w t}

    with a_n = R sqrt(n w / nu), Cn = (An - i Bn) Q_mean, directed along
    -normal (into the domain)."""

    def __init__(self, An, Bn, period, Q_mean, nu, normal, center, radius,
                 t_ramp_start=None, t_ramp_end=None):
        self.Cn = (np.asarray(An, float) - 1j * np.asarray(Bn, float)) * Q_mean
        self.omega = 2.0 * np.pi / float(period)
        self.nu = float(nu)
        self.n = np.asarray(normal, float)
        self.c = np.asarray(center, float)
        self.R = float(radius)
        self.t = 0.0
        if t_ramp_start is not None:
            self.ramp = CosineRamp(t_ramp_start, t_ramp_end)
        else:
            self.ramp = lambda t: 1.0
        # precompute modal constants
        ns = np.arange(1, len(self.Cn))
        alpha = self.R * np.sqrt(ns * self.omega / self.nu)
        z = alpha * 1j ** 1.5
        self._z = z
        self._j0z = jv(0, z)
        self._denom = self._j0z - 2.0 / z * jv(1, z)

    def set_t(self, t):
        self.t = float(t)

    def update(self, t):
        self.set_t(t)

    def __call__(self, coords):
        """coords (K,3) -> velocity (K,3), at the current time."""
        r = np.linalg.norm(coords - self.c[None, :], axis=1)
        rho = np.clip(r / self.R, 0.0, 1.0)
        area = np.pi * self.R ** 2
        u = np.real(self.Cn[0]) * 2.0 / area * (1.0 - rho ** 2)
        ns = np.arange(1, len(self.Cn))
        if len(ns):
            phase = np.exp(1j * ns * self.omega * self.t)  # (N,)
            j0zr = jv(0, np.outer(rho, self._z))  # (K,N)
            profile = (self._j0z[None, :] - j0zr) / self._denom[None, :]
            u = u + np.real(
                (self.Cn[1:] * phase)[None, :] / area * profile
            ).sum(axis=1)
        u = u * self.ramp(self.t)
        return -self.n[None, :] * u[:, None]


class InterfacePressure:
    """Pulsatile interface pressure P(t) = ramp(t) * |sum (An - iBn) e^{inwt}|
    * P_mean with cosine ramp on [t_ramp_start, t_ramp_end]
    (reference: src/vasp/simulations/simulation_common.py:351-401). Prints the
    reference's exact log lines (consumed by vasp-log-plotter)."""

    def __init__(self, t, t_ramp_start, t_ramp_end, An, Bn, period, P_mean,
                 verbose=True):
        self.An = np.asarray(An, float)
        self.Bn = np.asarray(Bn, float)
        self.omega = 2.0 * np.pi / period
        self.P_mean = P_mean
        self.ramp = CosineRamp(t_ramp_start, t_ramp_end)
        self.P = 0.0
        self.verbose = verbose
        self.t = t

    def update(self, t):
        self.t = t
        ramp_factor = self.ramp(t)
        if self.verbose:
            print("ramp_factor = {} m^3/s".format(ramp_factor))
        n = np.arange(len(self.An))
        Pn = abs(np.sum((self.An - 1j * self.Bn) * np.exp(1j * n * self.omega * t)))
        self.P = ramp_factor * Pn * self.P_mean
        if self.verbose:
            print(
                "Instantaneous normal stress prescribed at the FSI interface "
                "{} Pa".format(self.P)
            )
        return self.P


class PatientWaveform:
    """Periodic interpolation of a measured waveform time series (the AVF
    patient CSV path, reference: src/vasp/simulations/avf.py:237-253)."""

    def __init__(self, times, values, period=None):
        self.times = np.asarray(times, float)
        self.values = np.asarray(values, float)
        self.period = float(period) if period else float(self.times[-1])

    def __call__(self, t):
        tm = np.mod(t, self.period)
        return float(np.interp(tm, self.times, self.values))
