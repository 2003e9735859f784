"""Runtime observables with the reference solver's exact stdout contract.

Every line format here is parsed by vasp-log-plotter's regexes
(reference: src/vasp/postprocessing/log_plotter.py:72-84) and by the
reference's own regression tests (reference: tests/test_simulations.py:28-49),
so the formats are an API. In addition to stdout, a structured JSONL stream
of per-step metrics is written (SURVEY.md §5.1)."""
import json
from pathlib import Path

import numpy as np

from vasp_tpu_torch.fem.measures import (
    BoundaryMeasure,
    PointProbes,
    dg0_project_jacobian,
    dg0_project_speed,
)


def print_probe_points(probes: PointProbes, v, p):
    """reference: simulation_common.py:157-182 format. v (n2,3), p (n1,):
    host numpy arrays."""
    uvals = probes.eval_p2(v)
    pvals = probes.eval_p1(p)
    for i in range(len(probes.points)):
        u = uvals[i]
        print(
            f"Probe Point {i}: Velocity: ({u[0]}, {u[1]}, {u[2]}) | "
            f"Pressure: {pvals[i]}"
        )


def print_solid_probe_points(probes: PointProbes, d):
    """reference: simulation_common.py:185-199 format. d (n2,3): a host
    numpy array."""
    dvals = probes.eval_p2(d)
    for i in range(len(probes.points)):
        x = dvals[i]
        print(f"Probe Point {i}: Displacement: ({x[0]}, {x[1]}, {x[2]})")


def calculate_and_print_flow_properties(dt, space, v, inlet_area, mu_f, rho_f,
                                        inlet: BoundaryMeasure, v_deg=2,
                                        hmin=None, return_dict=False):
    """Flow rate / velocity / CFL / Re block
    (reference: simulation_common.py:253-317; CFL scaled by the velocity
    element degree, reference L308-310). v: (n2,3) tensor; the DG0 speed
    projection and the inlet flux run on its device."""
    speeds = dg0_project_speed(space, v).cpu().numpy()
    flow_rate_inlet = abs(float(inlet.integrate_p2_dot_n(v)))
    v_mean = float(speeds.mean())
    v_min = float(speeds.min())
    v_max = float(speeds.max())
    h_min = hmin if hmin is not None else space.mesh.hmin
    diam_inlet = np.sqrt(4 * inlet_area / np.pi)
    Re = lambda u: rho_f * u * diam_inlet / mu_f
    CFL = lambda u: u * dt / h_min * v_deg
    print("Flow Properties:")
    print(f"  Flow Rate at Inlet: {flow_rate_inlet}")
    print(f"  Velocity (mean, min, max): {v_mean}, {v_min}, {v_max}")
    print(f"  CFL (mean, min, max): {CFL(v_mean)}, {CFL(v_min)}, {CFL(v_max)}")
    print(
        f"  Reynolds Numbers (mean, min, max): {Re(v_mean)}, {Re(v_min)}, "
        f"{Re(v_max)}"
    )
    if return_dict:
        return dict(
            flow_rate=flow_rate_inlet,
            velocity=(v_mean, v_min, v_max),
            cfl=(CFL(v_mean), CFL(v_min), CFL(v_max)),
            reynolds=(Re(v_mean), Re(v_min), Re(v_max)),
        )


def compute_minimum_jacobian(space, d, verbose=True):
    """reference: simulation_common.py:320-348 (DG0 projection of J(d)).
    d: (n2,3) tensor; the projection runs on its device and the host reads
    back the minimum alone."""
    jmin = float(dg0_project_jacobian(space, d).min())
    if verbose:
        print(f"Minimum Jacobian: {jmin}")
        if jmin <= 0:
            print("Warning: Negative Jacobian detected.")
    return jmin


class JsonlMetrics:
    """Structured per-step metrics stream (<folder>/metrics.jsonl)."""

    def __init__(self, folder):
        self.path = Path(folder) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, **kv):
        self._f.write(json.dumps(kv) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
