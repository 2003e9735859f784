"""Offset stenosis FSI problem.

Counterpart of vasp_tpu.models.offset_stenosis. Behavioral parity target:
reference problem file src/vasp/simulations/offset_stenosis.py —
Womersley inflow from FC_MCA_10 Fourier coefficients scaled by Q_mean,
pulsatile interface pressure from FC_Pressure scaled by P_mean, FSI
restricted to a sphere (facets outside re-marked rigid, reference
L98-112), two fluid viscosity zones split at x > 0.024 (reference
L129-138), probe + flow-property + min-Jacobian observables each step
(reference L216-224).

post_solve hands the state's tensors to the flow properties and the
minimum Jacobian, which run on the state's device, and one host copy of
the state per step to the probes."""
from pathlib import Path

import numpy as np

from vasp_tpu_torch.bcs.waveforms import InterfacePressure, WomersleyInflow
from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.fem.measures import BoundaryMeasure, PointProbes
from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
from vasp_tpu_torch.mesh.io import (
    load_probe_points,
    load_solid_probe_points,
    read_vasp_mesh,
)
from vasp_tpu_torch.mesh.markers import remark_cells, restrict_fsi_to_sphere
from vasp_tpu_torch.models.waveform_data import load_fc
from vasp_tpu_torch.run.metrics import (
    calculate_and_print_flow_properties,
    compute_minimum_jacobian,
    print_probe_points,
    print_solid_probe_points,
)


def set_problem_parameters(default_variables, **namespace):
    # identical physical setup to reference offset_stenosis.py:27-82
    E_s_val = 1e6
    nu_s_val = 0.45
    mu_s_val = E_s_val / (2 * (1 + nu_s_val))
    lambda_s_val = nu_s_val * 2.0 * mu_s_val / (1.0 - 2.0 * nu_s_val)

    default_variables.update(
        dict(
            T=0.951,
            dt=0.001,
            theta=0.501,
            save_step=1,
            checkpoint_step=50,
            linear_solver="mumps",
            atol=1e-6,
            rtol=1e-6,
            recompute=20,
            recompute_tstep=20,
            inlet_id=3,
            inlet_outlet_s_id=11,
            fsi_id=22,
            rigid_id=11,
            outer_id=33,
            Q_mean=2.5e-06,
            P_mean=11200,
            T_Cycle=0.951,
            rho_f=[1.000e3, 1.000e3],
            mu_f=[1.5e-3, 1.0e-2],
            dx_f_id=[1, 1001],
            extrapolation="laplace",
            extrapolation_sub_type="constant",
            rho_s=1.0e3,
            mu_s=mu_s_val,
            nu_s=nu_s_val,
            lambda_s=lambda_s_val,
            dx_s_id=2,
            fsi_region=[0.008, 0, 0, 0.008],
            folder="offset_stenosis_results",
            mesh_path="mesh/file_stenosis.h5",
            FC_file="FC_MCA_10",
            P_FC_File="FC_Pressure",
            save_deg=2,
        )
    )
    return default_variables


def _default_stenosis_mesh(n_theta=12, n_r_fluid=2, n_r_solid=1, n_z=20):
    """Self-contained offset-stenosis geometry: 50%-narrowed, laterally
    offset throat at mid-length (the reference ships a pre-built mesh)."""
    length = 0.04
    r = 0.002

    def scale(z):
        s = 1.0
        z0, w = 0.012, 0.008
        if abs(z - z0) < w / 2:
            s = 1.0 - 0.25 * (1 + np.cos(2 * np.pi * (z - z0) / w))
        return s

    def offset(z):
        z0, w = 0.012, 0.008
        if abs(z - z0) < w / 2:
            return (0.25 * r * (1 + np.cos(2 * np.pi * (z - z0) / w)), 0.0)
        return (0.0, 0.0)

    return fsi_tube_mesh(
        r_inner=r, r_outer=1.3 * r, length=length,
        n_theta=n_theta, n_r_fluid=n_r_fluid, n_r_solid=n_r_solid, n_z=n_z,
        radius_profile=scale, center_offset=offset,
    )


def get_mesh_domain_and_boundaries(mesh_path, fsi_region, dx_f_id, fsi_id,
                                   rigid_id, outer_id, **namespace):
    if mesh_path and Path(mesh_path).exists():
        mesh = read_vasp_mesh(mesh_path)
        x_min = 0.024
    else:
        mesh = _default_stenosis_mesh(
            **(namespace.get("generated_mesh_params") or {})
        )
        x_min = 1e9  # generated mesh has no high-viscosity zone by default

    # Only consider FSI within the given sphere; facets outside -> rigid
    mesh = restrict_fsi_to_sphere(mesh, fsi_id, outer_id, rigid_id, fsi_region)
    # Two-viscosity fluid zones split at x > x_min
    mesh = remark_cells(mesh, dx_f_id[0], dx_f_id[1],
                        lambda x, y, z: x > x_min)
    return mesh


def initiate(mesh_path, mesh, space, **namespace):
    if mesh_path and Path(mesh_path).exists():
        probe_points = load_probe_points(mesh_path)
        solid_probe_points = load_solid_probe_points(mesh_path)
    else:
        # default probes: centerline and wall points
        L = mesh.coords[:, 2].max()
        probe_points = np.array([[0.0, 0.0, L / 2], [0.0, 0.0, 3 * L / 4]])
        solid_probe_points = mesh.coords[
            mesh.facet_vertices(22)[:2]
        ]
    return dict(
        probes=PointProbes(space, probe_points),
        solid_probes=PointProbes(space, solid_probe_points),
    )


def create_bcs(t, space, system, mesh, mu_f, fsi_id, inlet_id,
               inlet_outlet_s_id, rigid_id, FC_file, Q_mean, P_FC_File,
               P_mean, T_Cycle, **namespace):
    # Womersley inflow (reference: offset_stenosis.py:151-176; formula from
    # docs/aneurysm.md:48-61), ramped over the first 250 ms (pre_solve L199-208)
    An, Bn = load_fc(FC_file)
    dsi = BoundaryMeasure(space, inlet_id)
    radius = np.sqrt(dsi.area / np.pi)
    nu = mu_f[0] / namespace["rho_f"][0]
    inlet = WomersleyInflow(
        An=An, Bn=Bn, period=T_Cycle, Q_mean=Q_mean, nu=nu,
        normal=dsi.mean_normal, center=dsi.centroid, radius=radius,
        t_ramp_start=0.0, t_ramp_end=0.25,
    )
    inlet.set_t(t)

    inlet_dofs = space.p2_dofs_on_facets(inlet_id)
    inlet_coords = space.p2_coords[inlet_dofs]

    def inlet_values(tt):
        inlet.set_t(tt)
        return inlet(inlet_coords).reshape(-1)

    s_dofs = space.p2_dofs_on_facets(inlet_outlet_s_id)
    rigid_dofs = space.p2_dofs_on_facets(rigid_id)
    bcs = [
        DirichletBC(space.field_dofs("v", inlet_dofs), inlet_values),
        DirichletBC(space.field_dofs("v", s_dofs), 0.0),
        DirichletBC(space.field_dofs("d", inlet_dofs), 0.0),
        DirichletBC(space.field_dofs("d", s_dofs), 0.0),
        DirichletBC(space.field_dofs("d", rigid_dofs), 0.0),
    ]

    # pulsatile interface pressure (reference: offset_stenosis.py:178-190)
    An_P, Bn_P = load_fc(P_FC_File)
    interface_pressure = InterfacePressure(
        t=0.0, t_ramp_start=0.0, t_ramp_end=0.2, An=An_P, Bn=Bn_P,
        period=T_Cycle, P_mean=P_mean,
    )
    b_ifc = system.interface_pressure_load(fsi_id)

    def load_fn(tt):
        return interface_pressure.P * b_ifc

    return dict(
        bcs=bcs,
        inlet=inlet,
        interface_pressure=interface_pressure,
        load_fn=load_fn,
        dsi=dsi,
        inlet_area=dsi.area,
    )


def pre_solve(t, inlet, interface_pressure, **namespace):
    inlet.set_t(t)
    interface_pressure.update(t)
    return dict(inlet=inlet, interface_pressure=interface_pressure)


def post_solve(probes, solid_probes, dvp_, dt, space, inlet_area, dsi, mu_f,
               rho_f, **namespace):
    U = dvp_["n"]
    d, v, _ = space.split(U)
    d_h, v_h, p_h = space.split(U.cpu().numpy())
    print_probe_points(probes, v_h, p_h)
    print_solid_probe_points(solid_probes, d_h)
    calculate_and_print_flow_properties(
        dt, space, v, inlet_area, mu_f[0], rho_f[0], dsi
    )
    compute_minimum_jacobian(space, d)
