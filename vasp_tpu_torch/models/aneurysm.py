"""Cerebral aneurysm FSI problem.

Counterpart of vasp_tpu.models.aneurysm. Behavioral parity target:
reference src/vasp/simulations/aneurysm.py — Womersley inflow + pulsatile
interface pressure, Robin BC on the solid outer wall (robin_bc=True,
k_s=1e5, c_s=10, ds_s_id=[33], reference L73-76), tight Newton tolerances
(atol=1e-10/rtol=1e-9, L48-49), and accumulation of mean (d, v, p) fields
after save_solution_after_tstep steps written out in finished() (reference
L153-222).

post_solve hands the state's tensors to the flow properties and the
minimum Jacobian, which run on the state's device, and one host copy of
the state per step to the probes and the mean fields (host numpy)."""
from pathlib import Path

import numpy as np

from vasp_tpu_torch.bcs.waveforms import InterfacePressure, WomersleyInflow
from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.fem.measures import BoundaryMeasure, PointProbes
from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
from vasp_tpu_torch.mesh.io import load_probe_points, read_vasp_mesh
from vasp_tpu_torch.models.waveform_data import load_fc
from vasp_tpu_torch.run.metrics import (
    calculate_and_print_flow_properties,
    compute_minimum_jacobian,
    print_probe_points,
)


def set_problem_parameters(default_variables, **namespace):
    # identical physical setup to reference aneurysm.py:29-88
    E_s_val = 1e6
    nu_s_val = 0.45
    mu_s_val = E_s_val / (2 * (1 + nu_s_val))
    lambda_s_val = nu_s_val * 2.0 * mu_s_val / (1.0 - 2.0 * nu_s_val)
    default_variables.update(
        dict(
            T=0.002,
            dt=0.001,
            theta=0.501,
            save_step=1,
            save_solution_after_tstep=951,
            checkpoint_step=50,
            linear_solver="mumps",
            atol=1e-10,
            rtol=1e-9,
            recompute=20,
            recompute_tstep=20,
            inlet_id=2,
            inlet_outlet_s_id=11,
            fsi_id=22,
            outer_id=33,
            rigid_id=11,
            Q_mean=1.25e-06,
            P_mean=11200,
            T_Cycle=0.951,
            rho_f=1.000e3,
            mu_f=3.5e-3,
            dx_f_id=1,
            extrapolation="laplace",
            extrapolation_sub_type="constant",
            rho_s=1.0e3,
            mu_s=mu_s_val,
            nu_s=nu_s_val,
            lambda_s=lambda_s_val,
            dx_s_id=2,
            k_s=[1e5],
            c_s=[10],
            ds_s_id=[33],
            robin_bc=True,
            folder="aneurysm_results",
            mesh_path="mesh/file_aneurysm.h5",
            FC_file="FC_MCA_10",
            P_FC_File="FC_Pressure",
            save_deg=2,
            scale_probe=True,
        )
    )
    return default_variables


def get_mesh_domain_and_boundaries(mesh_path, **namespace):
    if mesh_path and Path(mesh_path).exists():
        return read_vasp_mesh(mesh_path)
    # self-contained default: tube with a saccular bulge (aneurysm-like)
    params = dict(n_theta=12, n_r_fluid=2, n_r_solid=1, n_z=14)
    params.update(namespace.get("generated_mesh_params") or {})
    length, r = 0.01, 0.0015

    def scale(z):
        z0, w = length / 2, length / 3
        if abs(z - z0) < w / 2:
            return 1.0 + 0.8 * 0.5 * (1 + np.cos(2 * np.pi * (z - z0) / w))
        return 1.0

    return fsi_tube_mesh(
        r_inner=r, r_outer=1.25 * r, length=length,
        radius_profile=scale, **params,
    )


def initiate(mesh_path, scale_probe, mesh, space, **namespace):
    if mesh_path and Path(mesh_path).exists():
        probe_points = load_probe_points(mesh_path)
        if scale_probe:
            probe_points = probe_points * 0.001
    else:
        L = mesh.coords[:, 2].max()
        probe_points = np.array([[0.0, 0.0, L / 2]])
    n2, n1 = space.n_p2, space.n_p1
    return dict(
        probes=PointProbes(space, probe_points),
        d_mean=np.zeros((n2, 3)),
        u_mean=np.zeros((n2, 3)),
        p_mean=np.zeros(n1),
        mean_count=0,
    )


def create_bcs(t, space, system, mu_f, rho_f, fsi_id, inlet_id,
               inlet_outlet_s_id, FC_file, Q_mean, P_FC_File, P_mean, T_Cycle,
               **namespace):
    An, Bn = load_fc(FC_file)
    dsi = BoundaryMeasure(space, inlet_id)
    radius = np.sqrt(dsi.area / np.pi)
    inlet = WomersleyInflow(
        An=An, Bn=Bn, period=T_Cycle, Q_mean=Q_mean, nu=mu_f / rho_f,
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
    bcs = [
        DirichletBC(space.field_dofs("v", inlet_dofs), inlet_values),
        DirichletBC(space.field_dofs("v", s_dofs), 0.0),
        DirichletBC(space.field_dofs("d", inlet_dofs), 0.0),
        DirichletBC(space.field_dofs("d", s_dofs), 0.0),
    ]

    An_P, Bn_P = load_fc(P_FC_File)
    interface_pressure = InterfacePressure(
        t=0.0, t_ramp_start=0.0, t_ramp_end=0.2, An=An_P, Bn=Bn_P,
        period=T_Cycle, P_mean=P_mean,
    )
    b_ifc = system.interface_pressure_load(fsi_id)

    def load_fn(tt):
        return interface_pressure.P * b_ifc

    return dict(
        bcs=bcs, inlet=inlet, interface_pressure=interface_pressure,
        load_fn=load_fn, dsi=dsi, inlet_area=dsi.area,
    )


def pre_solve(t, inlet, interface_pressure, **namespace):
    inlet.set_t(t)
    interface_pressure.update(t)
    return dict(inlet=inlet, interface_pressure=interface_pressure)


def post_solve(probes, dvp_, dsi, dt, space, inlet_area, mu_f, rho_f, t,
               save_solution_after_tstep, d_mean, u_mean, p_mean, mean_count,
               **namespace):
    U = dvp_["n"]
    d, v, _ = space.split(U)
    d_h, v_h, p_h = space.split(U.cpu().numpy())
    print_probe_points(probes, v_h, p_h)
    calculate_and_print_flow_properties(
        dt, space, v, inlet_area, mu_f, rho_f, dsi
    )
    compute_minimum_jacobian(space, d)

    if t >= save_solution_after_tstep * dt:
        # accumulate the mean fields (reference aneurysm.py:186-203)
        d_mean += d_h
        u_mean += v_h
        p_mean += p_h
        return dict(d_mean=d_mean, u_mean=u_mean, p_mean=p_mean,
                    mean_count=mean_count + 1)
    return None


def finished(d_mean, u_mean, p_mean, mean_count, folder, space, mesh,
             **namespace):
    """Write the cycle-averaged fields as write_checkpoint-layout XDMF+h5
    (reference aneurysm.py:206-222 writes d_mean/u_mean/p_mean.xdmf via
    XDMFFile.write_checkpoint) so reference-layout tooling
    (output_file_lists) parses them."""
    from vasp_tpu_torch.run.output import CheckpointSeriesWriter

    if mean_count == 0:
        return
    viz = Path(folder) / "Visualization"
    viz.mkdir(parents=True, exist_ok=True)
    # CG layouts: P2 vector fields use per-cell P2 dof tables x3 comps,
    # P1 scalar uses the tet vertices
    cd_p2 = np.asarray(space.cell_dofs_p2)
    cell_dofs_vec = (3 * cd_p2[:, :, None]
                     + np.arange(3)[None, None, :]).reshape(len(cd_p2), -1)
    for arr, name in ((d_mean, "d_mean"), (u_mean, "u_mean")):
        w = CheckpointSeriesWriter(
            viz, name, mesh.coords, mesh.cells, ncomp=3,
            cell_dofs=cell_dofs_vec, family="CG", degree=2)
        w.write(np.asarray(arr) / mean_count, 0.0)
    wp = CheckpointSeriesWriter(
        viz, "p_mean", mesh.coords, mesh.cells, ncomp=1,
        cell_dofs=mesh.cells, family="CG", degree=1)
    wp.write(np.asarray(p_mean) / mean_count, 0.0)
