"""Predeform (prestress) problem: static inflation for zero-pressure geometry.

Counterpart of vasp_tpu.models.predeform, the same hooks and defaults.
Behavioral parity target: reference src/vasp/simulations/predeform.py —
theta=1.0 backward Euler, Newton damping lmbda=0.5, ramped parabolic
velocity on [t_start_v, t_end_v] then ramped pressure on [t_start_p,
t_end_p] to P_final=11332.4 Pa, MooneyRivlin wall, Robin BC on the outer
wall, FSI restricted to a sphere, save_deg=1 required (reference L27-92).
The resulting final displacement is inverted by
vasp-tpu-torch-predeform-mesh (postprocessing/mesh_stages.py, SURVEY.md
§3.3).

post_solve hands the state's velocity tensor to the flow properties, which
run on the state's device."""
from pathlib import Path

import numpy as np

from vasp_tpu_torch.bcs.waveforms import CosineRamp, ParabolicInflow
from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.fem.measures import BoundaryMeasure
from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
from vasp_tpu_torch.mesh.io import read_vasp_mesh
from vasp_tpu_torch.mesh.markers import restrict_fsi_to_sphere
from vasp_tpu_torch.run.metrics import calculate_and_print_flow_properties


def set_problem_parameters(default_variables, **namespace):
    # identical physical setup to reference predeform.py:27-92
    E_s_val = 1e6
    nu_s_val = 0.45
    mu_s_val = E_s_val / (2 * (1 + nu_s_val))
    lambda_s_val = nu_s_val * 2.0 * mu_s_val / (1.0 - 2.0 * nu_s_val)
    default_variables.update(
        dict(
            T=1.0,
            dt=0.01,
            theta=1.0,  # backward Euler
            save_step=10,
            checkpoint_step=50,
            linear_solver="mumps",
            atol=1e-6,
            rtol=1e-6,
            recompute=20,
            recompute_tstep=20,
            lmbda=0.5,  # Newton damping
            mesh_path="mesh/cylinder.h5",
            inlet_id=2,
            inlet_outlet_s_id=11,
            fsi_id=22,
            rigid_id=11,
            outer_wall_id=33,
            rho_f=1.025e3,
            mu_f=3.5e-3,
            dx_f_id=1,
            v_max_final=0.1,
            P_final=11332.4,
            t_start_v=0.0,
            t_end_v=0.2,
            t_start_p=0.2,
            t_end_p=0.9,
            rho_s=1.0e3,
            solid_properties={
                "dx_s_id": 2,
                "material_model": "MooneyRivlin",
                "rho_s": 1.0e3,
                "mu_s": mu_s_val,
                "lambda_s": lambda_s_val,
                "C01": 0.02e6,
                "C10": 0.0,
                "C11": 1.8e6,
            },
            dx_s_id=2,
            fsi_region=[0.0, 0.0, 0.0, 0.004],
            extrapolation="laplace",
            extrapolation_sub_type="constant",
            folder="predeform_results",
            save_deg=1,  # required for predeform (reference predeform.py:80)
            k_s=[1e5],
            c_s=[10],
            ds_s_id=[33],
            robin_bc=True,
        )
    )
    return default_variables


def get_mesh_domain_and_boundaries(mesh_path, fsi_region, fsi_id, rigid_id,
                                   outer_wall_id, **namespace):
    if mesh_path and Path(mesh_path).exists():
        mesh = read_vasp_mesh(mesh_path)
    else:
        params = dict(r_inner=0.001, r_outer=0.0013, length=0.006,
                      n_theta=12, n_r_fluid=2, n_r_solid=1, n_z=8)
        params.update(namespace.get("generated_mesh_params") or {})
        mesh = fsi_tube_mesh(**params)
        # center the default tube on the origin so the default fsi sphere
        # (centered at 0) covers its middle
        mesh = type(mesh)(
            mesh.coords - np.array([0, 0, mesh.coords[:, 2].max() / 2]),
            mesh.cells, mesh.cell_markers, mesh.facets, mesh.facet_markers,
        )
    return restrict_fsi_to_sphere(mesh, fsi_id, outer_wall_id, rigid_id,
                                  fsi_region)


class InnerP:
    """Two-phase ramped static pressure (reference predeform.py:169-196)."""

    def __init__(self, t_start, t_end, P_final):
        self.ramp = CosineRamp(t_start, t_end)
        self.P_final = P_final
        self.P = 0.0

    def update(self, t):
        self.P = self.ramp(t) * self.P_final
        print("P = {} Pa".format(self.P))
        return self.P


def create_bcs(space, system, t_start_v, t_end_v, t_start_p, t_end_p, P_final,
               v_max_final, fsi_id, inlet_id, inlet_outlet_s_id, rigid_id,
               **namespace):
    p_out_bc_val = InnerP(t_start=t_start_p, t_end=t_end_p, P_final=P_final)
    b_ifc = system.interface_pressure_load(fsi_id)

    dsi = BoundaryMeasure(space, inlet_id)
    print("Inlet area = ", dsi.area)
    u_inflow_exp = ParabolicInflow(
        v_max_final=v_max_final, t_ramp=t_end_v - t_start_v,
        normal=dsi.mean_normal, center=dsi.centroid, area=dsi.area,
        t_ramp_start=t_start_v,
    )
    inlet_dofs = space.p2_dofs_on_facets(inlet_id)
    inlet_coords = space.p2_coords[inlet_dofs]

    def inlet_values(t):
        u_inflow_exp.update(t)
        return u_inflow_exp(inlet_coords).reshape(-1)

    s_dofs = space.p2_dofs_on_facets(inlet_outlet_s_id)
    rigid_dofs = space.p2_dofs_on_facets(rigid_id)
    bcs = [
        DirichletBC(space.field_dofs("v", inlet_dofs), inlet_values),
        DirichletBC(space.field_dofs("v", s_dofs), 0.0),
        DirichletBC(space.field_dofs("d", inlet_dofs), 0.0),
        DirichletBC(space.field_dofs("d", s_dofs), 0.0),
        DirichletBC(space.field_dofs("d", rigid_dofs), 0.0),
    ]

    def load_fn(t):
        return p_out_bc_val.P * b_ifc

    return dict(
        bcs=bcs, u_inflow_exp=u_inflow_exp, p_out_bc_val=p_out_bc_val,
        load_fn=load_fn, dsi=dsi, inlet_area=dsi.area,
    )


def pre_solve(t, u_inflow_exp, p_out_bc_val, **namespace):
    u_inflow_exp.update(t)
    p_out_bc_val.update(t)
    return dict(u_inflow_exp=u_inflow_exp, p_out_bc_val=p_out_bc_val)


def post_solve(dvp_, dsi, dt, space, inlet_area, mu_f, rho_f, **namespace):
    d, v, p = space.split(dvp_["n"])
    calculate_and_print_flow_properties(
        dt, space, v, inlet_area, mu_f, rho_f, dsi
    )
