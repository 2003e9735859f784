"""Tiny cylinder FSI problem (smoke test).

Behavioral parity target: reference problem file
src/vasp/simulations/cylinder.py — steady parabolic inflow ramped over 0.1 s,
ramped interface pressure to P_final, laplace/constant lifting, theta=0.501,
same material and BC structure (reference: cylinder.py:24-211).

If ``mesh_path`` is unset or missing, a parametric FSI tube at the reference
cylinder's scale is generated on the fly (the reference ships a pre-built
cylinder.h5; we are self-contained)."""
from pathlib import Path


from vasp_tpu_torch.bcs.waveforms import CosineRamp, ParabolicInflow
from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.fem.measures import BoundaryMeasure
from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
from vasp_tpu_torch.mesh.io import read_vasp_mesh
from vasp_tpu_torch.run.metrics import calculate_and_print_flow_properties


def set_problem_parameters(default_variables, **namespace):
    # identical physical setup to reference cylinder.py:24-72
    E_s_val = 1e6
    nu_s_val = 0.45
    mu_s_val = E_s_val / (2 * (1 + nu_s_val))
    lambda_s_val = nu_s_val * 2.0 * mu_s_val / (1.0 - 2.0 * nu_s_val)
    default_variables.update(
        dict(
            T=0.1,
            dt=0.001,
            theta=0.501,
            save_step=1,
            checkpoint_step=50,
            linear_solver="mumps",
            atol=1e-6,
            rtol=1e-6,
            recompute=20,
            recompute_tstep=20,
            mesh_path="mesh/cylinder.h5",
            inlet_id=2,
            inlet_outlet_s_id=11,
            fsi_id=22,
            rigid_id=11,
            outer_wall_id=33,
            rho_f=1.025e3,
            mu_f=3.5e-3,
            dx_f_id=1,
            v_max_final=0.75,
            P_final=10000,
            rho_s=1.0e3,
            mu_s=mu_s_val,
            nu_s=nu_s_val,
            lambda_s=lambda_s_val,
            dx_s_id=2,
            extrapolation="laplace",
            extrapolation_sub_type="constant",
            folder="cylinder_results",
            save_deg=1,
        )
    )
    return default_variables


def get_mesh_domain_and_boundaries(mesh_path, **namespace):
    print("Obtaining mesh, domains and boundaries...")
    if mesh_path and Path(mesh_path).exists():
        return read_vasp_mesh(mesh_path)
    params = dict(r_inner=0.001, r_outer=0.0013, length=0.006,
                  n_theta=12, n_r_fluid=2, n_r_solid=1, n_z=8)
    params.update(namespace.get("generated_mesh_params") or {})
    return fsi_tube_mesh(**params)


class InnerP:
    """Ramped interface pressure (reference cylinder.py:133-157)."""

    def __init__(self, t, t_ramp, P_final):
        self.ramp = CosineRamp(0.0, t_ramp)
        self.P_final = P_final
        self.P = 0.0
        self.update(t)

    def update(self, t):
        self.P = self.ramp(t) * self.P_final
        return self.P


def create_bcs(space, system, P_final, v_max_final, fsi_id, inlet_id,
               inlet_outlet_s_id, rigid_id, **namespace):
    # interface pressure -> linear load on the momentum residual
    p_out_bc_val = InnerP(t=0.0, t_ramp=0.1, P_final=P_final)
    b_ifc = system.interface_pressure_load(fsi_id)

    # inlet geometry (area/center/normal from facet integrals, like the
    # reference's assemble() calls)
    dsi = BoundaryMeasure(space, inlet_id)
    u_inflow_exp = ParabolicInflow(
        v_max_final=v_max_final, t_ramp=0.1,
        normal=dsi.mean_normal, center=dsi.centroid, area=dsi.area,
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
        bcs=bcs,
        u_inflow_exp=u_inflow_exp,
        p_out_bc_val=p_out_bc_val,
        load_fn=load_fn,
        dsi=dsi,
        inlet_area=dsi.area,
    )


def pre_solve(t, u_inflow_exp, p_out_bc_val, **namespace):
    u_inflow_exp.update(t)
    p_out_bc_val.update(t)
    return dict(u_inflow_exp=u_inflow_exp, p_out_bc_val=p_out_bc_val)


def post_solve(dvp_, dt, space, inlet_area, mu_f, rho_f, dsi, **namespace):
    d, v, p = space.split(dvp_["n"])
    calculate_and_print_flow_properties(
        dt, space, v, inlet_area, mu_f, rho_f, dsi
    )
