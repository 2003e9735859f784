"""Arteriovenous fistula (AVF) FSI problem.

Counterpart of vasp_tpu.models.avf, the same hooks, defaults, generated
Y mesh (preprocessing/bifurcation.py) and synthetic patient series.
Behavioral parity target: reference src/vasp/simulations/avf.py — two inlets
(proximal/distal artery) with patient-CSV waveforms interpolated to dt, one
outlet, two solid domains (artery/vein) with separate MooneyRivlin
properties, list-valued fsi/rigid/outer ids ([22,1022]/[11,1011]/[33,1033]),
FSI sphere over both domains, Robin BC, dt=1e-4, T=3 s (reference L26-317).

post_solve hands the state's tensors to the flow properties and the
minimum Jacobian, which run on the state's device, and one host copy of
the state per step to the probes (host numpy)."""
from pathlib import Path

import numpy as np

from vasp_tpu_torch.bcs.waveforms import CosineRamp
from vasp_tpu_torch.fem.dirichlet import DirichletBC
from vasp_tpu_torch.fem.measures import BoundaryMeasure, PointProbes
from vasp_tpu_torch.mesh.io import load_probe_points, read_vasp_mesh
from vasp_tpu_torch.mesh.markers import restrict_fsi_to_sphere
from vasp_tpu_torch.run.metrics import (
    calculate_and_print_flow_properties,
    compute_minimum_jacobian,
    print_probe_points,
)


def set_problem_parameters(default_variables, **namespace):
    # identical physical setup to reference avf.py:26-95
    E_s_artery, E_s_vein = 1e6, 3e6
    nu_s_val = 0.45
    mu_a = E_s_artery / (2 * (1 + nu_s_val))
    mu_v = E_s_vein / (2 * (1 + nu_s_val))
    lam_a = nu_s_val * 2.0 * mu_a / (1.0 - 2.0 * nu_s_val)
    lam_v = nu_s_val * 2.0 * mu_v / (1.0 - 2.0 * nu_s_val)
    default_variables.update(
        dict(
            T=3,
            dt=0.0001,
            theta=0.501,
            save_step=1,
            checkpoint_step=500,
            linear_solver="mumps",
            atol=1e-7,
            rtol=1e-7,
            recompute=30,
            recompute_tstep=10,
            inlet_id1=3,
            inlet_id2=2,
            outlet_id1=4,
            rigid_id=[11, 1011],
            fsi_id=[22, 1022],
            outlet_s_id=44,
            outer_id=[33, 1033],
            ds_s_id=[33, 1033],
            vel_t_ramp=0.2,
            p_t_ramp_start=0.05,
            p_t_ramp_end=0.2,
            rho_f=1.025e3,
            mu_f=3.5e-3,
            dx_f_id=1,
            extrapolation="laplace",
            extrapolation_sub_type="constant",
            rho_s=[1.0e3, 1.0e3],
            mu_s=[mu_a, mu_v],
            nu_s=nu_s_val,
            lambda_s=[lam_a, lam_v],
            material_model="MooneyRivlin",
            dx_s_id=[2, 1002],
            solid_properties=[
                {"dx_s_id": 2, "material_model": "MooneyRivlin",
                 "rho_s": 1.0e3, "mu_s": mu_a, "lambda_s": lam_a,
                 "C01": 0.03e6, "C10": 0.0, "C11": 2.2e6},
                {"dx_s_id": 1002, "material_model": "MooneyRivlin",
                 "rho_s": 1.0e3, "mu_s": mu_v, "lambda_s": lam_v,
                 "C01": 0.003e6, "C10": 0.0, "C11": 0.538e6},
            ],
            robin_bc=True,
            k_s=1e5,
            c_s=1e1,
            fsi_region=[0.33642, 0.0873934, 0.0369964, 0.002],
            mesh_path="mesh/avf.h5",
            patient_data_path="avf.csv",
            folder="avf_results",
            save_deg=2,
            scale_probe=True,
        )
    )
    return default_variables


def get_mesh_domain_and_boundaries(mesh_path, fsi_region, fsi_id, rigid_id,
                                   outer_id, **namespace):
    if mesh_path and Path(mesh_path).exists():
        mesh = read_vasp_mesh(mesh_path)
        return restrict_fsi_to_sphere(mesh, fsi_id, outer_id, rigid_id,
                                      fsi_region)
    # self-contained default: a TRUE anastomosis (Y-junction) from the
    # bifurcation mesher — vein trunk + two arterial branches, matching the
    # reference's patient AVF topology (reference avf.py:55-80: two inlets
    # PA/DA, one venous outlet, per-branch solid domains artery 2 /
    # vein 1002 from the vmtk branch-clipping contract,
    # vmtkmeshgeneratorfsi.py:255-316)
    from vasp_tpu_torch.mesh.markers import _with_markers
    from vasp_tpu_torch.preprocessing.bifurcation import (
        bifurcation_fsi_mesh, template_specs)

    params = dict(r_parent=0.002, r_d1=0.0016, r_d2=0.0016,
                  l_parent=0.008, l_daughter=0.008, angle_deg=35.0,
                  m=4, n_parent=4, n_daughter=6, n_r_solid=1,
                  thickness_frac=0.25)
    user = dict(namespace.get("generated_mesh_params") or {})
    # legacy tube-surrogate knobs map onto the Y resolution
    if "n_theta" in user:
        params["m"] = max(4, int(user.pop("n_theta")) // 2)
    if "n_z" in user:
        nz = int(user.pop("n_z"))
        params["n_parent"] = max(3, nz // 2)
        params["n_daughter"] = max(4, nz // 2 + 2)
    user.pop("n_r_fluid", None)
    user.pop("r_inner", None)
    user.pop("r_outer", None)
    user.pop("length", None)
    params.update(user)
    spec_keys = ("r_parent", "r_d1", "r_d2", "l_parent", "l_daughter",
                 "angle_deg")
    parent, d1, d2 = template_specs(**{k: params[k] for k in spec_keys})
    mesh = bifurcation_fsi_mesh(
        parent, d1, d2, m=params["m"], n_parent=params["n_parent"],
        n_daughter=params["n_daughter"], n_r_solid=params["n_r_solid"],
        thickness_frac=params["thickness_frac"])
    z_j = float(params["l_parent"])  # junction z (template parent is +z)

    # AVF orientation: the PARENT trunk is the VEIN (outflow), the two
    # daughters are the arteries (PA/DA inflow). Remap the Y markers:
    #   parent end-cap 2 -> venous outlet 4; daughter caps 3 -> PA inlet 3
    #   (x<0 branch) / DA inlet 2 (x>0 branch); vein-side solid cells and
    #   22/33/11 facets get the +1000 branch family.
    cm = mesh.cell_markers.copy()
    ccent = mesh.coords[mesh.cells].mean(axis=1)
    cm[(cm == 2) & (ccent[:, 2] < z_j)] = 1002
    fm = mesh.facet_markers.copy()
    fcent = mesh.coords[mesh.facets].mean(axis=1)
    vein_side = fcent[:, 2] < z_j
    for base, shifted in ((22, 1022), (33, 1033), (11, 1011)):
        fm[(mesh.facet_markers == base) & vein_side] = shifted
    fm[mesh.facet_markers == 2] = 4
    is_out = mesh.facet_markers == 3
    fm[is_out & (fcent[:, 0] < 0)] = 3
    fm[is_out & (fcent[:, 0] >= 0)] = 2
    mesh = _with_markers(mesh, cell_markers=cm, facet_markers=fm)
    # default AVF sphere: the anastomosis junction
    sphere = [0.0, 0.0, z_j, 2.5 * params["r_parent"]]
    return restrict_fsi_to_sphere(mesh, fsi_id, outer_id, rigid_id, sphere)


class VelInParaInterp:
    """Parabolic profile whose magnitude follows an interpolated patient
    series (reference avf.py VelInPara, L166-218)."""

    def __init__(self, dt, vel_t_ramp, normal, center, area, interp_velocity):
        self.dt = dt
        self.ramp = CosineRamp(0.0, vel_t_ramp)
        self.n = np.asarray(normal)
        self.c = np.asarray(center)
        self.r = np.sqrt(area / np.pi)
        self.interp_velocity = np.asarray(interp_velocity)
        self.v = 0.0

    def update(self, t):
        i = min(int(t / self.dt), len(self.interp_velocity) - 1)
        self.v = self.ramp(t) * self.interp_velocity[i]
        return self.v

    def __call__(self, coords):
        r2 = np.sum((coords - self.c) ** 2, axis=1)
        fact = 1.0 - r2 / self.r ** 2
        return -self.n[None, :] * (self.v * fact)[:, None]


class InnerPInterp:
    """Interface pressure following the interpolated patient series
    (reference avf.py InnerP)."""

    def __init__(self, dt, interp_P, p_t_ramp_start, p_t_ramp_end):
        self.dt = dt
        self.interp_P = np.asarray(interp_P)
        self.ramp = CosineRamp(p_t_ramp_start, p_t_ramp_end)
        self.P = 0.0

    def update(self, t):
        i = min(int(t / self.dt), len(self.interp_P) - 1)
        self.P = self.ramp(t) * self.interp_P[i]
        return self.P


def _load_patient_data(patient_data_path, T, dt):
    """CSV columns PA, DA, PV with a header row, resampled to num_t steps
    (reference avf.py:237-253)."""
    if patient_data_path and Path(patient_data_path).exists():
        data = np.loadtxt(patient_data_path, skiprows=1, delimiter=",",
                          usecols=(0, 1, 2))
    else:
        # synthetic physiological default: pulsatile PA/DA velocity + pressure
        tt = np.linspace(0, 2 * np.pi, 100)
        data = np.column_stack([
            0.3 + 0.2 * np.sin(tt),
            0.2 + 0.1 * np.sin(tt + 0.5),
            10000 + 2000 * np.sin(tt + 0.2),
        ])
    v_PA, v_DA, PV = data[:, 0], data[:, 1], data[:, 2]
    t_v = np.arange(len(v_PA))
    num_t = int(T / dt)
    tnew = np.linspace(0, len(v_PA), num=num_t)
    return (np.interp(tnew, t_v, v_PA), np.interp(tnew, t_v, v_DA),
            np.interp(tnew, t_v, PV))


def create_bcs(space, system, T, dt, fsi_id, inlet_id1, inlet_id2, rigid_id,
               vel_t_ramp, p_t_ramp_start, p_t_ramp_end, patient_data_path,
               **namespace):
    print("Create bcs")
    interp_PA, interp_DA, interp_P = _load_patient_data(
        patient_data_path, T, dt
    )
    dsi1 = BoundaryMeasure(space, inlet_id1)
    dsi2 = BoundaryMeasure(space, inlet_id2)
    u1 = VelInParaInterp(dt, vel_t_ramp, dsi1.mean_normal, dsi1.centroid,
                         dsi1.area, interp_PA)
    u2 = VelInParaInterp(dt, vel_t_ramp, dsi2.mean_normal, dsi2.centroid,
                         dsi2.area, interp_DA)

    in1 = space.p2_dofs_on_facets(inlet_id1)
    in2 = space.p2_dofs_on_facets(inlet_id2)
    c1, c2 = space.p2_coords[in1], space.p2_coords[in2]

    def vals1(t):
        u1.update(t)
        return u1(c1).reshape(-1)

    def vals2(t):
        u2.update(t)
        return u2(c2).reshape(-1)

    rigid_dofs = space.p2_dofs_on_facets(rigid_id)
    bcs = [
        DirichletBC(space.field_dofs("v", in1), vals1),
        DirichletBC(space.field_dofs("v", in2), vals2),
        DirichletBC(space.field_dofs("v", rigid_dofs), 0.0),
        DirichletBC(space.field_dofs("d", in1), 0.0),
        DirichletBC(space.field_dofs("d", in2), 0.0),
        DirichletBC(space.field_dofs("d", rigid_dofs), 0.0),
    ]

    p_out_bc_val = InnerPInterp(dt, interp_P, p_t_ramp_start, p_t_ramp_end)
    b_ifc = system.interface_pressure_load(fsi_id)

    def load_fn(t):
        return p_out_bc_val.P * b_ifc

    return dict(bcs=bcs, u_inflow_exp1=u1, u_inflow_exp2=u2,
                p_out_bc_val=p_out_bc_val, load_fn=load_fn, dsi1=dsi1,
                inlet_area=dsi1.area)


def initiate(mesh_path, scale_probe, mesh, space, **namespace):
    if mesh_path and Path(mesh_path).exists():
        probe_points = load_probe_points(mesh_path)
        if scale_probe:
            probe_points = probe_points * 0.001
    else:
        L = mesh.coords[:, 2].max()
        probe_points = np.array([[0.0, 0.0, L / 2]])
    return dict(probes=PointProbes(space, probe_points))


def pre_solve(t, u_inflow_exp1, u_inflow_exp2, p_out_bc_val, **namespace):
    u_inflow_exp1.update(t)
    u_inflow_exp2.update(t)
    p_out_bc_val.update(t)
    return dict(u_inflow_exp1=u_inflow_exp1, u_inflow_exp2=u_inflow_exp2,
                p_out_bc_val=p_out_bc_val)


def post_solve(probes, dvp_, dsi1, dt, space, inlet_area, mu_f, rho_f,
               **namespace):
    U = dvp_["n"]
    d, v, _ = space.split(U)
    _, v_h, p_h = space.split(U.cpu().numpy())
    print_probe_points(probes, v_h, p_h)
    calculate_and_print_flow_properties(
        dt, space, v, inlet_area, mu_f, rho_f, dsi1
    )
    compute_minimum_jacobian(space, d)
