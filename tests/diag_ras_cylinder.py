"""precond="ras" at vasp_tpu's defaults on the CPU, in either package.

    JAX_PLATFORMS=cpu python tests/diag_ras_cylinder.py vasp_tpu cylinder 12 8
    python tests/diag_ras_cylinder.py vasp_tpu_torch cylinder 12 8
    python tests/diag_ras_cylinder.py vasp_tpu_torch tube 8 10

(from the root of a checkout; a script beside the tests that pytest does
not collect)

Arguments: the package, the problem ("cylinder": -p cylinder through the
driver, 2 steps of dt=1e-3 at its tiny test settings; "tube": the
pressure-loaded tube of chip_smoke.py's small runs through IterativeStepper,
2 ramped steps), the tube's n_theta and n_z (cylinder: the model's
generated tube, radius 1 mm, length 0.75 mm a layer; tube: n_r_fluid=2,
length 1.6 mm a layer). The RAS options are vasp_tpu's defaults
(linear_solver="gmres", precond="ras": jac_dtype "f32", gmres_tol 1e-6,
gmres_restart 60, gmres_maxiter 300, overlap 2, ~1,500 dofs a subdomain).
Prints the dofs, the pattern's lines (build_pattern_auto's retries), and
per step the Newton iterations, the final and initial residual and, on
the port, the GMRES inner iterations. The question it answers: where does
one-level RAS stop converging, and does vasp_tpu stop there too?
"""
import io
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CYLINDER = dict(T=0.002, dt=0.001, mesh_path=None, quadrature_degree=3,
                atol=1e-7, rtol=1e-7, recompute=5, recompute_tstep=1,
                save_step=1, checkpoint_step=1000, raise_on_fail=False,
                linear_solver="gmres", precond="ras", verbose=True)


def run_cylinder(pkg, n_theta, n_z):
    if pkg == "vasp_tpu":
        from vasp_tpu.run.driver import run_simulation
        extra = {}
    else:
        from vasp_tpu_torch.run.driver import run_simulation
        extra = {"device": "cpu", "save_step": 0, "checkpoint_step": 0}
    mesh = dict(n_theta=n_theta, n_z=n_z, length=0.00075 * n_z)
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with redirect_stdout(buf):
            ns = run_simulation("cylinder", overrides=dict(
                CYLINDER, generated_mesh_params=mesh, folder=tmp + "/ras",
                **extra))
    print(f"{pkg}: -p cylinder, {ns['mesh'].num_cells} cells, "
          f"{ns['space'].ndof} dofs")
    for line in buf.getvalue().splitlines():
        if line.startswith(("RAS", "Newton iteration", "WARNING")):
            print("   ", line)
    stepper = getattr(ns["solver"], "stepper", None)
    if hasattr(stepper, "history"):
        print("    GMRES inner iterations per step",
              [h["gmres_inner"] for h in stepper.history])


def run_tube(pkg, n_theta, n_z):
    import chip_smoke as cs

    mesh = dict(cs.LADDER_MESH, n_theta=n_theta, n_z=n_z,
                length=0.0016 * n_z)
    if pkg == "vasp_tpu":
        import jax.numpy as jnp

        from vasp_tpu.fem.dirichlet import DirichletBC
        from vasp_tpu.fem.timestepper import IterativeStepper, StepOptions
        from vasp_tpu.mesh.generate import fsi_tube_mesh
        from vasp_tpu.run.system import FSISystem
        asarray = jnp.asarray
    else:
        import torch

        from vasp_tpu_torch.fem.dirichlet import DirichletBC
        from vasp_tpu_torch.fem.timestepper import IterativeStepper, \
            StepOptions
        from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
        from vasp_tpu_torch.run.system import FSISystem
        asarray = torch.as_tensor
    E, nu = 1e6, 0.45
    mu_s = E / (2 * (1 + nu))
    cfg = dict(dt=0.001, theta=0.501, rho_f=1.0e3, mu_f=1.5e-3, dx_f_id=1,
               rho_s=1e3, mu_s=mu_s, lambda_s=nu * 2 * mu_s / (1 - 2 * nu),
               dx_s_id=2, material_model="StVenantKirchoff",
               extrapolation="laplace", extrapolation_sub_type="constant",
               quadrature_degree=3)
    if pkg != "vasp_tpu":
        cfg["device"] = "cpu"
    system = FSISystem(fsi_tube_mesh(**mesh), cfg)
    space = system.space
    bcs = [DirichletBC(space.field_dofs("d", space.p2_dofs_on_facets(m)),
                       0.0) for m in (2, 3, 11)]
    bcs += [DirichletBC(space.field_dofs("v", space.p2_dofs_on_facets(m)),
                        0.0) for m in (2, 11)]
    bc = system.make_bcset(bcs)
    load = 150.0 * asarray(system.interface_pressure_load())
    bcv = asarray(bc.values_at(1e-3))
    print(f"{pkg}: pressure-loaded tube, {system.mesh.num_cells} cells, "
          f"{space.ndof} dofs")
    st = IterativeStepper(system, bc, StepOptions(precond="ras",
                                                  jac_dtype="f32"))
    U = system.zero_state()
    for k in (1, 2):
        buf = io.StringIO()
        with redirect_stdout(buf):
            U, stats = st.step(U, bcv, (0.5 + 0.5 * k) * load, k)
        for line in buf.getvalue().splitlines():
            if line.startswith("RAS"):
                print("   ", line)
        print(f"    step {k}: Newton iterations {int(stats['iterations'])}, "
              f"residual {float(stats['residual']):.3e} from "
              f"{float(stats['r0']):.3e}")
    if hasattr(st, "history"):
        print("    GMRES inner iterations per step",
              [h["gmres_inner"] for h in st.history])


if __name__ == "__main__":
    pkg, problem, n_theta, n_z = sys.argv[1], sys.argv[2], *map(
        int, sys.argv[3:5])
    {"cylinder": run_cylinder, "tube": run_tube}[problem](pkg, n_theta, n_z)
