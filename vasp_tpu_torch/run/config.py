"""Default solver configuration and CLI override machinery.

Mirrors the reference's three-tier config system (SURVEY.md §5.6):
(a) framework default_variables overridden by the problem module's
    set_problem_parameters,
(b) CLI overrides including --new-arguments key=value
    (reference: tests/test_simulations.py:22-23) and config files,
(c) the merged config serialized to Checkpoint/default_variables.json.

Key vocabulary matches the reference's serialized dump
(reference: tests/test_data/hemodynamics_data/Checkpoint/default_variables.json).
"""
import argparse
import ast
import json


def default_variables():
    return dict(
        # temporal
        T=1.0,
        dt=0.001,
        theta=0.501,
        t=0.0,
        counter=0,
        # element degrees (fixed Taylor-Hood P2/P2/P1)
        v_deg=2,
        p_deg=1,
        d_deg=2,
        # domains
        dx_f_id=1,
        dx_s_id=2,
        ds_s_id=None,
        # fluid
        rho_f=1.0e3,
        mu_f=1.0e-3,
        fluid="fluid",
        # solid
        solid="solid",
        material_model="StVenantKirchoff",
        rho_s=1.0e3,
        mu_s=5.0e4,
        nu_s=0.45,
        lambda_s=4.5e5,
        solid_properties=None,
        fluid_properties=None,
        gravity=None,
        # Robin BC
        robin_bc=False,
        k_s=0.0,
        c_s=0.0,
        # mesh lifting
        extrapolation="laplace",
        extrapolation_sub_type="constant",
        bc_ids=[],
        # solver
        linear_solver="mumps",
        solver="newtonsolver",
        atol=1e-7,
        rtol=1e-7,
        max_it=50,
        lmbda=1.0,
        recompute=5,
        recompute_tstep=50,
        quadrature_degree=6,
        # io
        loglevel=20,
        verbose=True,
        save_step=10,
        save_deg=1,
        checkpoint_step=500,
        folder="results",
        sub_folder=None,
        restart_folder=None,
        killtime=None,
        # misc
        generated_mesh_params=None,
        profile_dir=None,
        # the device the state and the element work live on: "cuda" runs
        # the hand-written kernels, "cpu" their plain torch versions
        device="cuda",
        fsi_id=22,
        inlet_id=2,
        rigid_id=11,
        outer_wall_id=33,
    )


def _parse_value(s):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def parse_command_line(argv=None):
    """turtleFSI-compatible CLI (reference: docs/simulation.md:10-26)."""
    parser = argparse.ArgumentParser(
        prog="vasp-tpu-torch-run",
        description="Run an FSI simulation on PyTorch/CUDA (problem-file "
                    "protocol)",
    )
    parser.add_argument("-p", "--problem", required=True,
                        help="problem name (built-in) or path to problem .py")
    parser.add_argument("-dt", type=float, default=None)
    parser.add_argument("-T", type=float, default=None)
    parser.add_argument("--theta", type=float, default=None)
    parser.add_argument("--folder", type=str, default=None)
    parser.add_argument("--sub-folder", type=str, default=None)
    parser.add_argument("--save-deg", type=int, default=None)
    parser.add_argument("--verbose", type=lambda s: s.lower() != "false",
                        default=None)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file with overrides")
    parser.add_argument("--new-arguments", nargs="*", default=None,
                        metavar="key=value")
    args = parser.parse_args(argv)

    overrides = {}
    if args.config:
        with open(args.config) as f:
            overrides.update(json.load(f))
    for key, cli in (("dt", args.dt), ("T", args.T), ("theta", args.theta),
                     ("folder", args.folder), ("sub_folder", args.sub_folder),
                     ("save_deg", args.save_deg), ("verbose", args.verbose)):
        if cli is not None:
            overrides[key] = cli
    if args.new_arguments:
        for kv in args.new_arguments:
            k, _, v = kv.partition("=")
            overrides[k] = _parse_value(v)
    return args.problem, overrides
