"""Time-loop driver implementing the problem-file hook protocol.

This is the turtleFSI-CLI equivalent (the reference runs
``turtleFSI -p <problem>``, reference: docs/simulation.md:10-13). A problem
module provides the same hooks the reference's problem files do
(SURVEY.md §1 L5b protocol):

    set_problem_parameters(default_variables, **ns) -> default_variables
    get_mesh_domain_and_boundaries(**ns)            -> TetMesh
    initiate(**ns)                                  -> dict (optional)
    create_bcs(**ns)                                -> dict with "bcs" and
                                                       optional "loads"
    pre_solve(t, **ns)                              -> dict (optional)
    post_solve(**ns)                                -> None/dict (optional)
    finished(**ns)                                  -> None (optional)

Hook namespace: all config keys spread flat (like the reference), plus
runtime objects: mesh, space, system, dvp_ (dict with "n"/"n-1" state),
assembler. The state lives on the config's ``device`` (default "cuda")
as float64 tensors. ``create_bcs`` returns Dirichlet BCs built with
vasp_tpu_torch.fem.dirichlet.DirichletBC; time-dependent inflow expressions are
host callables updated in pre_solve.

Per-timestep stdout follows the reference's log contract
("Solved for timestep {n}, t = {t} in {cpu} s",
reference: docs/offset_stenosis.md:197 and log_plotter.py:72).
"""
import importlib
import importlib.util
import sys
import time
from pathlib import Path

from vasp_tpu_torch.run import checkpoint as ckpt
from vasp_tpu_torch.run.config import default_variables, parse_command_line
from vasp_tpu_torch.run.output import VisualizationOutput
from vasp_tpu_torch.run.system import FSISystem


def load_problem_module(problem):
    """Resolve a problem: built-in name in vasp_tpu_torch.models, or a file path."""
    path = Path(problem)
    if path.suffix == ".py" and path.exists():
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[path.stem] = mod
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(f"vasp_tpu_torch.models.{problem}")


def _call_hook(mod, name, ns, required=False):
    fn = getattr(mod, name, None)
    if fn is None:
        if required:
            raise AttributeError(f"problem module lacks required hook {name}")
        return None
    return fn(**ns)


def run_simulation(problem, overrides=None):
    """Run a full simulation; returns the final namespace (for tests)."""
    mod = load_problem_module(problem) if isinstance(problem, str) else problem
    cfg = default_variables()
    cfg = mod.set_problem_parameters(default_variables=cfg, **cfg) or cfg
    if overrides:
        cfg.update(overrides)

    folder = Path(cfg["folder"])
    if cfg.get("sub_folder"):
        folder = folder / cfg["sub_folder"]
    folder.mkdir(parents=True, exist_ok=True)
    cfg["folder"] = str(folder)

    # tee stdout into <folder>/run.log so vasp-log-plotter always has a log
    # to parse (the reference relies on the queue system capturing stdout;
    # appending keeps restart-into-same-folder runs in one file)
    _log_fh = open(folder / "run.log", "a", buffering=1)
    _stdout_write = sys.stdout.write

    def _tee(text):
        _log_fh.write(text)
        return _stdout_write(text)

    sys.stdout.write = _tee
    try:
        return _run_simulation_inner(mod, cfg)
    finally:
        sys.stdout.write = _stdout_write
        _log_fh.close()


def _run_simulation_inner(mod, cfg):
    folder = Path(cfg["folder"])
    ns = dict(cfg)
    # save_step=0 turns the Visualization series off, checkpoint_step=0 the
    # Checkpoint files; with both off the run writes no HDF5 at all
    save_step = int(cfg.get("save_step", 1))
    checkpoint_step = int(cfg.get("checkpoint_step", 500))
    mesh = mod.get_mesh_domain_and_boundaries(**ns)
    if save_step or checkpoint_step:
        # persist the (possibly re-marked / generated) mesh in the reference's
        # results layout so every postprocessing stage can find it
        # (reference folder layout: docs/offset_stenosis.md:200-225)
        from vasp_tpu_torch.mesh.io import write_vasp_mesh

        mesh_dir = folder / "Mesh"
        mesh_dir.mkdir(parents=True, exist_ok=True)
        write_vasp_mesh(mesh_dir / "mesh.h5", mesh)
    system = FSISystem(mesh, cfg)
    space = system.space
    ns.update(mesh=mesh, system=system, space=space, cfg=cfg,
              assembler=system.assembler)

    # restart or fresh state
    if cfg.get("restart_folder") and cfg["restart_folder"] not in (None, "None"):
        U, t, counter = ckpt.load_checkpoint(cfg["restart_folder"], space,
                                             device=system.device)
    else:
        U, t, counter = system.zero_state(), float(cfg.get("t", 0.0)), 0
    dvp_ = {"n": U, "n-1": U}
    ns["dvp_"] = dvp_

    upd = _call_hook(mod, "initiate", ns)
    if upd:
        ns.update(upd)

    upd = _call_hook(mod, "create_bcs", ns, required=True)
    ns.update(upd)
    bc_set = system.make_bcset(ns["bcs"])
    solver = system.make_solver(bc_set)
    ns.update(bc_set=bc_set, solver=solver)

    is_restart = bool(cfg.get("restart_folder")
                      and cfg["restart_folder"] not in (None, "None")
                      and Path(cfg["restart_folder"]).resolve()
                      == folder.resolve())
    viz = None
    if save_step:
        viz = VisualizationOutput(folder, space,
                                  save_deg=cfg.get("save_deg", 1),
                                  restart=is_restart)
    ckpt.save_config(folder, cfg)

    # structured observability alongside the reference's stdout contract
    # (SURVEY.md §5.1: JSONL step metrics + profiler traces)
    from vasp_tpu_torch.run.metrics import JsonlMetrics

    metrics = JsonlMetrics(folder)
    profile_dir = cfg.get("profile_dir")
    profiler = None
    if profile_dir:
        import torch.profiler as tprof

        acts = [tprof.ProfilerActivity.CPU]
        if system.device.type == "cuda":
            acts.append(tprof.ProfilerActivity.CUDA)
        profiler = tprof.profile(activities=acts)
        profiler.start()

    dt = float(cfg["dt"])
    T = float(cfg["T"])
    killtime = cfg.get("killtime")
    t_start_wall = time.time()

    n_steps = int(round((T - t) / dt))
    for step in range(counter + 1, counter + n_steps + 1):
        t += dt
        tic = time.time()
        ns["t"] = t
        upd = _call_hook(mod, "pre_solve", ns)
        if upd:
            ns.update(upd)

        # assemble time-dependent load (e.g. interface pressure)
        load = None
        if "load_fn" in ns and ns["load_fn"] is not None:
            load = ns["load_fn"](t)

        U0 = dvp_["n"]
        U = bc_set.apply(U0, t)
        U, info = solver.solve(U, U0, t=t, tstep=step, load=load)
        dvp_["n-1"] = U0
        dvp_["n"] = U
        ns["counter"] = step

        upd = _call_hook(mod, "post_solve", ns)
        if upd:
            ns.update(upd)

        if save_step and step % save_step == 0:
            viz.write(U, t)
        if checkpoint_step and step % checkpoint_step == 0:
            ckpt.save_checkpoint(folder, space, U, t, step)
            cfg["t"] = t
            cfg["counter"] = step
            ckpt.save_config(folder, cfg)

        toc = time.time()
        if cfg.get("verbose", True):
            print(f"Solved for timestep {step}, t = {t:.4f} in {toc - tic:.1f} s")
        metrics.write(
            tstep=step, t=t, cpu_time=toc - tic,
            newton_iterations=int(info["iterations"]),
            residual=float(info["residual"]),
            converged=bool(info.get("converged", True)),
        )
        if killtime is not None and (time.time() - t_start_wall) > killtime:
            print("Killtime reached, checkpointing and exiting.")
            if checkpoint_step:
                ckpt.save_checkpoint(folder, space, U, t, step)
            break

    if checkpoint_step:
        ckpt.save_checkpoint(folder, space, dvp_["n"], t,
                             ns.get("counter", 0))
    metrics.close()
    if profiler is not None:
        profiler.stop()
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
    _call_hook(mod, "finished", ns)
    return ns


def main(argv=None, return_namespace=False):
    """Console entry point (vasp-tpu-torch-run). Returns None, so the console
    script exits 0; with return_namespace=True, the run's final namespace
    (as run_simulation returns it) for callers that inspect the run."""
    problem, overrides = parse_command_line(argv)
    ns = run_simulation(problem, overrides)
    return ns if return_namespace else None


if __name__ == "__main__":
    main()
