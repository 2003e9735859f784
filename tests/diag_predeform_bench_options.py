"""-p predeform on the bench configuration, on the CPU, in either package.

    JAX_PLATFORMS=cpu python tests/diag_predeform_bench_options.py vasp_tpu
    python tests/diag_predeform_bench_options.py vasp_tpu_torch

(from the root of a checkout whose packages are installed, pip install -e .;
a script beside the tests that pytest does not collect)

Runs the options chip_smoke.py's phase 9 gives -p predeform (bench.py's
Newton-Krylov options with max_it=50, the ramps shifted so that pressure is
on within the run, dt=0.01, 5 steps) on a 1,440-cell predeform tube
(n_theta=8, n_r_fluid=2, n_r_solid=1, n_z=12) with raise_on_fail=False,
and prints per step the Newton iterations, whether it converged, its final
residual and the ladder tiers it took, and the probe of the last banded
factors. The question it answers: does vasp_tpu converge on these options
where the port's ladder climbs? The port on the CPU runs the plain torch
versions of its kernels.
"""
import io
import json
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path

CFG = dict(linear_solver="gmres", residual_dtype="f32f", krylov_dtype="f32",
           gmres_tol=1e-3, gmres_restart=60, gmres_maxiter=120,
           jac_recompute=2, atol=1e-6, rtol=1e-6, max_it=50, T=0.05,
           dt=0.01, t_end_v=0.02, t_start_p=0.02, t_end_p=0.72,
           raise_on_fail=False, mesh_path=None, verbose=True,
           generated_mesh_params=dict(n_theta=8, n_r_fluid=2, n_r_solid=1,
                                      n_z=12))


def main(package):
    if package == "vasp_tpu":
        from vasp_tpu.run.driver import run_simulation
        extra = dict(save_step=100, checkpoint_step=100)
    else:
        import torch

        from vasp_tpu_torch.run.driver import run_simulation
        torch.set_num_threads(2)
        extra = dict(device="cpu", save_step=0, checkpoint_step=0)
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp) / "predeform"
        buf = io.StringIO()
        tic = time.perf_counter()
        with redirect_stdout(buf):
            ns = run_simulation("predeform", overrides=dict(
                CFG, folder=str(folder), **extra))
        wall = time.perf_counter() - tic
        steps = [json.loads(line) for line in
                 (folder / "metrics.jsonl").read_text().splitlines()]
    # the ladder's lines ("Newton: ... - escalating to ...") of each step
    chunks = buf.getvalue().split("Solved for timestep")
    print(f"{package}: {ns['mesh'].num_cells} cells, {len(steps)} steps in "
          f"{wall:.1f} s (host CPU)")
    for s, chunk in zip(steps, chunks):
        print(f"  step {s['tstep']}: {s['newton_iterations']} Newton "
              f"iterations, converged {s['converged']}, residual "
              f"{s['residual']:.3e}")
        for line in chunk.splitlines():
            if line.startswith("Newton:"):
                print(f"    {line}")
    print(f"  probe of the last banded factors: "
          f"{float(ns['solver'].stepper._last_rel):.3e}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "vasp_tpu_torch")
