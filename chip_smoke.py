#!/usr/bin/env python3
"""Smoke run of vasp_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py          # the 11,088-cell cylinder (98,859 dofs)
    python3 chip_smoke.py --full   # the 20,832-cell tube

Phases (any failure exits non-zero; no phase catches its own failure):

1. Device: needs torch.cuda; prints the card's name and power limit and
   builds the CUDA kernels from csrc/ (build seconds, ptxas register and
   spill report).
2. Kernel vs plain on the card, at the run's size: the element residual
   (K1 fluid, K2 solid), the element Jacobians (K3) and the two flow
   measures (K19) against their plain torch versions on the same inputs,
   relative error <= 1e-12 (the f64 atomics' order varies, nothing else),
   each timed with CUDA events beside its plain version.
3. Path parity: the small cylinder configuration of tests/conftest.py run
   on the CPU (plain versions) and on the card (kernels): the same Newton
   iteration counts and U within 1e-8 relative.
4. The main path at size: vasp_tpu_torch.run.driver.main on -p cylinder for
   5 steps of dt=1e-3, launch counters reset just before; every step must
   converge, U must be finite and every kernel must have launched. Prints
   s/step, Newton iterations and the time split of the solver's phases.

Phases 3 and 4 run with HDF5 output off (save_step=0, checkpoint_step=0),
so the smoke needs no h5py on the GPU host; the CPU tests hold the output
files.

The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""
import argparse
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL_KERNEL = 1e-12
TOL_PATH = 1e-8
SMOKE_MESH = dict(r_inner=0.002, r_outer=0.0026, length=0.04, n_theta=12,
                  n_r_fluid=3, n_r_solid=1, n_z=44)  # 11,088 cells
FULL_MESH = dict(SMOKE_MESH, n_theta=16, n_z=62)  # 20,832 cells
# HDF5 output off, so no h5py is needed; the CPU tests cover the
# Visualization/Checkpoint files
NO_FILES = dict(save_step=0, checkpoint_step=0)
# the cylinder overrides of tests/conftest.py (cylinder_run)
TINY = dict(T=0.003, dt=0.001, mesh_path=None, quadrature_degree=3,
            atol=1e-7, rtol=1e-7, recompute=5, recompute_tstep=1,
            verbose=True, **NO_FILES)
REPLACES = {
    "fluid_residual": ("element_kernels.cu", "vasp_tpu/fem/forms.py:86"),
    "solid_residual": ("element_kernels.cu", "vasp_tpu/fem/forms.py:205"),
    "fluid_jacobian": ("element_kernels.cu", "vasp_tpu/fem/assembly.py:92"),
    "solid_jacobian": ("element_kernels.cu", "vasp_tpu/fem/assembly.py:92"),
    "dg0_project_speed": ("measures.cu", "vasp_tpu/fem/measures.py:103"),
    "integrate_p2_dot_n": ("measures.cu", "vasp_tpu/fem/measures.py:88"),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b):
    """(relative 2-norm error, max abs error) of a against b."""
    d = (a - b).abs()
    return float(d.norm() / b.norm()), float(d.max())


def cuda_ms(fn, reps):
    """Mean milliseconds per call over `reps` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    require((ROOT / "vasp_tpu_torch" / "csrc").is_dir(),
            f"no vasp_tpu_torch package beside {Path(__file__).name}; run "
            f"from the root of a checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(ROOT))
    from vasp_tpu_torch.kernels import build

    tic = time.perf_counter()
    build.library()
    print(f"[1] kernels ready in {time.perf_counter() - tic:.2f} s "
          f"(nvcc {build.BUILD_SECONDS['nvcc']:.2f} s; 0 = already built)")
    log = build.BUILD_DIR / "nvcc.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print("    " + line.strip())


def build_system(mesh_params, device, seed):
    """The cylinder system at the given size, its BCs, and a seeded state."""
    import numpy as np
    import torch

    from vasp_tpu_torch.models import cylinder
    from vasp_tpu_torch.run.config import default_variables
    from vasp_tpu_torch.run.system import FSISystem

    cfg = cylinder.set_problem_parameters(default_variables())
    cfg.update(device=device, mesh_path=None,
               generated_mesh_params=mesh_params)
    mesh = cylinder.get_mesh_domain_and_boundaries(**cfg)
    system = FSISystem(mesh, cfg)
    # random states at the cylinder's scales: wall displacement ~1 um,
    # velocity ~1 cm/s, pressure ~100 Pa
    rng = np.random.default_rng(seed)
    space = system.space
    scale = np.concatenate([np.full(3 * space.n_p2, 1e-6),
                            np.full(3 * space.n_p2, 1e-2),
                            np.full(space.n_p1, 1e2)])
    U = torch.as_tensor(rng.normal(size=space.ndof) * scale, device=device)
    U0 = torch.as_tensor(rng.normal(size=space.ndof) * scale, device=device)
    return system, U, U0


def phase_kernels(mesh_params):
    """Each kernel against its plain version on the card; returns records."""
    import torch

    from vasp_tpu_torch.fem.measures import BoundaryMeasure
    from vasp_tpu_torch.fem.quadrature import tet_quadrature
    from vasp_tpu_torch.fem.shape import p2_tet
    from vasp_tpu_torch.kernels import element
    from vasp_tpu_torch.kernels import measures as km

    system, U, U0 = build_system(mesh_params, "cuda", seed=0)
    print(f"[2] system: {system.mesh.num_cells} cells, {system.space.ndof} "
          f"dofs, blocks " + ", ".join(
              f"{b.name}={b.dofs.shape[0]}" for b in system.assembler.blocks))
    records = {}

    def record(name, err, ms, plain_ms, shape):
        rel, mx = err
        print(f"    {name:20s} {shape:>22s}  rel {rel:.3e}  max_abs {mx:.3e}"
              f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        require(rel <= TOL_KERNEL,
                f"{name} disagrees with its plain version: rel {rel:.3e}")
        records[name] = dict(max_abs_err=mx, rel_err=rel, ms=ms,
                             plain_ms=plain_ms)

    for b in system.assembler.blocks:
        kind = b.kernel.kind
        K = b.dofs.shape[0]
        Rk = element.residual_cuda(b, U, U0, torch.zeros_like(U))
        Rp = element.residual_plain(b, U, U0, torch.zeros_like(U))
        R = torch.zeros_like(U)
        record(f"{kind}_residual", rel_err(Rk, Rp),
               cuda_ms(lambda: element.residual_cuda(b, U, U0, R), 20),
               cuda_ms(lambda: element.residual_plain(b, U, U0, R), 3),
               f"K={K} -> ({U.shape[0]},)")

        Ak = element.jacobian_cuda(b, U, U0)
        Ap = element.jacobian_plain(b, U, U0, chunk=128)
        d = (Ak - Ap).reshape(K, -1).norm(dim=1)
        per_block = float((d / Ap.reshape(K, -1).norm(dim=1)).max())
        mx = float((Ak - Ap).abs().max())
        del Ap
        record(f"{kind}_jacobian", (per_block, mx),
               cuda_ms(lambda: element.jacobian_cuda(b, U, U0), 5),
               cuda_ms(lambda: element.jacobian_plain(b, U, U0, chunk=128), 1),
               f"K={K} -> ({K},64,64)")

    space = system.space
    v = space.split(U)[1].contiguous()
    pts, wq = tet_quadrature(2)
    N2 = torch.as_tensor(p2_tet(pts)[0], device="cuda")
    wq = torch.as_tensor(wq, device="cuda")
    dofs = torch.as_tensor(space.cell_dofs_p2.astype("int64"), device="cuda")
    sk = km.dg0_project_speed_cuda(v, dofs, N2, wq)
    sp_ = km.dg0_project_speed_plain(v, dofs, N2, wq)
    record("dg0_project_speed", rel_err(sk, sp_),
           cuda_ms(lambda: km.dg0_project_speed_cuda(v, dofs, N2, wq), 50),
           cuda_ms(lambda: km.dg0_project_speed_plain(v, dofs, N2, wq), 50),
           f"Nc={dofs.shape[0]}")

    inlet = BoundaryMeasure(space, system.cfg["inlet_id"])
    tabs = inlet.device_tables("cuda")
    fk = km.integrate_p2_dot_n_cuda(v, *tabs)
    fp = km.integrate_p2_dot_n_plain(v, *tabs)
    record("integrate_p2_dot_n", rel_err(fk.reshape(1), fp.reshape(1)),
           cuda_ms(lambda: km.integrate_p2_dot_n_cuda(v, *tabs), 50),
           cuda_ms(lambda: km.integrate_p2_dot_n_plain(v, *tabs), 50),
           f"facets={tabs[0].shape[0]}")
    return records


def _run_quiet(overrides):
    from vasp_tpu_torch.run.driver import run_simulation

    buf = io.StringIO()
    with redirect_stdout(buf):
        ns = run_simulation("cylinder", overrides=overrides)
    iters = [json.loads(line)["newton_iterations"] for line in
             (Path(overrides["folder"]) / "metrics.jsonl").read_text()
             .splitlines()]
    return ns, iters, buf.getvalue()


def phase_parity(tmp):
    tic = time.perf_counter()
    ns_c, it_c, _ = _run_quiet(dict(TINY, device="cpu",
                                    folder=str(tmp / "tiny_cpu")))
    t_cpu = time.perf_counter() - tic
    tic = time.perf_counter()
    ns_g, it_g, log = _run_quiet(dict(TINY, device="cuda",
                                      folder=str(tmp / "tiny_cuda")))
    t_gpu = time.perf_counter() - tic
    Uc = ns_c["dvp_"]["n"]
    Ug = ns_g["dvp_"]["n"].cpu()
    rel = float((Ug - Uc).norm() / Uc.norm())
    print(f"[3] tiny cylinder ({ns_c['mesh'].num_cells} cells, 3 steps): "
          f"Newton iterations cpu {it_c} cuda {it_g}; U rel diff {rel:.3e}; "
          f"wall cpu {t_cpu:.1f} s, cuda {t_gpu:.1f} s")
    require(it_c == it_g, "Newton iteration counts differ between the CPU "
                          "plain path and the CUDA kernel path")
    require(rel <= TOL_PATH, f"U differs by {rel:.3e} relative (> 1e-8)")
    require(log.count("Solved for timestep") == 3, "tiny run missed steps")


def phase_main(tmp, mesh_params):
    import torch

    from vasp_tpu_torch.kernels import build
    from vasp_tpu_torch.run import driver

    cfg_path = tmp / "smoke_config.json"
    cfg_path.write_text(json.dumps(dict(
        mesh_path=None, generated_mesh_params=mesh_params, **NO_FILES)))
    folder = tmp / "cylinder_smoke"
    build.reset_launch_counts()
    tic = time.perf_counter()
    ns = driver.main(["-p", "cylinder", "-T", "0.005", "-dt", "0.001",
                      "--folder", str(folder), "--config", str(cfg_path)],
                     return_namespace=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(build.LAUNCHES)

    steps = [json.loads(line) for line in
             (folder / "metrics.jsonl").read_text().splitlines()]
    U = ns["dvp_"]["n"]
    require(U.is_cuda, "the main path's state is not on the card")
    require(len(steps) == 5, f"{len(steps)} steps instead of 5")
    require(all(s["converged"] for s in steps), "a step did not converge")
    require(bool(torch.isfinite(U).all()), "U is not finite")
    missing = [k for k, n in launches.items() if n == 0]
    require(not missing, f"kernels never launched on the main path: {missing}")

    secs = [s["cpu_time"] for s in steps]
    print(f"[4] cylinder main path: {ns['mesh'].num_cells} cells, "
          f"{ns['space'].ndof} dofs, 5 steps in {wall:.2f} s")
    print(f"    s/step {', '.join(f'{x:.3f}' for x in secs)}; "
          f"steps 2-5 mean {sum(secs[1:]) / 4:.3f} s")
    print(f"    Newton iterations {[s['newton_iterations'] for s in steps]}; "
          f"factorizations {ns['solver'].factorizations}")
    timings = dict(ns["solver"].timings)
    print("    solver time split (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(timings.items())))
    print(f"    launches {launches}")
    print(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="run phases 2 and 4 on the 20,832-cell tube")
    args = ap.parse_args(argv)
    mesh_params = FULL_MESH if args.full else SMOKE_MESH

    phase_device()
    import torch

    records = phase_kernels(mesh_params)
    with tempfile.TemporaryDirectory(prefix="vasp_smoke_") as tmp:
        tmp = Path(tmp)
        phase_parity(tmp)
        torch.cuda.reset_peak_memory_stats()
        launches = phase_main(tmp, mesh_params)

    kernels = []
    for name, (src, rep) in REPLACES.items():
        r = records[name]
        require(all(math.isfinite(r[k]) for k in ("max_abs_err", "ms",
                                                  "plain_ms")),
                f"{name}: non-finite measurement")
        kernels.append(dict(name=name, route="cuda",
                            source=f"vasp_tpu_torch/csrc/{src}",
                            replaces=rep, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
