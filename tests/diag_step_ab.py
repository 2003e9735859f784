"""chip_smoke.py's phases 4-9 (the LU path on the 2,520-cell tube, the
Newton-Krylov path and the bench configuration on the 20,832-cell cylinder,
bench.py's stenosed tube, the stenosis and aneurysm models, predeform, its
chain and the AVF) for one or more checkouts, in turns on the same card:
each phase's s/step, Newton and GMRES counts, ladder tiers and time
splits, the element Jacobians' seconds among them, as the smoke prints
them.

On a machine with a card, from the root of a checkout, with another
checkout unpacked beside it (e.g. `git archive` of a parent commit into a
directory that .gitignore lists):

    python3 tests/diag_step_ab.py PARENT . . PARENT

Each ROOT runs in a process of its own, with its own package and
chip_smoke.py, its kernels built from its own csrc/ into ROOT/build/. The
K5 bound per direction is printed against zero kernel bounds (phase 2 is
not run here)."""
import importlib.util
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def one(root):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from vasp_tpu_torch.kernels import build

    assert Path(build.__file__).resolve().is_relative_to(root)
    tic = time.perf_counter()
    build.library()
    print(f"[ab] {root}: kernels ready in {time.perf_counter() - tic:.1f} s",
          flush=True)
    records = {"elem_matvec": {"bound_ms": 0.0},
               "banded_apply": {"bound_ms": 0.0}}
    with tempfile.TemporaryDirectory(prefix="vasp_ab_") as tmp:
        tmp = Path(tmp)
        cs.phase_lu(tmp)
        cs.phase_krylov(tmp, records, "gmres", "[5] cylinder, Newton-Krylov "
                        "path (linear_solver=gmres):", linear_solver="gmres")
        torch.cuda.empty_cache()
        cs.phase_krylov(tmp, records, "f32f", "[6] cylinder, bench "
                        "configuration:", **cs.BENCH_CFG)
        torch.cuda.empty_cache()
        cs.phase_models(tmp, records)
        for phase in (cs.phase_predeform, cs.phase_avf):
            torch.cuda.empty_cache()
            phase(tmp, records)
    torch.cuda.empty_cache()
    cs.phase_bench(records)


def main(roots):
    for k, root in enumerate(roots):
        print(f"[ab] run {k + 1} of {len(roots)}: {root}", flush=True)
        subprocess.run([sys.executable, __file__, "--one", root], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
    else:
        main(sys.argv[1:] or ["."])
