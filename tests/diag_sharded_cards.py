"""The sharded Newton-Krylov path of chip_smoke.py phase 15b (the
20,832-cell cylinder on phase 5's configuration, 3 steps, started as
vasp-tpu-torch-run starts it) in several runs, each given as
label:backend:ranks; by default nccl2:nccl:2, gloo2:gloo:2 and
nccl4:nccl:4 (a card a rank: four cards). Rank r runs on cuda:<r % cards>.
Prints per run the Newton counts and residuals, per rank its card, GMRES
counts, seconds a step, peak memory, K21a's launches and the stepper's
timings, and each run's final state against the first run's; fails where
a rank is not on its card or a run's Newton counts differ from the
first's. With --root DIR the package is imported from the checkout at DIR
(another commit, to compare two in one call), the harness from this one.

    python tests/diag_sharded_cards.py [--root DIR] [label:backend:ranks ...]

(needs CUDA devices and nvcc; run from the root of a checkout with the
checkout on PYTHONPATH.)
"""
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # not in the spawned ranks, which re-run this module as __mp_main__ on
    # the sys.path of the process that started them (--root's first)
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

RUNS = ("nccl2:nccl:2", "gloo2:gloo:2", "nccl4:nccl:4")


def main(argv):
    if argv[:1] == ["--root"]:
        # before vasp_tpu_torch is first imported (chip_smoke imports it
        # only inside its functions)
        sys.path.insert(0, str(Path(argv[1]).resolve()))
        argv = argv[2:]
    runs = [(label, backend, int(n)) for label, backend, n in
            (spec.split(":") for spec in argv or RUNS)]
    import vasp_tpu_torch

    cards = torch.cuda.device_count()
    print(f"{torch.cuda.get_device_name(0)}; cards {cards}; package "
          f"{Path(vasp_tpu_torch.__file__).parent}", flush=True)
    states, newton = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, backend, n in runs:
            wall, ranks, steps, U = cs.sharded_run(Path(tmp), label, backend,
                                                   n)
            states[label] = U
            newton[label] = [s["newton_iterations"] for s in steps]
            print(f"[{label}] wall {wall:.2f} s; newton {newton[label]}; "
                  f"residuals {[s['residual'] for s in steps]}", flush=True)
            for r in ranks:
                h = r["history"]
                print(f"   rank {r['rank']} on {r['device']} "
                      f"({r['backend']}): nb_loc {r['nb_loc']}, GMRES "
                      f"{[x['gmres_inner'] for x in h]}, s/step "
                      f"{[round(x, 4) for x in r['step_s']]}, peak "
                      f"{r['peak'] / 2**30:.2f} GiB, K21a "
                      f"{r['launches']['banded_carry']}, updates "
                      f"{r['launches']['banded_carry_update']}, probe "
                      f"{r['probe']:.3e}; timings " + json.dumps(
                          {k: round(v, 4) for k, v in r["timings"].items()}),
                      flush=True)
                cs.require(r["device"] == f"cuda:{r['rank'] % cards}",
                           f"{label}: rank {r['rank']} on {r['device']}")
            cs.require(newton[label] == newton[runs[0][0]],
                       f"{label}: Newton {newton[label]}")
    first = runs[0][0]
    for label, _, _ in runs[1:]:
        d = cs.rel_err(states[label], states[first])[0]
        print(f"U {label} vs {first}: rel {d:.3e}, equal "
              f"{torch.equal(states[label], states[first])}")


if __name__ == "__main__":
    main(sys.argv[1:])
