"""Readings of K21a's single stages against their plain versions, on the
card: for each stage of one rank's solve (t = Sinv r, the forward scan
with and without its incoming carry, the backward scan likewise), the
kernel's and the plain version's relative 2-norm distances to the same
stage in float64 on the same inputs, and their ratio. The factors are real
banded factors in each storage instance (float32; float32 Sinv with bf16
H/G; all bf16), split into two ranks' spans: those of the small tube of
tests/test_torch_kernels_cuda.py and those of chip_smoke.py phase 2 (the
20,832-cell tube at the state of its first rebuild), at seeded right-hand
sides. The per-stage tolerance of the K21a checks is read off these
ratios.

    python tests/diag_carry_stages.py [seeds] [out.json]

(needs a CUDA device and nvcc; the package on PYTHONPATH, run from the
root of a checkout; seeds defaults to 8, out.json to
carry_stage_readings.json in the working directory.)
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vasp_tpu_torch.fem import banded as fb  # noqa: E402
from vasp_tpu_torch.fem.scaling import ruiz_scales  # noqa: E402
from vasp_tpu_torch.kernels import banded as kb  # noqa: E402
from vasp_tpu_torch.kernels import scaling as ks  # noqa: E402

BF = torch.bfloat16
STAGES = ("times", "forward_zero", "forward_carry", "backward_zero",
          "backward_carry")


def small_tube():
    """The system and BC set of test_torch_kernels_cuda.py's banded_inputs."""
    from vasp_tpu_torch.fem.dirichlet import DirichletBC
    from vasp_tpu_torch.mesh.generate import fsi_tube_mesh
    from vasp_tpu_torch.run.system import FSISystem

    sysm = FSISystem(fsi_tube_mesh(n_theta=12, n_r_fluid=2, n_r_solid=1,
                                   n_z=8),
                     dict(dt=1e-3, theta=0.501, rho_f=1.025e3, mu_f=3.5e-3,
                          rho_s=1e3, mu_s=3.45e5, lambda_s=3.1e6,
                          quadrature_degree=6, device="cuda"))
    sp = sysm.space
    bcs = [DirichletBC(sp.field_dofs("d", sp.p2_dofs_on_facets(m)), 0.0)
           for m in (2, 3, 11)]
    bcs += [DirichletBC(sp.field_dofs("v", sp.p2_dofs_on_facets(m)), 0.0)
            for m in (2, 11)]
    Z = sysm.zero_state()
    return sysm, sysm.make_bcset(bcs), Z


def full_tube():
    """chip_smoke.py phase 2's system and the state of its first rebuild."""
    system, bc, _, _ = chip_smoke.build_system(chip_smoke.FULL_MESH, "cuda",
                                               seed=0)
    return system, bc, bc.apply(system.zero_state(), 1e-3)


def cdb(system, bc, U1):
    """The Ruiz-scaled float32 C/D/B of the system's Jacobians at U1."""
    asm = system.assembler
    mask = bc.mask_on("cuda")
    Z = system.zero_state()
    jacs = asm.element_jacobians(U1, Z, dtype=torch.float32)
    dr, dc = ruiz_scales(asm.blocks, jacs, mask, asm.ndof, sweeps=4)
    jf = [ks.ruiz_scale_cuda(A, b.dofs, dr, dc)
          for b, A in zip(asm.blocks, jacs)]
    del jacs
    block_dofs = [b.dofs.cpu().numpy() for b in asm.blocks]
    pat = fb.build_banded_pattern(block_dofs, asm.ndof)
    plans = fb.plans_to_device(
        fb.build_banded_assembly_plan(block_dofs, pat, bc.mask), "cuda")
    diag = torch.as_tensor(fb.identity_diag_slots(pat, bc.mask),
                           device="cuda")
    return kb.assemble_cuda(jf, plans, pat.nb, pat.c, diag), pat


def storages(Ck, Dk, Bk):
    """(name, (Sinv, H, G)) in each K21a storage instance."""
    Sinv, H, G, _ = fb.factorize_banded(Ck, Dk, Bk)
    yield "f32", (Sinv, H, G)
    yield "hybrid", (Sinv, H.to(BF), G.to(BF))
    del Sinv, H, G
    torch.cuda.empty_cache()
    yield "bf16", fb.factorize_banded(Ck, Dk, Bk, BF)[:3]


def rel(x, ref):
    return float((x.double() - ref).norm() / ref.norm())


def stage_readings(F, seeds):
    """Per stage, per span and seed: (kernel err, plain err) against the
    float64 stage on the same float32 inputs."""
    nb, c = F[0].shape[0], F[0].shape[1]
    m = nb // 2
    spans = [tuple(M[:m] for M in F), tuple(M[m:] for M in F)]
    out = {s: [] for s in STAGES}
    for seed in range(seeds):
        a = torch.as_tensor(np.random.default_rng(seed).normal(size=(nb, c)),
                            dtype=torch.float32, device="cuda")
        halves = (a[:m], a[m:])
        # the stages' float32 inputs and carries, by the plain composition
        t = [kb.carry_stage_plain(*Fi, "times", ai)
             for Fi, ai in zip(spans, halves)]
        w0 = kb.carry_stage_plain(*spans[0], "forward", t[0])
        w_in = w0[-1]
        w1 = kb.carry_stage_plain(*spans[1], "forward", t[1], w_in)
        x_in = kb.carry_stage_plain(*spans[1], "backward", w1)[0]
        for k, Fk in enumerate(spans):
            w = (w0, w1)[k]
            cases = {"times": ("times", halves[k], None),
                     "forward_zero": ("forward", t[k], None),
                     "forward_carry": ("forward", t[k], w_in),
                     "backward_zero": ("backward", w, None),
                     "backward_carry": ("backward", w, x_in)}
            for name, (stage, inp, carry) in cases.items():
                yk = kb.carry_stage_cuda(*Fk, stage, inp, carry)
                yp = kb.carry_stage_plain(*Fk, stage, inp, carry)
                ref = kb.carry_stage_plain(
                    *Fk, stage, inp.double(),
                    None if carry is None else carry.double())
                out[name].append((rel(yk, ref), rel(yp, ref)))
    return out


def main():
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dest = Path(sys.argv[2] if len(sys.argv) > 2
                else "carry_stage_readings.json")
    name = torch.cuda.get_device_name(0)
    print(f"{name}; {seeds} seeds; per stage: the largest kernel/plain "
          f"ratio of the distances to float64, the kernel's largest "
          f"distance, the plain version's smallest")
    result = {}
    for label, make in (("small_tube", small_tube), ("tube_20832",
                                                     full_tube)):
        system, bc, U1 = make()
        (Ck, Dk, Bk), pat = cdb(system, bc, U1)
        del system
        for storage, F in storages(Ck, Dk, Bk):
            rd = stage_readings(F, seeds)
            del F
            key = f"{label}/{storage}"
            result[key] = dict(nb=pat.nb, c=pat.c, readings=rd)
            for s, pairs in rd.items():
                ratios = [k / max(p, 1e-300) for k, p in pairs]
                print(f"  {key:22s} {s:15s} ratio max {max(ratios):.3f} "
                      f"mean {np.mean(ratios):.3f}; kernel max "
                      f"{max(k for k, _ in pairs):.3e}, plain min "
                      f"{min(p for _, p in pairs):.3e}")
        del Ck, Dk, Bk
        torch.cuda.empty_cache()
    worst = max(k / max(p, 1e-300) for v in result.values()
                for pairs in v["readings"].values() for k, p in pairs)
    print(f"largest ratio over every stage, instance, span and seed: "
          f"{worst:.3f}")
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(dict(device=name, seeds=seeds,
                                    largest_ratio=worst, result=result)))


if __name__ == "__main__":
    main()
