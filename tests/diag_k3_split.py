"""Where K3's time goes: the point-linearised element Jacobian
(csrc/element_kernels.cu) timed with one of its steps left out, on the
20,832-cell tube's fluid and solid blocks (float32 output, seeded state).

On a machine with a card, from the root of a checkout:

    python3 tests/diag_k3_split.py

Each variant is element_kernels.cu (with element_forms.cuh) edited in a
temporary directory and built by nvcc into a library of its own:
- kernel: as it is;
- no_flux: step 3 (D_q, the Dual evaluations of the point flux) left out;
- no_contraction: step 4 (the contraction into registers) left out;
- steps_1_2: both left out (the basis, the point states, the previous
  state's terms and the write remain);
- steps_1_2_no_old: that, without the previous state's terms;
- two_quotients: Dual division by two quotients, not one reciprocal.
The variants that leave out a step compute garbage; only their times
count. Each is timed with CUDA events (10 launches after a warm-up) in two
rounds, the second in reverse order, with ptxas's registers and spills."""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NO_FLUX = [("    if (t < nc * NS) {\n      const int c = t / NS;\n      Dual s",
            "    if (false) {\n      const int c = t / NS;\n      Dual s")]
NO_CONTRACTION = [
    ("    if (t < kBlockItems) {\n      contract_blocks",
     "    if (false) {\n      contract_blocks"),
    ("    } else if (u < kPColItems) {\n      if (u < 6)\n        contract_pcol",
     "    } else if (false) {\n      if (u < 6)\n        contract_pcol"),
    ("    } else if (v < kPRowItems) {\n      if (v < 6)\n        contract_prow",
     "    } else if (false) {\n      if (v < 6)\n        contract_prow")]
NO_OLD = [("    if (t < nc) *reinterpret_cast<Old*>(s_old + t * kOld) = "
           "old_terms(C, s_st0 + t * kRow);", "")]
TWO_QUOTIENTS = [("""__device__ inline Dual operator/(Dual a, Dual b) {
  const double r = 1.0 / b.v, q = a.v * r;
  return Dual(q, (a.d - q * b.d) * r);
}
__device__ inline Dual operator/(Dual a, double b) {
  const double r = 1.0 / b;
  return Dual(a.v * r, a.d * r);
}
__device__ inline Dual operator/(double a, Dual b) {
  const double r = 1.0 / b.v, q = a * r;
  return Dual(q, -q * b.d * r);
}""", """__device__ inline Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ inline Dual operator/(Dual a, double b) { return Dual(a.v / b, a.d / b); }
__device__ inline Dual operator/(double a, Dual b) {
  const double q = a / b.v;
  return Dual(q, -q * b.d / b.v);
}""")]
# variant -> (edits of element_kernels.cu, edits of element_forms.cuh)
VARIANTS = {
    "kernel": ([], []),
    "no_flux": (NO_FLUX, []),
    "no_contraction": (NO_CONTRACTION, []),
    "steps_1_2": (NO_FLUX + NO_CONTRACTION, []),
    "steps_1_2_no_old": (NO_FLUX + NO_CONTRACTION + NO_OLD, []),
    "two_quotients": ([], TWO_QUOTIENTS),
}


def _edit(text, edits, what):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{what}: the text to edit is not in the source")
        text = text.replace(old, new)
    return text


def build(tmp):
    """{variant: (library path, ptxas report)}, built in parallel."""
    from vasp_tpu_torch.kernels import build as kbuild

    src = ROOT / "vasp_tpu_torch" / "csrc"
    procs = {}
    for name, (k_edits, f_edits) in VARIANTS.items():
        d = tmp / name
        d.mkdir()
        (d / "element_kernels.cu").write_text(_edit(
            (src / "element_kernels.cu").read_text(), k_edits, name))
        (d / "element_forms.cuh").write_text(_edit(
            (src / "element_forms.cuh").read_text(), f_edits, name))
        for f in ("element_residual.cuh", "element_global.cu"):
            (d / f).write_text((src / f).read_text())
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "element_kernels.cu"),
             str(d / "element_global.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        out[name] = (tmp / name / "lib.so", log)
    return out


class _Lib:
    """The variant's library, with placeholders for the entry points of
    the port's other sources, so that build._bind can declare them all."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            stub = type("Stub", (), {})()
            setattr(self, name, stub)
            return stub


def main():
    import torch

    import chip_smoke as cs
    from vasp_tpu_torch.kernels import build as kbuild
    from vasp_tpu_torch.kernels import element

    with tempfile.TemporaryDirectory(prefix="k3_split_") as tmp:
        libs = build(Path(tmp))
        bound = {}
        for name, (path, log) in libs.items():
            ptx = cs.jacobian_ptxas(log)
            print(f"{name}: " + ", ".join(
                f"{k} {v['registers']} registers, {v['spill_stores']} bytes "
                f"spill stores" for k, v in ptx.items()
                if k in ("fluid_jacobian_f32", "solid_jacobian_f32")))
            bound[name] = kbuild._bind(_Lib(ctypes.CDLL(str(path))))
        system, _, U, U0 = cs.build_system(cs.FULL_MESH, "cuda", seed=0)
        order = list(VARIANTS)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                kbuild.library = lambda name=name: bound[name]
                for b in system.assembler.blocks:
                    ms = cs.cuda_ms(lambda: element.jacobian_cuda(
                        b, U, U0, torch.float32), 10)
                    print(f"round {rnd} {name:18s} {b.name:8s} "
                          f"K={b.dofs.shape[0]} {ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
