"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

nvcc compiles the sources into build/vasp_tpu_torch/ at the checkout's root
at first use, and again whenever a source or flag changes (the library's
name carries a hash of both): one nvcc process per source, all started
together, then one link. The library has a plain C interface bound with
ctypes: nothing here includes PyTorch's headers, so a cold build takes
seconds. Nothing is imported or built when this module is imported.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vasp_tpu_torch"
SOURCES = ("element_kernels.cu", "measures.cu", "matvec.cu", "ruiz.cu",
           "banded.cu", "facet_kernels.cu", "postproc.cu", "lifting.cu",
           "ras.cu", "schwarz.cu", "nodeblock.cu", "delta_kernels.cu")
HEADERS = ("element_forms.cuh",)
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# one count per kernel (per local size for K4 and K7: the _36 instances
# serve the Robin facet blocks; per material for the solid's K2/K3 and
# for K20b: the _mr instances are the Mooney-Rivlin ones; per mesh
# lifting for the fluid's K1/K3: the _elastic and _nolift instances; per
# dtype for K16, K7's sweep and scale, and K18; per storage instance for K6 and K12;
# per local size for K22's build and apply, with its divide apart; K17's
# extract, invert and apply; K13 per form, delta or delta2, and per
# lifting and material as K1/K2, its facet route as robin_delta(2); K21a
# per storage instance as K6, its chain carry update apart),
# bumped by its wrapper right where it launches
LAUNCHES = dict.fromkeys(
    ("fluid_residual", "solid_residual", "fluid_residual_f32",
     "solid_residual_f32", "fluid_jacobian", "solid_jacobian",
     "fluid_jacobian_f32", "solid_jacobian_f32", "fluid_residual_elastic",
     "fluid_residual_elastic_f32", "fluid_jacobian_elastic",
     "fluid_jacobian_elastic_f32", "fluid_residual_nolift",
     "fluid_residual_nolift_f32", "fluid_jacobian_nolift",
     "fluid_jacobian_nolift_f32", "lift_correction", "lift_correction_f32",
     "solid_residual_mr",
     "solid_residual_mr_f32", "solid_jacobian_mr", "solid_jacobian_mr_f32",
     "dg0_project_speed",
     "integrate_p2_dot_n", "dg0_project_jacobian", "elem_matvec",
     "ruiz_sweep", "ruiz_scale", "banded_assemble", "banded_apply",
     "banded_factorize_f64", "robin_residual", "robin_residual_f32",
     "robin_jacobian", "robin_jacobian_f32", "elem_matvec_36",
     "ruiz_sweep_36", "ruiz_scale_36", "wss_load", "stress_strain_svk",
     "stress_strain_mr", "max_eig", "spectral_power", "banded_apply_hybrid",
     "banded_apply_bf16", "banded_apply_lowmem_bf16",
     "banded_apply_lowmem_f32", "ruiz_sweep_f64", "ruiz_sweep_36_f64",
     "ras_apply", "ras_apply_f32", "schwarz_build", "schwarz_build_36",
     "schwarz_apply", "schwarz_apply_36", "schwarz_divide",
     "node_block_extract", "node_block_invert", "node_block_apply",
     "ruiz_scale_f64", "ruiz_scale_36_f64", "fluid_delta", "fluid_delta2",
     "fluid_delta_elastic", "fluid_delta2_elastic", "fluid_delta_nolift",
     "fluid_delta2_nolift", "solid_delta", "solid_delta2", "solid_delta_mr",
     "solid_delta2_mr", "robin_delta", "robin_delta2", "banded_carry",
     "banded_carry_hybrid", "banded_carry_bf16", "banded_carry_update",
     "banded_tri_residual"), 0)

# seconds the last build took in this process (0.0 when the library was
# already built)
BUILD_SECONDS = {"nvcc": 0.0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of vasp_tpu_torch "
                           "need the CUDA toolkit to build")
    return path


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library():
    """The loaded ctypes library, built first if its hash is new."""
    so = BUILD_DIR / f"libvasp_tpu_torch_{_source_hash()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{_source_hash()}.{os.getpid()}"
        objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
        tic = time.perf_counter()
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if not failed:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [_nvcc(), *GENCODE, "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["link"]
        BUILD_SECONDS["nvcc"] = time.perf_counter() - tic
        (BUILD_DIR / "nvcc.log").write_text(log)
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log[-4000:]}")
        os.replace(tmp, so)
    return _bind(ctypes.CDLL(str(so)))


def _bind(lib):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    L = ctypes.c_int64
    sigs = {
        "vt_element_nq_max": [],
        "vt_element_nq_max_f32": [],
        "vt_set_element_tables": [P, P, P, P, I],
        "vt_fluid_residual": [P] * 8 + [I, I, I, D, D, D, D, D, I, I, D, P],
        "vt_fluid_jacobian": [P] * 8 + [I, I, I, D, D, D, D, D, I, I, D, P],
        "vt_solid_residual": [P] * 8 + [I, I, I, D, D, D, D, D, I] + [D] * 6
        + [P],
        "vt_solid_jacobian": [P] * 8 + [I, I, I, D, D, D, D, D, I] + [D] * 6
        + [P],
        "vt_dg0_project_speed": [P, P, P, P, I, D, P, I, P],
        "vt_integrate_p2_dot_n": [P, P, P, P, P, P, I, I, P, P],
        "vt_dg0_project_jacobian": [P] * 5 + [I, P, I, P],
        "vt_elem_matvec": [P, I, P, P, P, I, I, I, P],
        "vt_ruiz_sweep": [P] * 7 + [I, I, I, P],
        "vt_ruiz_scale": [P] * 5 + [I, I, I, P],
        "vt_robin_residual": [P] * 5 + [I, P, I, I, D, D, P],
        "vt_robin_jacobian": [P] * 3 + [I, P, I, I, D, D, P],
        "vt_banded_segsum": [P, P, P, P, I, I, P, P],
        "vt_banded_solve": [P] * 5 + [I, I, I, I, P],
        "vt_banded_solve_lowmem": [P] * 6 + [I, I, I, P],
        "vt_banded_carry": [P] * 4 + [I] * 5 + [P],
        "vt_banded_carry_update": [P] * 4 + [I, P],
        "vt_banded_tri_residual": [P] * 8 + [I, I, P],
        "vt_banded_permute": [P, I, P, I, I, P, P],
        "vt_banded_unpermute": [P, P, I, P, I, P],
        "vt_wss_load": [P] * 9 + [I, I, I, L, I, D, P],
        "vt_stress_strain": [P, P, P, I, D, D, D, D, D, P, P, P, P, I, I, I,
                             I, L, P],
        "vt_max_eig": [P, P, L, P],
        "vt_spectral_power": [P, P, I, I, I, D, I, P],
        "vt_lift_correction": [P] * 6 + [D, D, P, P, I, I, I, L, P],
        "vt_ras_apply": [P] * 5 + [I, I, L, I, I, P],
        "vt_schwarz_build": [P, P, P, D, P, P, I, I, P],
        "vt_schwarz_apply": [P] * 4 + [I, I, P],
        "vt_schwarz_divide": [P, P, L, P],
        "vt_node_block_extract": [P, P, I, I, P, P],
        "vt_node_block_invert": [P, P, L, P, P],
        "vt_node_block_apply": [P, P, L, L, L, P, P],
        "vt_delta_nq_max": [],
        "vt_set_delta_tables": [P, P, P, P, I],
        "vt_fluid_delta": [P] * 10 + [I, I, I, D, D, D, D, D, I, I, D, P],
        "vt_solid_delta": [P] * 10 + [I, I, I, D, D, D, D, D, I] + [D] * 6
        + [P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err, what):
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device):
    """The current stream of `device`, the one every launch goes to. CUDA
    refuses a launch on a stream of another card than the current one:
    raise, naming the fix, before it would."""
    device = torch.device(device)
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(
            f"a kernel launch on {device} while cuda:{current} is the "
            f"current card: call torch.cuda.set_device({device.index}) first")
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t):
    """Device pointer of a tensor, NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def on_cuda(t, what):
    """The dispatch rule of every kernel: False for a CPU tensor (the plain
    version runs), True for a CUDA tensor (the kernel launches or raises),
    ValueError for any other device."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type == "cuda"
    raise ValueError(f"no {what} kernel for device {t.device}")


def require(t, name, dtype, shape, device):
    """The checks a raw pointer cannot make: device, dtype, shape and
    contiguity of every tensor handed to a kernel."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: kernel needs a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
