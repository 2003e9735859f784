"""Host-side native code of the port: the RCM ordering (rcm.cpp).

g++ builds rcm.cpp into build/vasp_tpu_torch/ at the checkout's root at
first use, under a name that carries a hash of the source and flags. The
flags are vasp_tpu/native/Makefile's without -march=native, so the built
library runs on any x86-64 host that shares the checkout (the ordering
does not depend on them). As in vasp_tpu/native, a host without g++ gets
None back and the caller falls back to scipy's RCM; a build that was
started and failed or timed out raises with the compiler's output, since
a quiet fallback would give this process another ordering (and another
band width) than every other.
"""
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "rcm.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vasp_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded library, or None where it cannot be built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes())
    so = BUILD_DIR / f"librcm_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, text=True,
                           timeout=600)
        except FileNotFoundError:
            return None
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {_SRC.name} "
                               f"(exit {e.returncode}):\n{e.stderr}") from e
        except subprocess.TimeoutExpired as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ timed out after {e.timeout} s building "
                               f"{_SRC.name}:\n{e.stderr or ''}") from e
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.vt_rcm_order.restype = None
    lib.vt_rcm_order.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
    return lib


def rcm_order(indptr, indices, n):
    """RCM permutation (n,) int64 of the CSR graph, or None without g++."""
    lib = _library()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    perm = np.empty(n, np.int64)
    lib.vt_rcm_order(indptr, indices, int(n), perm)
    return perm
