"""Build and load the package's hand-written CUDA kernels.

Every ``muse_tpu_torch/csrc/*.cu`` file exposes a plain C interface. At
first use, ``nvcc`` compiles them together for Hopper (``sm_90a``) into one
shared library under ``muse_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the sources and the flags, and ``ctypes`` loads it. A
later process with the same sources loads the cached library. Pointers and
the stream cross the boundary as ``c_void_p``; every entry point returns
``cudaGetLastError()``, and the caller raises if it is not 0.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_library", "CSRC_DIR", "BUILD_DIR"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of muse_tpu_torch are built at first use and need "
        "the CUDA toolkit")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def build_library() -> dict:
    """Compile the kernels if no library for these sources exists yet.

    Returns ``{"path", "seconds", "cached", "log"}``: the library's path,
    the compile time (0 when cached), and nvcc's output (the ``-Xptxas -v``
    register and shared-memory report)."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib_path = BUILD_DIR / f"libmuse_kernels-{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return {"path": str(lib_path), "seconds": 0.0, "cached": True,
                "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib_path)        # atomic: concurrent builders agree
    return {"path": str(lib_path), "seconds": seconds, "cached": False,
            "log": log}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call in this process."""
    lib = ctypes.CDLL(build_library()["path"])
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.muse_spectrum_quadform_slab.argtypes = []
    lib.muse_spectrum_quadform_slab.restype = ll
    lib.muse_spectrum_quadforms_max_weights.argtypes = []
    lib.muse_spectrum_quadforms_max_weights.restype = ctypes.c_int
    lib.muse_spectrum_quadforms_f32.argtypes = [vp, vp, vp, vp, ll,
                                                ctypes.c_int, ll,
                                                ctypes.c_int, vp]
    lib.muse_spectrum_quadforms_f32.restype = ctypes.c_int
    lib.muse_spectrum_quadform_and_grad_f32.argtypes = [vp, vp, vp, vp, vp,
                                                        ll, ll, ctypes.c_int,
                                                        vp]
    lib.muse_spectrum_quadform_and_grad_f32.restype = ctypes.c_int
    ci = ctypes.c_int
    lib.muse_herm_white_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ci,
                                        ll, ci, ci, ci, ll, ll, vp]
    lib.muse_herm_white_f32.restype = ci
    lib.muse_lens_slab.argtypes = []
    lib.muse_lens_slab.restype = ll
    for name in ("muse_lens_expand_f32", "muse_lens_contract_f32"):
        getattr(lib, name).argtypes = [vp, vp, vp, vp, vp, ll, ci, vp]
        getattr(lib, name).restype = ci
    lib.muse_lens_combine_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ci,
                                          vp]
    lib.muse_lens_combine_f32.restype = ci
    lib.muse_lens_spread_f32.argtypes = [vp, vp, vp, ll, ci, vp]
    lib.muse_lens_spread_f32.restype = ci
    fl = ctypes.c_float
    lib.muse_diag_pcg_slab.argtypes = []
    lib.muse_diag_pcg_slab.restype = ll
    lib.muse_diag_pcg_start_f32.argtypes = [vp, vp, fl, vp, vp, vp, vp, vp,
                                            ll, ll, ci, vp]
    lib.muse_diag_pcg_update_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                             vp, ll, ll, ci, vp]
    lib.muse_diag_pcg_direction_f32.argtypes = [vp, vp, vp, vp, vp, ll, ll,
                                                ci, vp]
    lib.muse_diag_pcg_finalize_f32.argtypes = [ci, vp, ci, vp, fl, vp, vp, vp,
                                               vp, vp, vp, vp, ll, vp]
    for name in ("start", "update", "direction", "finalize"):
        getattr(lib, f"muse_diag_pcg_{name}_f32").restype = ci
    return lib
