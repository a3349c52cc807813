"""Build ``csrc/*.cu`` with nvcc at first use and bind it through ctypes.

The shared library is named by a hash of the sources and the flags and
lives in ``swmhd_tpu_torch/_build/`` (not committed), so a fresh checkout
builds it on the first kernel call and later processes reuse it. A
missing nvcc or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # s_in, g_prev, s_out, g_out, tmp, nx, ny,
    # dx, dy, g, f, A_bg_grad_y, dt, gamma_k, zeta_k, stream
    "swmhd_substage": [_P] * 5 + [_I] * 2 + [_D] * 8 + [_P],
    # s_in, s_out, work, gbuf, tmp, nx, ny,
    # dx, dy, g, f, A_bg_grad_y, dt, n_steps, stream
    "swmhd_multistep": [_P] * 5 + [_I] * 2 + [_D] * 6 + [_I, _P],
}


class Library:
    """The loaded kernels plus what the build took and said."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds
        self.log = log
        self._lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(self._lib, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int

    def fn(self, name: str, suffix: str):
        return getattr(self._lib, f"{name}_{suffix}")


_LOADED = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels of "
                           "swmhd_tpu_torch cannot be built")
    return path


def load() -> Library:
    """Build (if needed) and load the kernel library."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    key = digest.hexdigest()[:16]
    if key in _LOADED:
        return _LOADED[key]
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = os.path.join(BUILD_DIR, f"libswmhd_{key}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(target):
        nvcc = _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, target)
    lib = _LOADED[key] = Library(target, seconds, log)
    return lib
