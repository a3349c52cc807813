"""Build ``csrc/*.cu`` with nvcc at first use and bind it through ctypes.

Each source is compiled to an object by its own nvcc process, all started
together, and the objects are linked into one shared library. The library
is named by a hash of the sources, the headers (``csrc/*.cuh``) and the
flags and lives in ``swmhd_tpu_torch/_build/`` (not committed), so a
fresh checkout builds it on the first kernel call and later processes
reuse it. A missing nvcc or a failed build raises with the compiler's
output.
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

from .. import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
BOTH = ("f32", "f64")
# name -> (argtypes, the suffixes it is defined with; () for the bare name)
_SIGNATURES = {
    # s_in, g_prev, s_out, g_out, nx, ny, hx, hy, in_row, in_plane,
    # out_row, out_plane, conservative, mode_x, mode_y, closure, momentum,
    # mass, tracer, stencil, tile_x, dx, dy, g, f, A_bg_grad_y, nu, kappa,
    # dt, gamma_k, zeta_k, stream
    "swmhd_substage": ([_P] * 4 + [_I] * 4 + [_L] * 4 + [_I] * 9
                       + [_D] * 10 + [_P], BOTH),
    # s_in, s_out, work, gbuf, nx, ny, conservative, wall_x, wall_y,
    # closure, momentum, mass, tracer, stencil, tile_x, dx, dy, g, f,
    # A_bg_grad_y, nu, kappa, dt, n_steps, sms, stream: the resident kernel
    "swmhd_multistep": ([_P] * 4 + [_I] * 11 + [_D] * 8 + [_I, _I, _P],
                        BOTH),
    # conservative, mode_x, mode_y, opt, tile_x, biharmonic, out: the tile
    # kernel's shared memory a block, registers, blocks an SM
    "swmhd_tile_info": ([_I] * 6 + [_P], BOTH),
    # conservative, mode_x, mode_y, opt, tile_x, biharmonic, tiles, sms,
    # out: the resident kernel's shared memory a block, registers, blocks
    # an SM and grid
    "swmhd_resident_info": ([_I] * 8 + [_P], BOTH),
    # (tile.cu) the card's opt-in shared memory per block
    "swmhd_smem_limit": ([], ()),
    # x_padded, out, nx, ny, tx, ty, hx, hy, async, branch, p, box_rows,
    # box_cols, stream
    "swmhd_window_probe": ([_P] * 2 + [_I] * 11 + [_P], ("f32",)),
    # x_padded, out, n, m, tx, h, case, branch, p, box_rows, box_cols,
    # stream
    "swmhd_wrap_probe": ([_P] * 2 + [_I] * 9 + [_P], ("f32",)),
    # s, out, nx, ny, tx, ty, halo, split, dx, dy, g, f, stream
    "swmhd_tendency_tile": ([_P] * 2 + [_I] * 6 + [_D] * 4 + [_P], BOTH),
    # tx, ty, halo, split, out: the tile tendency kernel's shared memory a
    # block, registers, blocks an SM
    "swmhd_tendency_tile_info": ([_I] * 4 + [_P], BOTH),
    # h, u, v, A, h0, out, scratch, nx, ny, rows, conservative, mode_x,
    # mode_y, dx, dy, lx, ly, g, A_bg_grad_y, stream: the energy series
    "swmhd_energy_series": ([_P] * 7 + [_I] * 6 + [_D] * 6 + [_P], BOTH),
}


class Library:
    """The loaded kernels plus what the build took and said."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds
        self.log = log
        self._lib = ctypes.CDLL(path)
        for name, (argtypes, suffixes) in _SIGNATURES.items():
            for symbol in ([f"{name}_{s}" for s in suffixes] or [name]):
                fn = getattr(self._lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int

    def fn(self, name: str, suffix: str = ""):
        return getattr(self._lib, f"{name}_{suffix}" if suffix else name)


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


def _run_all(cmds):
    """Run the commands concurrently; ``[(returncode, output), ...]``."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def load() -> Library:
    """Build (if needed) and load the kernel library."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    key = digest.hexdigest()[:16]
    if key in _LOADED:
        return _LOADED[key]
    with tracing.span("library_load", setup=True):
        return _build_and_load(key, sources)


def _build_and_load(key, sources) -> Library:
    """The library of hash ``key``, built from ``sources`` where
    ``BUILD_DIR`` lacks it, loaded and kept in ``_LOADED``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = os.path.join(BUILD_DIR, f"libswmhd_{key}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(target):
        nvcc = _nvcc()
        work = tempfile.mkdtemp(dir=BUILD_DIR)
        try:
            objs = [os.path.join(work, os.path.basename(src) + ".o")
                    for src in sources]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                    for src, obj in zip(sources, objs)]
            tmp = os.path.join(work, "lib.so")
            link = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *objs]
            t0 = time.perf_counter()
            results = _run_all(cmds)
            if all(rc == 0 for rc, _ in results):
                results += _run_all([link])
                cmds.append(link)
            seconds = time.perf_counter() - t0
            log = "".join(out for _, out in results)
            for cmd, (rc, out) in zip(cmds, results):
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): "
                                       f"{' '.join(cmd)}\n{out}")
            os.replace(tmp, target)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = _LOADED[key] = Library(target, seconds, log)
    return lib
