"""The tile-tendency probe (csrc/tendency_tile.cuh) built for the host and
held bit for bit to the plain emulation of the vector-invariant
substage's tiling, on the CPU.

``tests/host_build/tile_host.cpp`` compiles the probe's kernel with g++
(``-std=c++20``, no fma contraction) against the stand-in CUDA headers
beside it, as ``test_torch_vi_tile_host.py`` does the substage: each block
runs on 256 host threads that meet at a barrier for every
``__syncthreads``, its shared memory filled with 0xff bytes first, so a
slot read before the kernel writes it is a NaN and shows in G. The probe
runs the substage's own phases, so its output must equal G of
:func:`~swmhd_tpu_torch.ops.vi_tile.substage_tiles_reference` at the same
tiles (the split's rows of it) bit for bit, and be finite: float32 and
float64, every split, 32×32, 16×64 and 64×16 tiles on a 64² grid and
16×8 on 32², halos 3 and 8. Skips where no g++ builds C++20.
"""

import ctypes
import functools
import os
import subprocess

import pytest
import torch

from swmhd_tpu_torch.ops import tile as T
from swmhd_tpu_torch.ops.substage import kernel_params
from swmhd_tpu_torch.ops.vi_tile import substage_tiles_reference
from swmhd_tpu_torch.probes import build
from test_torch_vi_tile_host import CSRC, DT, SHIM, _gxx, assert_bitwise

torch.set_num_threads(1)

TILE_CASES = [(64, (32, 32)), (64, (16, 64)), (64, (64, 16)), (32, (16, 8))]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``tile_host_tendency`` of the host build, by dtype."""
    out = tmp_path_factory.mktemp("tile_host") / "tile_host.so"
    built = subprocess.run(
        [_gxx(), "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
         "-fPIC", "-pthread", "-I", SHIM, "-I", CSRC,
         os.path.join(SHIM, "tile_host.cpp"), "-o", str(out)],
        capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"tile_host_tendency_{suffix}")
        fn.argtypes = [P] * 2 + [I] * 6 + [D] * 4
        fn.restype = I
        fns[dtype] = fn
    return fns


@functools.lru_cache(maxsize=None)
def case(N, dtype, tile):
    """The bench.py model and state at N², and G of the emulated
    substage at ``tile``."""
    model, st = build(N, dtype, "cpu")
    s = torch.stack(st.fields())
    return model, s, substage_tiles_reference(model, s, DT, 0, tile=tile)[1]


def run(host, model, s, tile, halo, split):
    """The split's G through the host build."""
    p = kernel_params(model)
    N = s.shape[1]
    out = torch.empty((len(T.SPLIT_FIELDS[split]), N, N), dtype=s.dtype)
    err = host[s.dtype](s.data_ptr(), out.data_ptr(), N, N, *tile, halo,
                        T.SPLITS.index(split), p.dx, p.dy, p.g, p.f)
    assert err == 0
    return out


@pytest.mark.parametrize("split", T.SPLITS)
@pytest.mark.parametrize("halo", [3, 8])
@pytest.mark.parametrize("N,tile", TILE_CASES,
                         ids=[f"{N}-{t[0]}x{t[1]}" for N, t in TILE_CASES])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_host_probe_matches_the_substage_emulation_bitwise(host, dtype, N,
                                                           tile, halo,
                                                           split):
    model, s, G = case(N, dtype, tile)
    got = run(host, model, s, tile, halo, split)
    assert_bitwise(got, G[list(T.SPLIT_FIELDS[split])])


REFUSED = {"columns 4": (32, (16, 4), 3, 0), "rows 128": (128, (128, 8), 3, 0),
           "halo 2": (32, (16, 8), 2, 0), "split 3": (32, (16, 8), 3, 3)}


@pytest.mark.parametrize("refused", sorted(REFUSED))
def test_host_probe_refuses_what_the_kernel_does_not_take(host, refused):
    """Tile columns outside 8, 16, 32, 64, more than 64 rows, a halo
    under 3, an unknown split."""
    N, tile, halo, split = REFUSED[refused]
    s = torch.zeros((4, N, N), dtype=torch.float64)
    out = torch.empty_like(s)
    assert host[torch.float64](s.data_ptr(), out.data_ptr(), N, N, *tile,
                               halo, split, 0.1, 0.1, 9.81, 1.0) != 0
