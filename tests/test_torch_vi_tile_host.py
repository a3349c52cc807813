"""The vector-invariant tile kernel (csrc/vi_tile.cuh) built for the host
and held bit for bit to its plain emulation, on the CPU.

``tests/host_build/vi_host.cpp`` compiles the kernel with g++
(``-std=c++20``, no fma contraction) against the stand-in CUDA headers
beside it: each block runs on 256 host threads that meet at a barrier
for every ``__syncthreads``, its shared memory filled with 0xff bytes
first, so a slot read before the kernel writes it (an intermediate
outside its region, a slot past a wall) is a NaN and shows in G. Through
ctypes on CPU tensors, G and the new state of substages 0 and 1 must
equal :func:`~swmhd_tpu_torch.ops.vi_tile.substage_tiles_reference` bit
for bit and be finite, in float64 and float32, for every pair of axis
modes and every model option, at 32² and 40² (ragged tiles); and halo
tiles at halos 3, 6 and 7 must equal the whole grid bit for bit. The card
compiles with fma contraction, so there kernel and plain differ by a few
ulps; this checks the logic: index maps, regions, wall reads, order of
operations. Skips where no g++ builds C++20.
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from swmhd_tpu_torch.models.shallow_water import RK3_GAMMA, RK3_ZETA
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.ops.vi_tile import substage_tiles_reference
from chip_smoke import (OPTIONS, VI, cut_tile, tile_layout, wall_model,
                        with_options)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SHIM = os.path.join(HERE, "host_build")
CSRC = os.path.join(os.path.dirname(HERE), "swmhd_tpu_torch", "csrc")
DT = 0.005
TOPOLOGIES = {"periodic": (("periodic", "periodic"), 0.0),
              "bounded y": (("periodic", "bounded"), -0.05),
              "bounded x": (("bounded", "periodic"), -0.05),
              "bounded xy": (("bounded", "bounded"), -0.05)}


def _gxx():
    """g++ if it compiles C++20 (``<barrier>``), else skip."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel for the host")
    probe = subprocess.run(
        [gxx, "-std=c++20", "-fsyntax-only", "-x", "c++", "-"],
        input="#include <barrier>\nstd::barrier<> b(1);\n", text=True,
        capture_output=True)
    if probe.returncode != 0:
        pytest.skip("needs a g++ with -std=c++20 and <barrier>")
    return gxx


def compile_host(tmp_path_factory, name):
    """``tests/host_build/<name>.cpp`` built with g++, loaded."""
    out = tmp_path_factory.mktemp(name) / f"{name}.so"
    build = subprocess.run(
        [_gxx(), "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
         "-fPIC", "-pthread", "-I", SHIM, "-I", CSRC,
         os.path.join(SHIM, f"{name}.cpp"), "-o", str(out)],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr[-4000:]
    return ctypes.CDLL(str(out))


def build_host(tmp_path_factory, name, lib=None):
    """The two entry points of ``tests/host_build/<name>.cpp`` built with
    g++ (or of ``lib``, that build loaded), by dtype."""
    lib = lib or compile_host(tmp_path_factory, name)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"{name}_substage_{suffix}")
        fn.argtypes = [P] * 4 + [I] * 12 + [D] * 10
        fn.restype = I
        fns[dtype] = fn
    return fns


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build's two entry points, by dtype."""
    return build_host(tmp_path_factory, "vi_host")


def run(host, model, s, stage, g_prev=None, halo=(0, 0), tile=(8, 32)):
    """Substage ``stage`` through the host build: ``(s_new, G)``."""
    p = K.kernel_params(model)
    hx, hy = halo
    shape = (4, s.shape[1] - 2 * hx, s.shape[2] - 2 * hy)
    s_out = torch.empty(shape, dtype=s.dtype)
    g_out = torch.empty_like(s_out)
    err = host[s.dtype](
        s.data_ptr(), None if g_prev is None else g_prev.data_ptr(),
        s_out.data_ptr(), g_out.data_ptr(), *shape[1:], hx, hy,
        K.EXCHANGED_AXIS if hx else p.wall_x,
        K.EXCHANGED_AXIS if hy else p.wall_y, *p[3:8], tile[0], *p[8:],
        DT, RK3_GAMMA[stage], RK3_ZETA[stage])
    assert err == 0
    return s_out, g_out


def model_and_state(N, topo, options, dtype, formulation=VI):
    topology, gamma = TOPOLOGIES[topo]
    model, state = wall_model(N, dtype, "cpu", formulation, topology, gamma)
    return with_options(model, options, DT), K.stack(state)


def assert_bitwise(got, want):
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), \
        f"{(got - want).abs().max().item():.3e} off"


@pytest.mark.parametrize("N,tile", [(32, (8, 32)), (40, (16, 32))],
                         ids=["32-8x32", "40-16x32"])
@pytest.mark.parametrize("options", (None,) + OPTIONS)
@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_host_kernel_matches_the_emulation_bitwise(host, dtype, topo,
                                                   options, N, tile):
    """Substages 0 and 1 through the host build equal the emulation bit
    for bit, G and the new state, all finite."""
    model, s = model_and_state(N, topo, options, dtype)
    s1, G = run(host, model, s, 0, tile=tile)
    e1, eG = substage_tiles_reference(model, s, DT, 0, tile=tile)
    assert_bitwise(G, eG)
    assert_bitwise(s1, e1)
    s2, G2 = run(host, model, s1, 1, G, tile=tile)
    e2, eG2 = substage_tiles_reference(model, e1, DT, 1, eG, tile=tile)
    assert_bitwise(G2, eG2)
    assert_bitwise(s2, e2)


@pytest.mark.parametrize("halo", [3, 6, 7])
@pytest.mark.parametrize("options", [None, "biharmonic", "upwind3 momentum"])
@pytest.mark.parametrize("topo,mesh", [("periodic", (2, 2)),
                                       ("bounded y", (4, 1)),
                                       ("periodic", (1, 4))])
def test_host_kernel_tiles_match_the_whole_grid_bitwise(host, topo, mesh,
                                                        options, halo):
    """Each tile of ``mesh``, cut with its halo from the 32² state, through
    the host build equals the whole grid's host substage bit for bit."""
    model, s = model_and_state(32, topo, options, torch.float64)
    s1, G = run(host, model, s, 0)
    tiles, pad = tile_layout(32, 32, mesh, halo)
    for x0, x1, y0, y1 in tiles:
        t1, tG = run(host, model, cut_tile(s, (x0, x1, y0, y1), *pad), 0,
                     halo=pad)
        assert_bitwise(tG, G[:, x0:x1, y0:y1])
        assert_bitwise(t1, s1[:, x0:x1, y0:y1])

