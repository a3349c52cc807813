"""The launches of the overlap split on a region of a tile (the strided
``swmhd_substage``: ``csrc/substage.cu``, ``tile.cuh`` ``load_windows``
and the update of ``vi_tile.cuh`` / ``cons_tile.cuh``) built for the
host, on the CPU.

``tests/host_build/{vi,cons}_host.cpp`` export, beside the contiguous
entry point, ``<name>_substage_region_{f32,f64}``: the same kernel with
the strides of the state it reads and of the outputs it writes. The
split of a tile cut with its halo from a global state, one launch for the
interior on the unpadded tile (its own outer ring read as the halo) and
one a band on slabs of the padded tile (``parallel.decomposition
.band_slabs``), each writing its region of whole-tile outputs in place,
must give G and the new state of substages 0 and 1 bit for bit as the one
launch on the padded tile does, in both formulations, float32 and
float64, at halos 6 and 7 (a biharmonic closure), on 2×2 (four bands),
4×1 with walls in y and 1×2 (two bands) meshes. The split's launches take
tiles of 8 rows and the one launch 16, as the card's rule gives thin
bands 8. Skips where no g++ builds C++20.
"""

import ctypes

import pytest
import torch

from swmhd_tpu_torch.models.shallow_water import RK3_GAMMA, RK3_ZETA
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.parallel.decomposition import band_slabs
from port_cases import CONS, VI, cut_tile, tile_layout
from test_torch_vi_tile_host import (DT, assert_bitwise, build_host,
                                     compile_host, model_and_state, run)

torch.set_num_threads(1)


def region_entries(lib, name):
    """The region entry points of the host build ``lib``, by dtype."""
    P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"{name}_substage_region_{suffix}")
        fn.argtypes = [P] * 4 + [I] * 4 + [L] * 4 + [I] * 8 + [D] * 10
        fn.restype = I
        fns[dtype] = fn
    return fns


@pytest.fixture(scope="module", params=[VI, CONS])
def host(request, tmp_path_factory):
    """``(formulation, contiguous entries, region entries)`` of the
    formulation's host build."""
    name = "vi_host" if request.param == VI else "cons_host"
    lib = compile_host(tmp_path_factory, name)
    return (request.param, build_host(tmp_path_factory, name, lib),
            region_entries(lib, name))


def run_region(region, model, s, stage, g_prev, out, at, halo, tile_x=8):
    """One region launch through the host build: ``s`` a slab (any
    strides, rows contiguous), its unpadded points written into ``out =
    (s_out, g_out)`` at ``at``, G_prev read there."""
    p = K.kernel_params(model)
    hx, hy = halo
    s_out, g_out = out
    nx, ny = s.shape[1] - 2 * hx, s.shape[2] - 2 * hy
    x, y = at

    def ptr(t):
        return None if t is None else t[:, x:, y:].data_ptr()
    err = region[s.dtype](
        s.data_ptr(), ptr(g_prev), ptr(s_out), ptr(g_out), nx, ny, hx, hy,
        s.stride(1), s.stride(0), s_out.stride(1), s_out.stride(0),
        K.EXCHANGED_AXIS if hx else p.wall_x,
        K.EXCHANGED_AXIS if hy else p.wall_y, *p[3:8], tile_x, *p[8:],
        DT, RK3_GAMMA[stage], RK3_ZETA[stage])
    assert err == 0


def split(region, model, padded, stage, g_prev, halo):
    """The split of one substage on the padded tile: ``(s_new, G)``."""
    hx, hy = halo
    nx, ny = padded.shape[1] - 2 * hx, padded.shape[2] - 2 * hy
    tile = padded[:, hx:hx + nx, hy:hy + ny].contiguous()
    out = (torch.full_like(tile, float("nan")),
           torch.full_like(tile, float("nan")))
    run_region(region, model, tile, stage, g_prev, out, halo, halo)
    for rows, cols, at in band_slabs(nx, ny, hx, hy):
        run_region(region, model, padded[:, rows, cols], stage, g_prev, out,
                   at, halo)
    return out


@pytest.mark.parametrize("options,halo", [(None, 6), ("biharmonic", 7)])
@pytest.mark.parametrize("topo,mesh,N", [("periodic", (2, 2), 48),
                                         ("bounded y", (4, 1), 96),
                                         ("periodic", (1, 2), 48)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_split_is_the_tile_launch_bitwise(host, dtype, topo, mesh, N,
                                          options, halo):
    """Interior and bands, each written in place, equal the one launch on
    the padded tile bit for bit, substages 0 and 1 (G_prev read at each
    region), on the last tile of ``mesh``; nothing is left unwritten."""
    formulation, whole, region = host
    model, s = model_and_state(N, topo, options, dtype, formulation)
    tiles, pad = tile_layout(N, N, mesh, halo)
    assert 3 * halo <= min(N // mesh[0], N // mesh[1])
    p = cut_tile(s, tiles[-1], *pad)
    t1, h1 = run(whole, model, p, 0, halo=pad, tile=(16, 32))
    t2, h2 = run(whole, model, p, 1, h1, halo=pad, tile=(16, 32))
    u1, k1 = split(region, model, p, 0, None, pad)
    u2, k2 = split(region, model, p, 1, h1, pad)
    for got, want in ((k1, h1), (u1, t1), (k2, h2), (u2, t2)):
        assert_bitwise(got, want)
