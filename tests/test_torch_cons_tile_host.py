"""The conservative tile kernel (csrc/cons_tile.cuh) built for the host and
held bit for bit to its plain emulation, on the CPU.

``tests/host_build/cons_host.cpp`` compiles the kernel with g++
(``-std=c++20``, no fma contraction) against the stand-in CUDA headers
beside it, as ``tests/test_torch_vi_tile_host.py`` does the
vector-invariant one: each block runs on 256 host threads that meet at a
barrier for every ``__syncthreads``, its shared memory filled with 0xff
bytes first, so a slot read before the kernel writes it (an intermediate
outside its region, a slot past a wall) is a NaN and shows in G. Through
ctypes on CPU tensors, G and the new state of substages 0 and 1 must
equal :func:`~swmhd_tpu_torch.ops.cons_tile.substage_tiles_reference` bit
for bit and be finite, in float64 and float32, for every pair of axis
modes and every option the formulation reads, at 32² in 8-row tiles and
40² in 32-row tiles (ragged); and halo tiles at halos 6 and 7 must equal
the whole grid bit for bit. Skips where no g++ builds C++20.
"""

import pytest
import torch

from swmhd_tpu_torch.ops.cons_tile import substage_tiles_reference
from port_cases import CONS, cut_tile, tile_layout
from test_torch_cons_tile import CONS_OPTIONS
from test_torch_vi_tile_host import (DT, TOPOLOGIES, assert_bitwise,
                                     build_host, model_and_state, run)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build's two entry points, by dtype."""
    return build_host(tmp_path_factory, "cons_host")


@pytest.mark.parametrize("N,tile", [(32, (8, 32)), (40, (32, 32))],
                         ids=["32-8x32", "40-32x32"])
@pytest.mark.parametrize("options", (None,) + CONS_OPTIONS)
@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_host_kernel_matches_the_emulation_bitwise(host, dtype, topo,
                                                   options, N, tile):
    """Substages 0 and 1 through the host build equal the emulation bit
    for bit, G and the new state, all finite."""
    model, s = model_and_state(N, topo, options, dtype, CONS)
    s1, G = run(host, model, s, 0, tile=tile)
    e1, eG = substage_tiles_reference(model, s, DT, 0, tile=tile)
    assert_bitwise(G, eG)
    assert_bitwise(s1, e1)
    s2, G2 = run(host, model, s1, 1, G, tile=tile)
    e2, eG2 = substage_tiles_reference(model, e1, DT, 1, eG, tile=tile)
    assert_bitwise(G2, eG2)
    assert_bitwise(s2, e2)


@pytest.mark.parametrize("halo", [6, 7])
@pytest.mark.parametrize("options", [None, "biharmonic", "upwind3 momentum"])
@pytest.mark.parametrize("topo,mesh", [("periodic", (2, 2)),
                                       ("bounded y", (4, 1)),
                                       ("periodic", (1, 4))])
def test_host_kernel_tiles_match_the_whole_grid_bitwise(host, topo, mesh,
                                                        options, halo):
    """Each tile of ``mesh``, cut with its halo from the 32² state, through
    the host build equals the whole grid's host substage bit for bit."""
    model, s = model_and_state(32, topo, options, torch.float64, CONS)
    s1, G = run(host, model, s, 0)
    tiles, pad = tile_layout(32, 32, mesh, halo)
    for x0, x1, y0, y1 in tiles:
        t1, tG = run(host, model, cut_tile(s, (x0, x1, y0, y1), *pad), 0,
                     halo=pad)
        assert_bitwise(tG, G[:, x0:x1, y0:y1])
        assert_bitwise(t1, s1[:, x0:x1, y0:y1])
