"""The conservative substage over 2-D tiles (csrc/cons_tile.cuh) and its
plain emulation (swmhd_tpu_torch.ops.cons_tile).

On the CPU, float64: ``substage_tiles_reference`` (each tile from its own
wrapped, clamped or exchanged window, intermediates only in the box
regions the kernel computes, NaN elsewhere and past the walls) against
``substage_reference`` and against the JAX package's substage
(``model.tendencies`` and the Le–Moin update), to 1e-12 of each compared
array's scale, at 32² and 48×32 (ragged tiles), for every pair of axis
modes and every model option the formulation reads, on halo tiles cut
from the whole grid; and the tile-shape rule with the conservative
layout (``tile_shape``, ``smem_bytes``). The kernel's own logic is held
to the emulation on the CPU by a host build:
``tests/test_torch_cons_tile_host.py``.

Tests marked ``cuda`` run the kernel and skip without a card:
``python -m pytest tests/test_torch_cons_tile.py -m cuda`` on the GPU.
"""

import math

import numpy as np
import pytest
import torch

from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.ops.cons_tile import substage_tiles_reference
from chip_smoke import CONS, OPTIONS, cut_tile, tile_layout
from test_torch_vi_tile import (CARD_GRIDS, DT, H100, SHAPES, TOPOLOGIES,
                                assert_close, jax_substage, pair, stacked)

torch.set_num_threads(1)

# the options the conservative formulation reads (it has no vorticity
# flux; its mass is not reconstructed, so of the scheme pairs only the
# tracer's counts)
CONS_OPTIONS = tuple(o for o in OPTIONS if o != "vorticity stencil")
# (grid, tile): 8-row tiles on 32², ragged 32-row tiles on 48×32
GRIDS = [(32, 32, (8, 32)), (48, 32, (32, 32))]
CASES = [(nx, ny, topo, options, tile) for nx, ny, tile in GRIDS
         for topo in TOPOLOGIES for options in (None,) + CONS_OPTIONS]


def cons_pair(NX, NY, topo, options=None, **kw):
    return pair(NX, NY, TOPOLOGIES[topo], options, formulation=CONS, **kw)


@pytest.mark.parametrize("NX,NY,topo,options,tile", CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}-{c[3]}" for c in CASES])
def test_tiles_match_plain_and_jax(NX, NY, topo, options, tile):
    """The emulation tile by tile against the plain substage and against
    the JAX package's substage (1e-12), then substage 1 taking G_prev."""
    jm, tm, fields = cons_pair(NX, NY, topo, options)
    s = stacked(fields)
    calls = substage_tiles_reference.calls
    s1, G = substage_tiles_reference(tm, s, DT, 0, tile=tile)
    assert substage_tiles_reference.calls == calls + 1
    p1, pG = K.substage_reference(tm, s, DT, 0)
    assert_close(G, pG, 1e-12)
    assert_close(s1, p1, 1e-12)
    want_s, want_G = jax_substage(jm, fields)
    assert_close(G, want_G, 1e-12)
    assert_close(s1, want_s, 1e-12)
    s2, _ = substage_tiles_reference(tm, s1, DT, 1, G, tile=tile)
    assert_close(s2, K.substage_reference(tm, p1, DT, 1, pG)[0], 1e-12)


# (topology, mesh, options, halo): tiles of a decomposition, exchanged
# along each cut axis, against the whole-grid substage; 4 is the
# substage's composed radius, 6 the model's exchange_halo (7 with a
# biharmonic closure)
TILE_CASES = [("periodic", (2, 2), None, 6), ("periodic", (2, 2), None, 4),
              ("periodic", (4, 1), "upwind3 momentum", 6),
              ("periodic", (1, 4), "centered2 momentum", 6),
              ("periodic", (2, 2), "laplacian", 6),
              ("bounded y", (4, 1), None, 6),
              ("bounded y", (4, 1), "biharmonic", 7),
              ("bounded y", (4, 1), "centered2 mass, upwind3 tracer", 6)]


@pytest.mark.parametrize("topo,mesh,options,halo", TILE_CASES)
def test_halo_tiles_match_the_whole_grid(topo, mesh, options, halo):
    """Each tile of ``mesh``, cut with its halo from the 32² state (what
    the exchange gives), through the emulation: G and the new state equal
    the whole grid's plain substage on the tile."""
    _, tm, fields = cons_pair(32, 32, topo, options)
    s = stacked(fields)
    s1, G = K.substage_reference(tm, s, DT, 0)
    tiles, pad = tile_layout(32, 32, mesh, halo)
    for x0, x1, y0, y1 in tiles:
        t1, tG = substage_tiles_reference(tm, cut_tile(s, (x0, x1, y0, y1),
                                                       *pad), DT, 0,
                                          halo=pad, tile=(8, 32))
        assert_close(tG, G[:, x0:x1, y0:y1], 1e-12)
        assert_close(t1, s1[:, x0:x1, y0:y1], 1e-12)


# -- the tile-shape rule -----------------------------------------------------

def test_smem_bytes_follow_the_kernel_layout():
    """Four state windows and 8 box arrays, a biharmonic closure
    included, each (TX + 7) × 39 values: cons_tile.cuh cons_smem_bytes."""
    f32, f64 = torch.float32, torch.float64
    assert K.TILE_LAYOUTS[CONS] == (4, 3, 8, 0)
    assert K.smem_bytes(CONS, f32, 32) == 4 * 39 * 39 * 12 == 73008
    assert K.smem_bytes(CONS, f32, 32, True) == 73008
    assert K.smem_bytes(CONS, f64, 16) == 8 * 23 * 39 * 12 == 86112
    assert K.smem_bytes(CONS, f64, 32) == 146016
    assert K.smem_bytes(CONS, f32, 8) == 4 * 15 * 39 * 12
    for dtype in (f32, f64):
        for tx in K.TILE_X:
            assert K.smem_bytes(CONS, dtype, tx) == \
                dtype.itemsize * (tx + 7) * 39 * 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("biharmonic", [False, True])
def test_tile_rule_covers_the_grid_and_fits(dtype, biharmonic):
    """The rule's conservative tiles on an H100 cover every grid (ragged
    edges included), leave room for two blocks an SM, take 32×32 f32 and
    16×32 f64 tiles at 2048² and 8×32 at 128², and enough blocks for two
    an SM wherever a grid allows."""
    limit, sms = H100
    for nx, ny in SHAPES:
        tx, ty = K.tile_shape(CONS, nx, ny, dtype, biharmonic, *H100)
        assert ty == K.TILE_Y and tx in K.TILE_X
        assert 2 * K.smem_bytes(CONS, dtype, tx, biharmonic) <= limit
        blocks = math.ceil(nx / tx) * math.ceil(ny / ty)
        covered = np.zeros((nx, ny), bool)
        for i in range(0, nx, tx):
            for j in range(0, ny, ty):
                covered[i:i + tx, j:j + ty] = True
        assert covered.all()
        if blocks < 2 * sms:
            assert tx == min(t for t in K.TILE_X if 2 * K.smem_bytes(
                CONS, dtype, t, biharmonic) <= limit)
    big = 32 if dtype == torch.float32 else 16
    assert K.tile_shape(CONS, 2048, 2048, dtype, biharmonic, *H100) \
        == (big, 32)
    assert K.tile_shape(CONS, 1024, 1024, dtype, biharmonic, *H100) \
        == (big, 32)
    assert K.tile_shape(CONS, 128, 128, dtype, biharmonic, *H100) == (8, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", CARD_GRIDS)
def test_card_grids_reach_each_tile_shape(rows, dtype):
    """The grids of the card cases take 8, 16 and 32 rows on an H100 for
    the conservative kernel too (f64 tiles fit twice only up to 16)."""
    nx, ny, _ = CARD_GRIDS[rows]
    for biharmonic in (False, True):
        assert K.tile_shape(CONS, nx, ny, dtype, biharmonic, *H100) == (
            min(rows, 16 if dtype == torch.float64 else 32), K.TILE_Y)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


CARD_CASES = [("periodic", None), ("bounded xy", None),
              ("bounded y", "biharmonic"), ("bounded x", "upwind3 momentum"),
              ("bounded xy", "centered2 momentum"),
              ("periodic", "laplacian"),
              ("bounded xy", "upwind3 mass, centered2 tracer")]


@pytest.mark.cuda
@pytest.mark.parametrize("topo,options", CARD_CASES)
@pytest.mark.parametrize("rows", CARD_GRIDS)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 2e-5)])
def test_tile_kernel_matches_plain_on_card(cuda, topo, options, rows, dtype,
                                           tol):
    """The kernel on the grid of ``rows`` (the rule's tile shape there)
    against its plain version, G and the new state of substages 0 and 1,
    one launch each."""
    nx, ny, extent = CARD_GRIDS[rows]
    _, tm, fields = cons_pair(nx, ny, topo, options, dtype=dtype,
                              device=cuda, extent=extent)
    s = stacked(fields, dtype, cuda)
    K.reset_counters()
    s1, G = K.substage(tm, s, DT, 0)
    s2, _ = K.substage(tm, s1, DT, 1, G)
    p1, pG = K.substage_reference(tm, s, DT, 0)
    p2, _ = K.substage_reference(tm, p1, DT, 1, pG)
    torch.cuda.synchronize()
    assert K.substage.launches == 2
    for got, want in ((G, pG), (s1, p1), (s2, p2)):
        assert_close(got.cpu(), want.cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("topo,mesh,options,halo",
                         [c for c in TILE_CASES if c[3] >= 6])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_kernel_tiles_are_bitwise_on_card(cuda, topo, mesh, options,
                                               halo, dtype):
    """Halo tiles through the kernel equal the whole-grid kernel bit for
    bit, substages 0 and 1."""
    _, tm, fields = cons_pair(64, 64, topo, options, dtype=dtype,
                              device=cuda)
    s = stacked(fields, dtype, cuda)
    s1, G = K.substage(tm, s, DT, 0)
    s2, G2 = K.substage(tm, s1, DT, 1, G)
    tiles, pad = tile_layout(64, 64, mesh, halo)
    for b in tiles:
        x0, x1, y0, y1 = b
        t1, tG = K.substage(tm, cut_tile(s, b, *pad), DT, 0, halo=pad)
        t2, tG2 = K.substage(tm, cut_tile(s1, b, *pad), DT, 1,
                             G[:, x0:x1, y0:y1].contiguous(), halo=pad)
        for got, want in ((t1, s1), (tG, G), (t2, s2), (tG2, G2)):
            assert torch.equal(got, want[:, x0:x1, y0:y1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("options", [None, "biharmonic"])
def test_tile_kernel_info_on_card(cuda, dtype, options):
    """The runtime's shared memory, registers and blocks an SM of the
    kernel at each tile shape of the rule that fits the card."""
    _, tm, _ = cons_pair(64, 64, "periodic", options, dtype=dtype,
                         device=cuda)
    branch = K.kernel_params(tm).branch
    limit = K.card_limits(cuda.index)[0]
    for tx in K.TILE_X:
        if K.smem_bytes(CONS, dtype, tx) > limit:
            continue
        smem, regs, blocks = K.tile_info(dtype, branch, tx)
        assert smem == K.smem_bytes(CONS, dtype, tx)
        assert 0 < regs <= 255 and blocks >= 1


@pytest.mark.cuda
def test_tile_kernel_refuses_a_tile_over_its_rows_on_card(cuda,
                                                          monkeypatch):
    """A 64-row tile is over the kernel's most rows (the registers hold
    Gu, Gv of 4 points a thread): the C entry point returns
    cudaErrorInvalidValue (1). The rule never picks it, so the test hands
    the entry point that tile in its place."""
    _, tm, fields = cons_pair(64, 64, "periodic", dtype=torch.float32,
                              device=cuda)
    monkeypatch.setattr(K, "_tile_x", lambda *args: 64)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        K.substage(tm, stacked(fields, torch.float32, cuda), DT, 0)
