"""The vector-invariant substage over 2-D tiles (csrc/vi_tile.cuh) and its
plain emulation (swmhd_tpu_torch.ops.vi_tile).

On the CPU, float64: ``substage_tiles_reference`` (each tile from its own
wrapped, clamped or exchanged window, intermediates only in the box
regions the kernel computes, NaN elsewhere and past the walls) against
``substage_reference`` and against the JAX package's substage
(``model.tendencies`` and the Le–Moin update), to 1e-12 of each compared
array's scale, at 32² and 48×32, for every pair of axis modes, on halo
tiles cut from the whole grid, and with model options; and the wrapper's
tile-shape rule (``tile_shape``, ``smem_bytes``). The kernel's own
logic is held to the emulation on the CPU by a host build:
``tests/test_torch_vi_tile_host.py``.

Tests marked ``cuda`` run the kernel and skip without a card:
``python -m pytest tests/test_torch_vi_tile.py -m cuda`` on the GPU.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swmhd_tpu
import swmhd_tpu_torch
from swmhd_tpu import (Grid as JGrid, ShallowWaterModel as JModel,
                       FPlane as JFPlane, jacobian_lorentz_forcing as jforce,
                       divergence_lorentz_forcing as jdivforce)
from swmhd_tpu_torch import (Grid as TGrid, ShallowWaterModel as TModel,
                             FPlane as TFPlane,
                             jacobian_lorentz_forcing as tforce,
                             divergence_lorentz_forcing as tdivforce)
from swmhd_tpu_torch.convert import state_from_numpy
from swmhd_tpu_torch.models.shallow_water import RK3_GAMMA
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.ops import cons_tile
from swmhd_tpu_torch.ops.vi_tile import substage_tiles_reference
from chip_smoke import (CONS, VI, cut_tile, initial_fields, option_kwargs,
                        stable_nu, tile_layout)

torch.set_num_threads(1)

L = 10.0
FIELDS = ("h", "u", "v", "A")
DT = 0.005
TOPOLOGIES = {"periodic": ("periodic", "periodic"),
              "bounded y": ("periodic", "bounded"),
              "bounded x": ("bounded", "periodic"),
              "bounded xy": ("bounded", "bounded")}


def pair(NX, NY, topology, options=None, dtype=torch.float64,
         device="cpu", seed=0, extent=L, formulation=VI):
    """The same model of ``formulation`` (vector-invariant by default) in
    both packages, each with its formulation's Lorentz forcing (A
    background gradient -0.05 where an axis is bounded), on the square of
    side ``extent`` and one state: chip_smoke's wall-reaching fields plus
    seeded numpy noise of 1e-3, as numpy."""
    gamma = -0.05 if "bounded" in topology else 0.0
    conservative = formulation == CONS
    rng = np.random.default_rng(seed)
    box = (-extent / 2, extent / 2)
    jg = JGrid.regular(NX, NY, box, box, topology=topology,
                       dtype=jnp.float64)
    nu = stable_nu(jg, DT, options)
    jm = JModel(grid=jg, formulation=formulation, coriolis=JFPlane(1.0),
                forcing=(jdivforce if conservative else jforce)(gamma),
                A_background_gradient_y=gamma,
                **option_kwargs(options, swmhd_tpu, nu))
    js = jm.initial_state(**initial_fields(jnp, h_bump=0.05, walls=True))
    noisy = {k: np.asarray(getattr(js, k))
             + 1e-3 * rng.standard_normal((NX, NY)) for k in FIELDS}
    # through initial_state again, which zeroes the wall-normal velocity
    # on the wall faces
    js = jm.initial_state(**{k: (lambda x, y, a=noisy[k]: jnp.asarray(a))
                             for k in FIELDS})
    fields = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    tg = TGrid.regular(NX, NY, box, box, topology=topology, dtype=dtype,
                       device=device)
    tm = TModel(grid=tg, formulation=formulation, coriolis=TFPlane(1.0),
                forcing=(tdivforce if conservative else tforce)(gamma),
                A_background_gradient_y=gamma,
                **option_kwargs(options, swmhd_tpu_torch, nu))
    return jm, tm, fields


def stacked(fields, dtype=torch.float64, device="cpu"):
    return K.stack(state_from_numpy(fields, device=device, dtype=dtype))


def jax_substage(jm, fields):
    """Substage 0 of the JAX package: ``(s + dt γ₀ G, G)``, stacked."""
    js = jm.initial_state(**{k: (lambda x, y, a=fields[k]: jnp.asarray(a))
                             for k in FIELDS})
    assert all(np.array_equal(np.asarray(getattr(js, k)), fields[k])
               for k in FIELDS)
    G = jm.tendencies(js)
    G = np.stack([np.asarray(getattr(G, k)) for k in FIELDS])
    s = np.stack([fields[k] for k in FIELDS])
    return s + DT * (RK3_GAMMA[0] * G), G


def assert_close(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{err:.3e}"


# (grid, topology, options, tile): each axis pair at 32² in the default
# model, then options, a 48×32 grid with ragged tiles and other tile rows
CASES = ([(32, 32, t, None, (8, 32)) for t in TOPOLOGIES]
         + [(32, 32, "bounded xy", o, (8, 32))
            for o in ("laplacian", "biharmonic", "vorticity stencil",
                      "centered2 momentum", "upwind3 momentum",
                      "upwind3 mass, centered2 tracer")]
         + [(48, 32, "bounded y", None, (32, 32)),
            (48, 32, "bounded x", "biharmonic", (16, 32)),
            (48, 32, "periodic", "centered2 mass, upwind3 tracer", (32, 32))])


@pytest.mark.parametrize("NX,NY,topo,options,tile", CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}-{c[3]}-{c[4][0]}"
                              for c in CASES])
def test_tiles_match_plain_and_jax(NX, NY, topo, options, tile):
    """The emulation tile by tile against the plain substage (bit for bit
    is expected; 1e-12 is the bound) and against the JAX package's
    substage, then substage 1 taking G_prev."""
    jm, tm, fields = pair(NX, NY, TOPOLOGIES[topo], options)
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
# along each cut axis, against the whole-grid substage
TILE_CASES = [("periodic", (2, 2), None, 6), ("periodic", (2, 2), None, 3),
              ("periodic", (4, 1), "upwind3 momentum", 6),
              ("periodic", (1, 4), "vorticity stencil", 6),
              ("bounded y", (4, 1), None, 6),
              ("bounded y", (4, 1), "biharmonic", 7)]


@pytest.mark.parametrize("topo,mesh,options,halo", TILE_CASES)
def test_halo_tiles_match_the_whole_grid(topo, mesh, options, halo):
    """Each tile of ``mesh``, cut with its halo from the 32² state (what
    the exchange gives), through the emulation: G and the new state equal
    the whole grid's plain substage on the tile."""
    _, tm, fields = pair(32, 32, TOPOLOGIES[topo], options)
    s = stacked(fields)
    s1, G = K.substage_reference(tm, s, DT, 0)
    tiles, pad = tile_layout(32, 32, mesh, halo)
    for x0, x1, y0, y1 in tiles:
        t1, tG = substage_tiles_reference(tm, cut_tile(s, (x0, x1, y0, y1),
                                                       *pad), DT, 0,
                                          halo=pad, tile=(8, 32))
        assert_close(tG, G[:, x0:x1, y0:y1], 1e-12)
        assert_close(t1, s1[:, x0:x1, y0:y1], 1e-12)


def test_tiles_reference_refuses_the_conservative_formulation():
    """Each formulation's emulation takes its own kernel's model only: the
    conservative one is ops.cons_tile's."""
    _, tm, fields = pair(16, 16, TOPOLOGIES["periodic"])
    cons = dataclasses.replace(
        tm, formulation="conservative",
        forcing=swmhd_tpu_torch.divergence_lorentz_forcing())
    with pytest.raises(ValueError):
        substage_tiles_reference(cons, stacked(fields), DT, 0)
    with pytest.raises(ValueError):
        cons_tile.substage_tiles_reference(tm, stacked(fields), DT, 0)
    calls = cons_tile.substage_tiles_reference.calls
    cons_tile.substage_tiles_reference(cons, stacked(fields), DT, 0,
                                       tile=(8, 32))
    assert cons_tile.substage_tiles_reference.calls == calls + 1


# -- the tile-shape rule -----------------------------------------------------

def test_smem_bytes_follow_the_kernel_layout():
    """Four state windows and 8 box arrays (10 with a biharmonic
    closure), each (TX + 6) × 38 values: vi_tile.cuh vi_smem_bytes."""
    f32, f64 = torch.float32, torch.float64
    assert K.smem_bytes(VI, f32, 32) == 4 * 38 * 38 * 12 == 69312
    assert K.smem_bytes(VI, f32, 32, True) == 4 * 38 * 38 * 14 == 80864
    assert K.smem_bytes(VI, f64, 16) == 8 * 22 * 38 * 12 == 80256
    assert K.smem_bytes(VI, f64, 16, True) == 8 * 22 * 38 * 14
    assert K.smem_bytes(VI, f64, 32) == 138624
    lay = K.TILE_LAYOUTS[VI]
    assert lay == (3, 3, 8, 2)
    for dtype in (f32, f64):
        for tx in (8, 16, 32):
            for bih in (False, True):
                words = ((tx + lay.lo + lay.hi) * (K.TILE_Y + lay.lo
                                                   + lay.hi)
                         * (4 + lay.arrays + lay.biharmonic * bih))
                assert K.smem_bytes(VI, dtype, tx, bih) == \
                    words * (4 if dtype == f32 else 8)


SHAPES = [(8, 8), (16, 48), (32, 32), (40, 24), (64, 64), (128, 128),
          (32, 128), (256, 256), (512, 512), (1024, 1024), (1024, 2048),
          (2048, 2048), (4096, 4096)]
# an H100: opt-in shared memory a block (bytes) and SMs
H100 = (232448, 132)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("biharmonic", [False, True])
def test_tile_rule_covers_the_grid_and_fits(dtype, biharmonic):
    """The rule's tiles on an H100 cover every grid (ragged edges
    included), leave room for two blocks an SM, take 32×32 f32 tiles at
    2048² and enough blocks for two an SM wherever a grid allows."""
    limit, sms = H100
    for nx, ny in SHAPES:
        tx, ty = K.tile_shape(VI, nx, ny, dtype, biharmonic, *H100)
        assert ty == K.TILE_Y and tx in K.TILE_X
        bytes_ = K.smem_bytes(VI, dtype, tx, biharmonic)
        assert 2 * bytes_ <= limit
        blocks = math.ceil(nx / tx) * math.ceil(ny / ty)
        assert blocks * tx * ty >= nx * ny
        covered = np.zeros((nx, ny), bool)
        for i in range(0, nx, tx):
            for j in range(0, ny, ty):
                covered[i:i + tx, j:j + ty] = True
        assert covered.all()
        if blocks < 2 * sms:
            assert tx == min(t for t in K.TILE_X
                             if 2 * K.smem_bytes(VI, dtype, t, biharmonic)
                             <= limit)
    assert K.tile_shape(VI, 2048, 2048, torch.float32, False, *H100) \
        == (32, 32)
    assert K.tile_shape(VI, 2048, 2048, torch.float64, False, *H100) \
        == (16, 32)
    assert K.tile_shape(VI, 128, 128, torch.float32, False, *H100) \
        == (8, 32)


def test_tile_rule_follows_the_card():
    """The rule reads the card: less shared memory a block rules out the
    tiles that would not fit twice, more SMs take smaller tiles; the
    conservative kernel's layout (radius 4 below, 3 above, no more arrays
    with a biharmonic closure) goes through the same rule."""
    f32 = torch.float32
    assert K.tile_shape(VI, 2048, 2048, f32, False, 100_000, 132) \
        == (16, 32)
    assert K.tile_shape(VI, 2048, 2048, f32, False, 232448, 2100) \
        == (16, 32)
    assert K.tile_shape(VI, 2048, 2048, f32, False, 232448, 9000) \
        == (8, 32)
    # 73,008 B at 32 rows fit twice in 150,000 B; VI's biharmonic 80,864
    # do not
    assert K.tile_shape(CONS, 2048, 2048, f32, True, 150_000, 132) \
        == (32, 32)
    assert K.tile_shape(VI, 2048, 2048, f32, True, 150_000, 132) \
        == (16, 32)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


CARD_CASES = [("periodic", None), ("bounded xy", None),
              ("bounded y", "biharmonic"), ("bounded x", "upwind3 momentum"),
              ("bounded xy", "centered2 momentum"),
              ("periodic", "vorticity stencil")]
# (grid, domain side): grids on which the rule takes each tile row count
# on an H100, ragged where it can be; the side keeps the spacing near the
# 72×64 grid's on [-5, 5]², as f32 G loses digits with 1/dx
CARD_GRIDS = {8: (76, 64, 10.0), 16: (400, 400, 60.0), 32: (600, 600, 90.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", CARD_GRIDS)
def test_card_grids_reach_each_tile_shape(rows, dtype):
    """The grids of the card cases take 8, 16 and 32 rows on an H100 (f64
    tiles fit twice only up to 16 rows)."""
    nx, ny, _ = CARD_GRIDS[rows]
    for biharmonic in (False, True):
        assert K.tile_shape(VI, nx, ny, dtype, biharmonic, *H100) == (
            min(rows, 16 if dtype == torch.float64 else 32), K.TILE_Y)


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
    _, tm, fields = pair(nx, ny, TOPOLOGIES[topo], options, dtype, cuda,
                         extent=extent)
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
@pytest.mark.parametrize("topo,mesh,options,halo", TILE_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_kernel_tiles_are_bitwise_on_card(cuda, topo, mesh, options,
                                               halo, dtype):
    """Halo tiles through the kernel equal the whole-grid kernel bit for
    bit, substages 0 and 1."""
    _, tm, fields = pair(64, 64, TOPOLOGIES[topo], options, dtype, cuda)
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
def test_tile_kernel_info_on_card(cuda, dtype):
    """The runtime's shared memory, registers and blocks an SM of the
    kernel at each tile shape of the rule."""
    _, tm, _ = pair(64, 64, TOPOLOGIES["periodic"], "biharmonic", dtype,
                    cuda)
    branch = K.kernel_params(tm).branch
    for tx in K.TILE_X:
        smem, regs, blocks = K.tile_info(dtype, branch, tx)
        assert smem == K.smem_bytes(VI, dtype, tx, True)
        assert 0 < regs <= 255 and blocks >= 1


@pytest.mark.cuda
def test_tile_kernel_refuses_too_much_shared_memory_on_card(cuda,
                                                            monkeypatch):
    """64×32 f64 tiles with a biharmonic closure take 297,920 B a block,
    over the card's opt-in limit: the C entry point returns
    cudaErrorInvalidValue (1). The rule never picks them, so the test
    hands the entry point that tile in its place."""
    _, tm, fields = pair(64, 64, TOPOLOGIES["periodic"], "biharmonic",
                         torch.float64, cuda)
    assert K.smem_bytes(VI, torch.float64, 64, True) == 297920
    assert 297920 > K.card_limits(cuda.index)[0]
    monkeypatch.setattr(K, "_tile_x", lambda *args: 64)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        K.substage(tm, stacked(fields, torch.float64, cuda), DT, 0)
