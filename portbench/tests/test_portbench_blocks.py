"""The comparison of a decomposed cell, made by each rank on its tile:
the reference followed on a block of the grid (the tile and a halo of
``3 * REACH`` cells a step, wrapped) is the whole grid's reference on
the tile, bit for bit, and ``REACH`` bounds how far a substage of the
reference reaches."""

import dataclasses

import pytest
import torch

from portbench import harness
from portbench.check import REACH, Block, Judge
from portbench.reference import swmhd as R


@pytest.mark.parametrize("formulation", ["vector_invariant", "conservative"])
def test_a_substage_reaches_no_further_than_reach(formulation):
    """A change at one point moves the tendencies within ``REACH`` cells
    of it and no further, on either axis, for every field."""
    m = R.Model(R.Grid(64, 10.0, "periodic"), formulation, 9.81, 1.0, -0.05)
    s = R.initial_state(m, {"h0": 1.0, "A": ["two_gaussians", 0.5],
                            "uv": ["vortex", 1.0]}, {"h": [], "A": []})
    base = R.tendencies(m, *s)
    reach = 0
    for f in range(4):
        moved = [x.clone() for x in s]
        moved[f][32, 32] += 1e-3
        for a, b in zip(base, R.tendencies(m, *moved)):
            where = ((a - b).abs() > 0).nonzero()
            if len(where):
                reach = max(reach, int((where - 32).abs().max()))
    assert 3 <= reach <= REACH


def random_state(n, seed=0):
    """Fields with structure everywhere, so that a wrap that reaches the
    tile shows."""
    g = torch.Generator().manual_seed(seed)
    r = torch.rand((4, n, n), generator=g, dtype=torch.float64)
    return (1.0 + 0.1 * r[0], 0.1 * (r[1] - 0.5), 0.1 * (r[2] - 0.5),
            r[3] - 0.5)


@pytest.mark.parametrize("name", ["jacobian.weak4096x4",
                                  "divergence.2048.periodic"])
@pytest.mark.parametrize("x0,y0", [(64, 0), (96, 32)])
def test_the_block_reference_is_the_whole_grids_on_the_tile(name, x0, y0):
    """Two steps on a 64² tile of a 128² grid (the second tile wraps
    round both axes), from random fields: the block's result on the tile
    equals the whole grid's there, exactly, in float64 and in the
    bfloat16 control. One step with a halo one cell short of what a reach
    of 3 needs (a wrap spoils 3 more cells a substage) does not."""
    cell = harness.find_cell(name)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "N": 128})
    perturb = {"h": [], "A": []}
    whole = Judge(cell, perturb, "cpu")
    start = random_state(128)
    block = Block(n=128, x0=x0, nx=64, y0=y0, ny=64, halo=3 * REACH * 2)
    part = Judge(cell, perturb, "cpu", block)
    assert block.shape == (112, 112)
    for dtype in (torch.float64, torch.bfloat16):
        ref, _ = whole.follow(start, 2, dtype)
        got, _ = part.follow(tuple(block.cut(f) for f in start), 2, dtype)
        assert torch.equal(block.crop(got), block.crop(block.cut(ref)))
    ref, _ = whole.follow(start, 1)
    for halo, same in ((3 * 3, True), (3 * 3 - 1, False)):
        b = Block(n=128, x0=x0, nx=64, y0=y0, ny=64, halo=halo)
        got, _ = Judge(cell, perturb, "cpu", b).follow(
            tuple(b.cut(f) for f in start), 1)
        assert torch.equal(b.crop(got), b.crop(b.cut(ref))) is same


def test_a_block_wider_than_the_grid_is_the_grid_from_the_tile():
    b = Block(n=32, x0=16, nx=16, y0=0, ny=16, halo=60)
    a = torch.arange(32 * 32.0).reshape(32, 32)
    assert b.shape == (32, 32)
    assert torch.equal(b.crop(b.cut(a)), a[16:32, 0:16])
    b = Block(n=32, x0=24, nx=8, y0=28, ny=8, halo=2)
    assert b.shape == (12, 12)
    assert torch.equal(b.crop(b.cut(a)), torch.roll(a, (-24, -28), (0, 1))[
        :8, :8])
