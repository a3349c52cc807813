"""The energy series kernel (csrc/energy_series.cuh) built for the host and
held to its plain version (``ops.energies.energy_series_reference``), on
the CPU.

``tests/host_build/energy_series_host.cpp`` compiles the kernel with g++
(``-std=c++20``, no fma contraction) against the stand-in CUDA headers
beside it and runs its blocks one after another, each on 256 host threads
(its warp shuffles an exchange through a block-wide buffer, its ticket an
atomic). Both formulations, every pair of periodic and bounded axes (A
gradient −0.05 where an axis is bounded), float64 and float32, on a 32²
grid (four bands of 8 rows), a 26×40 one (bands of 6 rows, the last of 2)
and a 3×600 one (a band of one row, more points than a block's threads):
the five values within the card test's tolerance of the plain version's, a
second launch on the same scratch bit for bit the first, and the ticket
back at zero after each. Skips where no g++ builds C++20.
"""

import math

import pytest
import torch

from swmhd_tpu_torch.ops import energies as E
from swmhd_tpu_torch.ops._build import _SIGNATURES
from swmhd_tpu_torch.models.shallow_water import CONSERVATIVE
from test_torch_energy_series import (CONS, TOLERANCE, VI, relative_errors,
                                      series_case)
from test_torch_vi_tile_host import TOPOLOGIES, compile_host

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build's entry points, by dtype: the card's arguments
    without the stream."""
    lib = compile_host(tmp_path_factory, "energy_series_host")
    argtypes = _SIGNATURES["swmhd_energy_series"][0][:-1]
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"energy_series_host_{suffix}")
        fn.argtypes = argtypes
        fns[dtype] = fn
    return fns


def launch(fn, model, state, h0, scratch):
    """The five values of one host launch, in :data:`E.ENERGY_NAMES`'
    order, as the wrapper passes its arguments."""
    g = model.grid
    out = torch.empty(len(E.ENERGY_NAMES), dtype=state.h.dtype)
    err = fn(*(f.data_ptr() for f in (state.h, state.u, state.v, state.A,
                                      h0)),
             out.data_ptr(), scratch.data_ptr(), g.Nx, g.Ny,
             E.band_rows(g.Nx, g.Ny),
             int(model.formulation == CONSERVATIVE),
             int(g.topology_x == "bounded"), int(g.topology_y == "bounded"),
             g.dx, g.dy, g.Lx, g.Ly, float(model.gravitational_acceleration),
             float(model.A_background_gradient_y))
    assert err == 0
    assert scratch[-1].item() == 0.0, "the ticket was not reset"
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(32, 32), (26, 40), (3, 600)],
                         ids=["32x32", "26x40", "3x600"])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_host_kernel_matches_plain_version(host, formulation, topology,
                                           shape, dtype):
    axes, gamma = TOPOLOGIES[topology]
    model, state, h0 = series_case(formulation, axes, shape, dtype, "cpu",
                                   gamma=gamma)
    nx, ny = shape
    blocks = math.ceil(nx / E.band_rows(nx, ny))
    scratch = torch.zeros(4 * blocks + 1, dtype=torch.float64)
    out = launch(host[dtype], model, state, h0, scratch)
    again = launch(host[dtype], model, state, h0, scratch)
    assert torch.equal(out, again)
    got = dict(zip(E.ENERGY_NAMES, out.unbind(0)))
    err = relative_errors(got, E.energy_series_reference(model, state, h0))
    assert float(err.max()) <= TOLERANCE[dtype], err.tolist()
