"""The resident kernels (csrc/vi_tile.cuh vi_resident, cons_tile.cuh
cons_resident) built for the host and held bit for bit to the host build
of their one-substage kernels, on the CPU.

``tests/host_build/vi_host.cpp`` and ``cons_host.cpp`` compile both
kernels with g++ (``-std=c++20``, no fma contraction) against the
stand-in CUDA headers beside them, whose grid barrier is legal only in a
grid of one block (asserted). The resident kernel runs as that one block
walking every tile of every substage, in shared memory filled with 0xff
bytes once, before the first tile: a missing barrier between two tiles of
a block, or a slot of one tile read by the next, shows as a difference
from the one-substage launches, whose blocks each start from 0xff bytes.
Two steps in one resident launch must equal six one-substage launches
(``run_tiles``) bit for bit, G passed on as the resident kernel keeps it,
in float64 and float32, both formulations, every pair of periodic and
bounded axes, with and without a biharmonic closure, at 32² and 40²
(ragged tiles). Skips where no g++ builds C++20.
"""

import ctypes
import os
import subprocess

import pytest
import torch

from swmhd_tpu_torch.models.shallow_water import RK3_GAMMA, RK3_ZETA
from swmhd_tpu_torch.ops import substage as K
from port_cases import CONS, VI, wall_model, with_options
from test_torch_vi_tile_host import CSRC, SHIM, TOPOLOGIES, _gxx

torch.set_num_threads(1)

DT = 0.005
STEPS = 2


def build(tmp_path_factory, name):
    """``{dtype: (substage entry, resident entry)}`` of
    ``tests/host_build/<name>.cpp`` built with g++."""
    out = tmp_path_factory.mktemp(name) / f"{name}.so"
    built = subprocess.run(
        [_gxx(), "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
         "-fPIC", "-pthread", "-I", SHIM, "-I", CSRC,
         os.path.join(SHIM, f"{name}.cpp"), "-o", str(out)],
        capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        sub = getattr(lib, f"{name}_substage_{suffix}")
        sub.argtypes = [P] * 4 + [I] * 12 + [D] * 10
        res = getattr(lib, f"{name}_resident_{suffix}")
        res.argtypes = [P] * 4 + [I] * 10 + [D] * 8 + [I]
        sub.restype = res.restype = I
        fns[dtype] = (sub, res)
    return fns


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    return {VI: build(tmp_path_factory, "vi_host"),
            CONS: build(tmp_path_factory, "cons_host")}


def substages(sub, model, s, tile_x):
    """STEPS RK3 steps as 3·STEPS one-substage host launches."""
    p = K.kernel_params(model)
    for _ in range(STEPS):
        g = None
        for stage in range(3):
            s_out = torch.empty_like(s)
            g_out = torch.empty_like(s) if stage < 2 else None
            err = sub(s.data_ptr(), None if g is None else g.data_ptr(),
                      s_out.data_ptr(),
                      None if g_out is None else g_out.data_ptr(),
                      *s.shape[1:], 0, 0, p.wall_x, p.wall_y, *p[3:8],
                      tile_x, *p[8:], DT, RK3_GAMMA[stage],
                      RK3_ZETA[stage])
            assert err == 0
            s, g = s_out, g_out
    return s


def resident(res, model, s, tile_x):
    """STEPS RK3 steps in one resident host launch (one block)."""
    p = K.kernel_params(model)
    out, work = torch.empty_like(s), torch.empty_like(s)
    gbuf = torch.empty((2,) + tuple(s.shape), dtype=s.dtype)
    before = s.clone()
    err = res(s.data_ptr(), out.data_ptr(), work.data_ptr(),
              gbuf.data_ptr(), *s.shape[1:], p.wall_x, p.wall_y, *p[3:8],
              tile_x, *p[8:], DT, STEPS)
    assert err == 0
    assert torch.equal(s, before), "the resident kernel wrote its input"
    return out


@pytest.mark.parametrize("N,tile_x", [(32, 8), (40, 16)],
                         ids=["32-8x32", "40-16x32"])
@pytest.mark.parametrize("options", [None, "biharmonic"])
@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("formulation", [VI, CONS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_resident_matches_substage_launches_bitwise(hosts, dtype,
                                                    formulation, topo,
                                                    options, N, tile_x):
    topology, gamma = TOPOLOGIES[topo]
    model, state = wall_model(N, dtype, "cpu", formulation, topology, gamma)
    model = with_options(model, options, DT)
    s = K.stack(state)
    sub, res = hosts[formulation][dtype]
    got = resident(res, model, s, tile_x)
    want = substages(sub, model, s, tile_x)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), \
        f"{(got - want).abs().max().item():.3e} off"
