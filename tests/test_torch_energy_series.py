"""The CLI's energy series: ``cli.energies``' route, the kernel
(``ops.energies.energy_series``, csrc/energy_series.cu) and its plain
version (``energy_series_reference``).

On the CPU: the route ``ops.energies.takes_kernel`` picks from the state
(the kernel for a float32 or float64 CUDA state outside
``diagnostics.tile_reduction``, the plain version for anything else); a
CPU state through ``cli.energies`` takes the plain version, whose counter
grows while the kernel's stays 0, under ``tile_reduction`` too; the
closing log line of a run counts both. ``tests/test_torch_resident.py``
holds the plain version to the JAX package's energy report, and
``tests/test_torch_energy_series_host.py`` the kernel's host build to the
plain version.

Tests marked ``cuda`` run on the card and skip without one: the kernel
against the plain version in both formulations, periodic and walled in y
(A gradient −0.05), on a 128² grid and a 72×100 one, float64 and float32;
a ``GraphChunk`` whose series is ``cli.energies`` replaying the rows of
eager calls bit for bit, one kernel launch a step through its replays.
``python -m pytest tests/test_torch_energy_series.py -m cuda`` on the GPU.
"""

import logging
import re
import types

import pytest
import torch

import swmhd_tpu_torch
from swmhd_tpu_torch import cli, diagnostics
from swmhd_tpu_torch.io import ScalarSeriesWriter
from swmhd_tpu_torch.models.shallow_water import run_steps
from swmhd_tpu_torch.models.state import State
from swmhd_tpu_torch.ops import energies as E
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.simulation import IterationInterval, Simulation

torch.set_num_threads(1)

VI, CONS = "vector_invariant", "conservative"
TOPOLOGIES = {"periodic": ("periodic", "periodic"),
              "walled": ("periodic", "bounded")}
# relative to the larger of a value and the five values' median: the
# kernel sums in double in its own order, the plain version in the field
# type (torch.mean); float64 rounds at ~1e-16 a term, float32 at ~1e-7
TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}


def series_case(formulation, topology, shape, dtype, device, gamma=None):
    """``(model, state, h0)``: FPlane(1), g 9.81, the formulation's Lorentz
    forcing, A gradient −0.05 where an axis is bounded, on an ``nx × ny``
    grid of (−5, 5) × (−4, 6); seeded noise fields with h near 1 and an
    initial height of its own."""
    if gamma is None:
        gamma = -0.05 if "bounded" in topology else 0.0
    nx, ny = shape
    g = swmhd_tpu_torch.Grid.regular(nx, ny, (-5.0, 5.0), (-4.0, 6.0),
                                     topology=topology, dtype=dtype,
                                     device=device)
    forcing = (swmhd_tpu_torch.divergence_lorentz_forcing(gamma)
               if formulation == CONS
               else swmhd_tpu_torch.jacobian_lorentz_forcing(gamma))
    model = swmhd_tpu_torch.ShallowWaterModel(
        grid=g, formulation=formulation, coriolis=swmhd_tpu_torch.FPlane(1.0),
        forcing=forcing, A_background_gradient_y=gamma,
        gravitational_acceleration=9.81)
    gen = torch.Generator().manual_seed(nx * 1000 + ny)

    def field(scale, offset=0.0):
        return (offset + scale * torch.randn(
            nx, ny, generator=gen, dtype=torch.float64)).to(device, dtype)
    state = State(h=field(0.05, 1.0), u=field(0.5), v=field(0.4),
                  A=field(0.2))
    return model, state, field(0.05, 1.0)


def relative_errors(got, want):
    """The five values' distances, each over the larger of the wanted
    value and the five wanted values' median."""
    g = torch.stack([got[n] for n in E.ENERGY_NAMES]).double().cpu()
    w = torch.stack([want[n] for n in E.ENERGY_NAMES]).double().cpu()
    return (g - w).abs() / torch.maximum(w.abs(), w.abs().median())


# -- the route, on the CPU -----------------------------------------------------


def stand_in(is_cuda, dtype):
    """A state whose height says only where it lies and its dtype."""
    return types.SimpleNamespace(
        h=types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype))


@pytest.mark.parametrize("is_cuda,dtype,kernel", [
    (True, torch.float32, True), (True, torch.float64, True),
    (True, torch.float16, False), (True, torch.bfloat16, False),
    (False, torch.float32, False), (False, torch.float64, False)])
def test_route_follows_device_and_dtype(is_cuda, dtype, kernel):
    assert E.takes_kernel(stand_in(is_cuda, dtype)) is kernel


def test_route_under_tile_reduction_is_plain():
    """A tile's series is reduced over ranks by the plain version's
    integrals, so even a CUDA float32 tile takes it."""
    with diagnostics.tile_reduction(3):
        assert not E.takes_kernel(stand_in(True, torch.float32))
    assert E.takes_kernel(stand_in(True, torch.float32))


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_cpu_state_takes_the_plain_version(formulation, topology):
    """On a CPU state ``cli.energies`` is the plain version, value for
    value; its counter grows by one a call, the kernel's stays 0."""
    model, state, h0 = series_case(formulation, TOPOLOGIES[topology],
                                   (16, 12), torch.float64, "cpu")
    K.reset_counters()
    got = cli.energies(model, state, h0)
    want = E.energy_series_reference(model, state, h0)
    assert tuple(got) == E.ENERGY_NAMES
    for name in E.ENERGY_NAMES:
        assert torch.equal(got[name], want[name]), name
    assert (E.energy_series.launches, E.energy_series_reference.calls) \
        == (0, 2)
    # the wrapper itself takes the plain version for a CPU tensor
    E.energy_series(model, state, h0)
    assert (E.energy_series.launches, E.energy_series_reference.calls) \
        == (0, 3)


def test_tile_reduction_takes_the_plain_version():
    """Under ``tile_reduction`` the series is the plain version's, each
    integral the share of the tile without its halo."""
    model, state, h0 = series_case(VI, TOPOLOGIES["periodic"], (16, 16),
                                   torch.float64, "cpu")
    whole = cli.energies(model, state, h0)
    K.reset_counters()
    with diagnostics.tile_reduction(0):
        tile = cli.energies(model, state, h0)
    assert (E.energy_series.launches, E.energy_series_reference.calls) \
        == (0, 1)
    for name in E.ENERGY_NAMES:
        assert float(tile[name]) == pytest.approx(float(whole[name]),
                                                  rel=1e-12), name


def test_run_log_line_counts_the_series(tmp_path, caplog):
    """A CPU run of three steps with the CLI's series every step: four plain
    calls (the first row, then one a step), no launch, in the closing log
    line."""
    model, state, h0 = series_case(VI, TOPOLOGIES["walled"], (16, 16),
                                   torch.float64, "cpu")
    sim = Simulation(model, dt=1e-4, stop_iteration=3)
    sim.output_writers["energies"] = ScalarSeriesWriter(
        lambda m, s: cli.energies(m, s, h0), IterationInterval(1),
        str(tmp_path / "energies.csv"))
    with caplog.at_level(logging.INFO, logger="swmhd_tpu_torch"):
        sim.run(state)
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("simulation finished")][-1]
    assert re.search(r", 0 energy series launches, 4 plain energy series "
                     r"calls, .+ of set-up\)$", line), line


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(128, 128), (72, 100)],
                         ids=["128x128", "72x100"])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_kernel_matches_plain_version(cuda, formulation, topology, shape,
                                      dtype):
    """One launch gives the plain version's five values within
    :data:`TOLERANCE`, the same values again at a second launch."""
    model, state, h0 = series_case(formulation, TOPOLOGIES[topology], shape,
                                   dtype, cuda)
    K.reset_counters()
    got = cli.energies(model, state, h0)
    again = cli.energies(model, state, h0)
    assert (E.energy_series.launches, E.energy_series_reference.calls) \
        == (2, 0)
    want = E.energy_series_reference(model, state, h0)
    assert tuple(got) == E.ENERGY_NAMES
    for name in E.ENERGY_NAMES:
        assert got[name].dtype == dtype and got[name].shape == ()
        assert torch.equal(got[name], again[name]), name
    err = relative_errors(got, want)
    assert float(err.max()) <= TOLERANCE[dtype], err.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_refuses_what_it_does_not_take(cuda, dtype):
    """On CUDA the wrapper launches or raises: a field that is not
    contiguous, or an initial height of another shape, is refused."""
    model, state, h0 = series_case(VI, TOPOLOGIES["walled"], (32, 32),
                                   dtype, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        E.energy_series(model, state.replace(u=state.u.t()), h0)
    with pytest.raises(ValueError, match="contiguous"):
        E.energy_series(model, state, h0[:16])


@pytest.mark.cuda
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_graph_chunk_replays_eager_rows_bitwise(cuda, formulation,
                                                topology):
    """Seven steps with ``cli.energies`` as replays of a 3-step and a
    1-step graph give the eager chunk's rows bit for bit; each chunk's
    replays launch the kernel once a step and the plain version never."""
    model, state, h0 = series_case(formulation, TOPOLOGIES[topology],
                                   (128, 128), torch.float32, cuda)
    state = state.replace(u=0.1 * state.u, v=0.1 * state.v)

    def series(st):
        return cli.energies(model, st, h0)

    stepper = K.KernelStepper(model)
    chunk = K.GraphChunk(stepper, 1e-4, 7, series, k=3)
    chunk(state)                    # warms and captures
    K.reset_counters()
    got, gs = chunk(state)
    assert (E.energy_series.launches, E.energy_series_reference.calls) \
        == (7, 0)
    want, ws = run_steps(stepper.one_step(1e-4), 1e-4, 7, series)(state)
    for name in E.ENERGY_NAMES:
        assert torch.equal(gs[name], ws[name]), name
    for a, b in zip(got.fields(), want.fields()):
        assert torch.equal(a, b)
