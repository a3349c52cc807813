"""swmhd_tpu_torch.tracing: the spans of ``Simulation.run`` and the
stepper on the profiler's clock, and the set-up totals.

- With no profiler a warmed run records no range and adds no set-up.
- Under ``profiling.trace`` a CPU run with an energy series and a
  progress report gives one ``swmhd.chunk`` a loop iteration, holding the
  next chunk's ``swmhd.step`` (none in the last; the first chunk's comes
  before the loop), the series' ``swmhd.to_host``, one
  ``swmhd.series_write`` and one ``swmhd.fire`` that holds the report's
  ``swmhd.to_host``; the host operators of each copy lie inside its
  ``swmhd.to_host``.
- Nested set-up spans count each second once.
- The closing log line counts the stepper builds a ``TimeStepWizard``
  causes at each Δt change.
- On the card (``cuda``): a ``GraphChunk`` captures once, its replays are
  ``swmhd.graph_replay`` spans holding their ``cudaGraphLaunch``, and the
  series' device→host copy lies inside ``swmhd.to_host``.
"""

import gzip
import json
import logging
import re

import pytest
import torch

from swmhd_tpu_torch import (Callback, Grid, IterationInterval,
                             ShallowWaterModel, Simulation, TimeStepWizard,
                             cli, profiling, scenarios, tracing)
from swmhd_tpu_torch.io import ScalarSeriesWriter
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.simulation import progress_callback

torch.set_num_threads(1)

CHUNK_STEPS, CHUNKS = 2, 3


def small_model(N=16, g_acc=1.0):
    g = Grid.regular(N, N, (0, 1), (0, 1), dtype=torch.float64,
                     device="cpu")
    return ShallowWaterModel(grid=g, momentum_advection="centered2",
                             mass_advection="centered2",
                             tracer_advection="centered2",
                             gravitational_acceleration=g_acc)


def with_series(sim, state, path):
    """``sim`` with a new writer of the CLI's energies every step (a run
    closes its writers)."""
    h0 = state.h.clone()
    sim.output_writers["energies"] = ScalarSeriesWriter(
        lambda m, s: cli.energies(m, s, h0), IterationInterval(1), str(path))
    return sim


def series_run(tmp_path, model):
    """A simulation of ``CHUNKS`` chunks of ``CHUNK_STEPS`` steps with the
    CLI's energies every step and a progress report every chunk."""
    sim = Simulation(model, dt=1e-3, stop_iteration=CHUNKS * CHUNK_STEPS)
    state = model.initial_state(h=1.0)
    with_series(sim, state, tmp_path / "energies.csv")
    sim.callbacks["progress"] = Callback(progress_callback(),
                                         IterationInterval(CHUNK_STEPS))
    return sim, state


def trace_events(path):
    with gzip.open(path, "rt") as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def bounds(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def inside(e, outer):
    (a, b), (c, d) = bounds(e), bounds(outer)
    return c <= a and b <= d and e is not outer


def spans(events, name=None):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(tracing.PREFIX)
            and (name is None or e["name"] == tracing.PREFIX + name)]


def test_no_profiler_records_nothing(tmp_path, monkeypatch):
    """A second run of a warmed simulation with no profiler opens no
    range and adds nothing to the set-up totals: no hot span is a set-up
    span."""
    sim, state = series_run(tmp_path, small_model())
    sim.run(state)
    ranges = []
    real = tracing._profiler.record_function

    def counted(name, *a, **kw):
        ranges.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(tracing._profiler, "record_function", counted)
    before = tracing.setup_totals()
    with_series(sim, state, tmp_path / "again.csv").run(state)
    assert ranges == []
    assert tracing.setup_totals() == before


def test_spans_of_a_series_run_nest_in_their_chunk(tmp_path):
    """The run-ahead nesting: the first chunk's ``swmhd.step`` precedes
    every ``swmhd.chunk`` and holds the run's one stepper build; each
    chunk but the last holds the next chunk's ``swmhd.step``, launched
    before its own series' ``swmhd.to_host``; every chunk holds that copy,
    one ``swmhd.series_write`` and one ``swmhd.fire`` that holds the
    report's ``swmhd.to_host``."""
    sim, state = series_run(tmp_path, small_model())
    with profiling.trace(str(tmp_path / "prof")):
        sim.run(state)
    ev = trace_events(tmp_path / "prof" / profiling.TRACE_FILE)
    chunks = sorted(spans(ev, "chunk"), key=lambda e: float(e["ts"]))
    assert len(chunks) == CHUNKS
    assert len(spans(ev, "step")) == CHUNKS
    for k, chunk in enumerate(chunks):
        held = [e for e in spans(ev) if inside(e, chunk)
                and e["name"] != "swmhd.stepper_build"]
        names = sorted(e["name"] for e in held)
        mine = ("to_host", "to_host", "series_write", "fire")
        if k < CHUNKS - 1:
            mine += ("step",)
        assert names == sorted(tracing.PREFIX + n for n in mine), names
        fire, = [e for e in held if e["name"] == "swmhd.fire"]
        in_fire = [e["name"] for e in held if inside(e, fire)]
        assert in_fire == ["swmhd.to_host"]
        copy, = [e for e in held if e["name"] == "swmhd.to_host"
                 and not inside(e, fire)]
        for name in ("step", "series_write"):
            for span in [e for e in held
                         if e["name"] == tracing.PREFIX + name]:
                assert not inside(span, fire)
                if name == "step":
                    assert bounds(span)[1] <= bounds(copy)[0]
    # the run's one set-up span: the stepper's build, in the first
    # chunk's step, which comes before the first chunk
    first = [e for e in spans(ev, "step")
             if bounds(e)[1] <= bounds(chunks[0])[0]]
    assert len(first) == 1
    build, = spans(ev, "stepper_build")
    assert inside(build, first[0])


def test_host_copy_lies_inside_its_to_host_span(tmp_path):
    """The shared clock: each ``swmhd.to_host`` holds the host operator
    that gathers its values (``aten::stack``) and nothing of it lies
    outside one."""
    sim, state = series_run(tmp_path, small_model())
    with profiling.trace(str(tmp_path / "prof")):
        sim.run(state)
    ev = trace_events(tmp_path / "prof" / profiling.TRACE_FILE)
    to_host = spans(ev, "to_host")
    # one a chunk for the series, one a report, and the run's first
    # series row and report before the loop
    assert len(to_host) == 2 * CHUNKS + 2
    stacks = [e for e in ev if e.get("cat") == "cpu_op"
              and e["name"] == "aten::stack"]
    for span in to_host:
        assert any(inside(op, span) for op in stacks)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def test_nested_setup_spans_count_each_second_once(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(tracing, "time", clock)
    before = tracing.setup_totals()
    with tracing.span("test_outer", setup=True):
        clock.now += 1.0
        with tracing.span("test_inner", setup=True):
            clock.now += 2.0
            with tracing.span("test_inner", setup=True):
                clock.now += 4.0
        clock.now += 8.0
    got = tracing.setup_delta(before)
    assert got == {"swmhd.test_outer": (1, 9.0),
                   "swmhd.test_inner": (2, 6.0)}
    assert sum(s for _, s in got.values()) == 15.0


def test_setup_span_is_a_range_while_profiling(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with tracing.span("test_ready", setup=True):
            torch.ones(3).sum()
    ev = trace_events(tmp_path / "prof" / profiling.TRACE_FILE)
    span, = spans(ev, "test_ready")
    assert any(e.get("cat") == "cpu_op" and inside(e, span) for e in ev)


def test_log_line_counts_the_wizards_stepper_builds(caplog):
    """Δt = 0.5, grossly over the wave CFL: the wizard shrinks it before
    the first chunk and again after it, then keeps it, so the four
    one-step chunks build two steppers, and the closing log line says
    so."""
    model = small_model(N=32)
    builds = []

    class Spy:
        def step_fn(self, dt, n_steps=1, diagnostics=None):
            builds.append(dt)
            return model.step_fn(dt, n_steps, diagnostics=diagnostics)
    sim = Simulation(model, dt=0.5, stop_iteration=4, stepper=Spy())
    sim.callbacks["wizard"] = Callback(
        TimeStepWizard(cfl=0.5, min_change=0.1), IterationInterval(1))
    before = tracing.setup_totals()
    with caplog.at_level(logging.INFO, logger="swmhd_tpu_torch"):
        sim.run(model.initial_state(h=1.0))
    assert len(builds) == 2 and builds[0] > builds[1]
    assert tracing.setup_delta(before)["swmhd.stepper_build"][0] == 2
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("simulation finished")][-1]
    assert re.search(r"\(4 iterations; 0 graph captures, 2 stepper builds, "
                     r".+ of set-up\)$", line), line


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graph_chunk_capture_and_replay_spans(cuda, tmp_path):
    """A 128² series run in 100-step graphs: the first chunk warms and
    captures once, later chunks capture nothing; each ``swmhd.step``
    holds one ``swmhd.graph_replay``, which holds the ``cudaGraphLaunch``
    whose kernels carry its correlation; the series' device→host copy
    lies inside ``swmhd.to_host``."""
    model, state, sc = scenarios.build("128x128_two_Gaussians_high_B",
                                       device=cuda)
    sim = Simulation(model, dt=sc.dt, stop_iteration=300,
                     stepper=K.KernelStepper(model))
    with_series(sim, state, tmp_path / "energies.csv")
    sim.callbacks["progress"] = Callback(progress_callback(),
                                         IterationInterval(100))
    before = tracing.setup_totals()
    sim.run(state)
    got = tracing.setup_delta(before)
    assert got["swmhd.graph_capture"][0] == 1
    assert got["swmhd.graph_warm"][0] == 1
    assert got["swmhd.stepper_build"][0] == 1
    before = tracing.setup_totals()
    with_series(sim, state, tmp_path / "again.csv")
    with profiling.trace(str(tmp_path / "prof")):
        sim.run(state)
    assert "swmhd.graph_capture" not in tracing.setup_delta(before)
    ev = trace_events(tmp_path / "prof" / profiling.TRACE_FILE)
    replays = spans(ev, "graph_replay")
    assert len(replays) == 3
    launches = [e for e in ev if e.get("cat") == "cuda_runtime"
                and e["name"].startswith("cudaGraphLaunch")]
    assert len(launches) == 3
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    for replay in replays:
        step, = [s for s in spans(ev, "step") if inside(replay, s)]
        launch, = [e for e in launches if inside(e, replay)]
        corr = launch["args"]["correlation"]
        assert sum(k["args"].get("correlation") == corr
                   for k in kernels) > 100
    # the series' and the report's device→host copies: each runtime call
    # lies inside a swmhd.to_host
    to_host = spans(ev, "to_host")
    calls = {e["args"].get("correlation"): e for e in ev
             if e.get("cat") == "cuda_runtime" and "args" in e}
    copies = [e for e in ev if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e["name"]]
    assert len(copies) >= 6
    for c in copies:
        call = calls[c["args"]["correlation"]]
        assert any(inside(call, s) for s in to_host), call["name"]
