"""Simulation driver, port of :mod:`swmhd_tpu.simulation`: schedules,
callbacks, output writers and the chunked run loop.

The driver advances in chunks sized so that no schedule event falls
inside one, and fires callbacks and writers between chunks. Scalar series
are computed after every step and stay on the device for the whole
chunk: one device→host copy per chunk, never one per step.

A run on one card (or the CPU) keeps one chunk queued ahead: chunk n+1 is
launched as soon as chunk n's stepper call returns, before chunk n's rows
are copied and written and its callbacks fire (the first chunk before the
run's opening callbacks), so that the card computes while the host works.
A CUDA run's chunks go on a side stream; the series copy and the
callbacks stay on the current stream, which waits for chunk n alone. The
queued chunk is kept only if chunk n's callbacks left everything it
depends on as it was, else it is discarded unseen and launched again from
what they left (:meth:`Simulation.run`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable as _Callable, Dict, Optional

import torch

from . import tracing
from .models.state import Clock, State
from .ops.energies import energy_series, energy_series_reference
from .utils.prettytime import prettytime

logger = logging.getLogger("swmhd_tpu_torch")


class IterationInterval:
    """Fires every n iterations."""

    def __init__(self, n: int):
        self.n = int(n)

    def steps_until_due(self, iteration: int, time_: float, dt: float) -> int:
        return self.n - (iteration % self.n)

    def is_due(self, iteration: int, time_: float, dt: float) -> bool:
        return iteration % self.n == 0


class TimeInterval:
    """Fires every ``interval`` of simulated time, within Δt/2. Stateless:
    due-ness follows from the clock alone, so a resumed run fires the same
    events as an uninterrupted one."""

    def __init__(self, interval: float):
        self.interval = float(interval)

    def steps_until_due(self, iteration: int, time_: float, dt: float) -> int:
        nxt = (math.floor((time_ + 0.5 * dt) / self.interval) + 1) \
            * self.interval
        return max(1, int(math.ceil((nxt - time_) / dt - 0.5)))

    def is_due(self, iteration: int, time_: float, dt: float) -> bool:
        nearest = round(time_ / self.interval) * self.interval
        return abs(time_ - nearest) <= 0.5 * dt


@dataclasses.dataclass
class Callback:
    """``fn(simulation)`` on a schedule."""
    fn: _Callable
    schedule: object


def _to_host(d: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """One device→host copy for a dict of equally shaped tensors."""
    names = sorted(d)
    if not names:
        return {}
    with tracing.span("to_host"):
        host = torch.stack([d[n] for n in names]).cpu().tolist()
    return dict(zip(names, host))


class _Lane:
    """Where the run's chunks run. Where chunks are queued ahead on a CUDA
    card, a side stream: the current stream's reads of chunk n (the series
    copy, the callbacks, a caller's snapshots) wait for chunk n alone, not
    for chunk n+1 queued behind it; a chunk from a state the side stream
    did not make (the run's first, or one from what callbacks left) starts
    after the current stream's work so far. Each tensor made on one stream
    and read on the other is recorded on the reader's, so that the caching
    allocator hands its block out again only after the reads. Elsewhere
    (the CPU, or a run that queues nothing ahead) a chunk runs at its
    launch on the current stream."""

    def __init__(self, device: torch.device, ahead: bool):
        self.main = self.side = None
        if ahead and device.type == "cuda":
            self.main = torch.cuda.current_stream(device)
            self.side = torch.cuda.Stream(device)

    def launch(self, fn, state: State, ours: bool):
        """``(fn(state), the event of its end)``; ``ours``: ``state`` is
        the side stream's previous chunk's."""
        if self.side is None:
            return fn(state), None
        if not ours:
            self.side.wait_stream(self.main)
            for f in state.fields():
                f.record_stream(self.side)
        with torch.cuda.stream(self.side):
            out = fn(state)
        done = torch.cuda.Event()
        done.record(self.side)
        return out, done

    def arrive(self, chunk: "_Chunk"):
        """The current stream waits for ``chunk``; its output's tensors
        are the current stream's to read."""
        if chunk.done is None:
            return
        self.main.wait_event(chunk.done)
        state, series = chunk.output
        for f in list(state.fields()) + list(series.values()):
            f.record_stream(self.main)

    def drop(self, chunk: "_Chunk"):
        """Waits for a discarded chunk, so that nothing it runs (a
        stepper's CUDA graphs and their memory pool) is freed under it."""
        if chunk.done is not None:
            chunk.done.synchronize()


@dataclasses.dataclass
class _Chunk:
    """A launched chunk: ``n`` steps of ``dt`` from ``(t, it)`` through
    ``fn``, the simulation's stepper for ``n`` steps (``built`` by this
    launch)."""
    it: int
    t: float
    n: int
    dt: float
    fn: _Callable
    built: bool
    output: tuple       # (state, {name: series} or {})
    done: object        # the event of its end on a card, else None

    @property
    def end(self):
        return self.it + self.n, self.t + self.n * self.dt


def _versions(state: State):
    """The version counters of ``state``'s fields: an in-place edit
    moves them."""
    return tuple(f._version for f in state.fields())


class Simulation:
    """``stepper`` defaults to the model itself (the plain PyTorch step);
    pass a :class:`~swmhd_tpu_torch.ops.substage.KernelStepper` to run the
    CUDA kernel. Either has ``step_fn(dt, n_steps, diagnostics)``.

    A decomposed run passes a ``DomainDecomposition`` (the plain step on
    tiles) or its ``fused_stepper()`` (the CUDA tile substage) and this
    rank's tile as the state: diagnostics, written for a global state,
    then go through the stepper's ``tile_diagnostics`` and give global
    values on every rank."""

    def __init__(self, model, dt: float, stop_time: Optional[float] = None,
                 stop_iteration: Optional[int] = None, stepper=None):
        if stop_time is None and stop_iteration is None:
            raise ValueError("need stop_time or stop_iteration")
        self.model = model
        self.stepper = stepper if stepper is not None else model
        self.dt = float(dt)
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.callbacks: Dict[str, Callback] = {}
        self.output_writers: Dict[str, object] = {}
        self.state: Optional[State] = None
        self._steppers = {}
        self.run_wall_time = 0.0
        self.ahead_kept = self.ahead_discarded = 0
        self._on_tiles = getattr(self.stepper, "tile_diagnostics",
                                 lambda fn: fn)

    def diagnose(self, fn):
        """``fn(state) -> {name: 0-d tensor}`` of the current state, global
        values also when the state is a tile."""
        return self._on_tiles(fn)(self.state)

    def _series_writers(self):
        from .io.writers import ScalarSeriesWriter
        return [w for w in self.output_writers.values()
                if isinstance(w, ScalarSeriesWriter)]

    def _diag_fn(self):
        """Combined diagnostics of all ScalarSeriesWriters."""
        writers = self._series_writers()
        if not writers:
            return None
        model = self.model

        def diag(state):
            out = {}
            for w in writers:
                out.update(w.fn(model, state))
            return out
        # what a stepper names when the series cannot run in its chunk
        diag.__qualname__ = " + ".join(
            getattr(w.fn, "__qualname__", repr(w.fn)) for w in writers)
        return diag

    def _stepper(self, n_steps: int):
        fn = self._steppers.get(n_steps)
        if fn is None:
            with tracing.span("stepper_build", setup=True):
                fn = self.stepper.step_fn(self.dt, n_steps,
                                          diagnostics=self._diag_fn())
            self._steppers[n_steps] = fn
        return fn

    def _schedules(self):
        """Schedules that bound the chunk length; series writers do not
        (their rows are computed every step and subsampled on the host)."""
        series = set(id(w) for w in self._series_writers())
        for cb in self.callbacks.values():
            yield cb.schedule
        for w in self.output_writers.values():
            if id(w) not in series:
                yield w.schedule

    def _fire(self, iteration: int, t: float, force: bool = False):
        series = set(id(w) for w in self._series_writers())
        with tracing.span("fire"):
            for cb in self.callbacks.values():
                if cb.schedule.is_due(iteration, t, self.dt) or force:
                    cb.fn(self)
            for w in self.output_writers.values():
                if id(w) in series:
                    continue
                if w.schedule.is_due(iteration, t, self.dt) or force:
                    w.write(self)

    def run(self, state: State) -> State:
        """Advance to stop_time / stop_iteration, firing schedules.

        Unless the stepper is a decomposed run's (it has
        ``tile_diagnostics``), one chunk runs ahead: as soon as chunk n's
        stepper call returns, chunk n+1 is launched from its state, its
        length taken from the stop and the schedules at chunk n's end, as
        the chunk after the callbacks would take it. Then chunk n's rows
        are copied (one device→host copy) and written and its callbacks
        fire, seeing ``self.state`` as chunk n's state. The run's first
        chunk is launched so before the run's opening (every callback and
        writer, forced, and the series' first row). The queued chunk is
        kept if they left ``self.dt``, the stepper cached for its length,
        that length (a new stop or schedule) and ``self.state`` (the same
        object, no field edited in place) as they were; else it is
        discarded unseen and the next chunk launched from what they left.
        No chunk is queued past a chunk end where a
        :class:`TimeStepWizard` callback is due, nor past the opening of
        a run that has one: it changes Δt by design. A callback that
        changes anything else a chunk reads (the model, a field's values
        behind its version counter) must also change one of these. On a
        card a discarded chunk is waited for before it is dropped. A
        decomposed run queues nothing: the same loop launches each chunk
        after the previous one's callbacks, on the current stream, so
        that every rank takes the same path and no halo exchange
        overtakes a report's ``all_reduce``; so does a run under
        ``torch.inference_mode``, whose tensors keep no version counter.

        The closing log line counts the run's graph captures and stepper
        builds, the chunks queued ahead and kept, and those discarded,
        the energy series' kernel launches and plain calls
        (:mod:`~swmhd_tpu_torch.ops.energies`; graph replays count theirs,
        a discarded chunk's too) and its set-up seconds
        (:func:`tracing.setup_totals`): a Δt change
        (:class:`TimeStepWizard`) builds the stepper, and on the card
        captures its graphs, again. The two counts stay in
        ``self.ahead_kept`` and ``self.ahead_discarded``."""
        self.state = state
        t0_wall = time.perf_counter()
        setup0 = tracing.setup_totals()
        series0 = (energy_series.launches, energy_series_reference.calls)
        self.ahead_kept = self.ahead_discarded = 0

        it = int(state.clock.iteration)
        t = float(state.clock.time)
        ahead = not (hasattr(self.stepper, "tile_diagnostics")
                     or torch.is_inference_mode_enabled())
        it = self._run_chunks(it, t, self._series_writers(), ahead)

        if self.state.h.is_cuda:
            torch.cuda.synchronize(self.state.h.device)
        self.run_wall_time = time.perf_counter() - t0_wall
        setup = tracing.setup_delta(setup0)
        logger.info("simulation finished in %s (%d iterations; %d graph "
                    "captures, %d stepper builds, %d chunks queued ahead "
                    "and kept, %d discarded, %d energy series launches, "
                    "%d plain energy series calls, %s of set-up)",
                    prettytime(self.run_wall_time), it,
                    setup.get("swmhd.graph_capture", (0,))[0],
                    setup.get("swmhd.stepper_build", (0,))[0],
                    self.ahead_kept, self.ahead_discarded,
                    energy_series.launches - series0[0],
                    energy_series_reference.calls - series0[1],
                    prettytime(sum(s for _, s in setup.values())))
        for w in self.output_writers.values():
            w.close()
        return self.state

    def _open(self, it: int, t: float, series_writers):
        """The run's opening: every callback and writer, and the series'
        first row."""
        self._fire(it, t, force=True)
        if series_writers:
            diag0 = _to_host(self.diagnose(self._diag_fn()))
            for w in series_writers:
                w.write_series([t], [it], {k: [v] for k, v in diag0.items()})

    def _chunk_steps(self, it: int, t: float) -> int:
        """The next chunk's length from ``(it, t)``: up to the stop or the
        first schedule event; 0 at the stop."""
        remaining = self._steps_remaining(it, t)
        if remaining <= 0:
            return 0
        n = remaining
        for s in self._schedules():
            n = min(n, s.steps_until_due(it, t, self.dt))
        return max(1, n)

    def _write_rows(self, series_writers, it, t, dt, n, series):
        """The rows of a chunk of ``n`` steps of ``dt`` from ``(it, t)``."""
        times = [t + dt * k for k in range(1, n + 1)]
        iters = [it + k for k in range(1, n + 1)]
        with tracing.span("series_write"):
            for w in series_writers:
                w.write_series(times, iters, series)

    def _launch(self, lane: _Lane, state: State, it: int, t: float,
                ours: bool = False):
        """The chunk from ``state`` at ``(it, t)``, launched; None at the
        stop. ``ours``: ``state`` is the previous chunk's output."""
        n = self._chunk_steps(it, t)
        if n == 0:
            return None
        built = n not in self._steppers
        with tracing.span("step"):
            fn = self._stepper(n)
            # the host's f64 time is exact; the chunk counts from it
            out, done = lane.launch(fn, state.replace(clock=Clock(t, it)),
                                    ours)
        if not isinstance(out, tuple):
            out = (out, {})
        return _Chunk(it, t, n, self.dt, fn, built, out, done)

    def _wizard_due(self, it: int, t: float, force: bool = False) -> bool:
        return any(isinstance(cb.fn, TimeStepWizard)
                   and (force or cb.schedule.is_due(it, t, self.dt))
                   for cb in self.callbacks.values())

    def _keeps(self, queued: _Chunk, state: State, versions) -> bool:
        """Whether the callbacks left what ``queued`` read as it was."""
        it, t = queued.it, queued.t
        return (self.state is state and _versions(state) == versions
                and self.dt == queued.dt
                and self._steppers.get(queued.n) is queued.fn
                and self._chunk_steps(it, t) == queued.n)

    def _settle(self, lane: _Lane, queued, state: State, versions, it: int,
                t: float):
        """After the callbacks at ``(it, t)``: ``queued``, launched from
        ``state`` before they fired, if they left what it read as it was
        (counted kept); else (counted discarded where there was one) the
        chunk launched from what they left, with a stepper built after
        them where the discarded chunk built its own."""
        if queued is not None:
            if self._keeps(queued, state, versions):
                self.ahead_kept += 1
                return queued
            self.ahead_discarded += 1
            lane.drop(queued)
            if queued.built and self._steppers.get(queued.n) is queued.fn:
                del self._steppers[queued.n]
        return self._launch(lane, self.state, it, t)

    def _run_chunks(self, it, t, series_writers, ahead: bool) -> int:
        """The run's chunks; with ``ahead`` one queued ahead of the
        callbacks that precede it: the run's first ahead of the run's
        opening, each next one ahead of the previous chunk's rows and
        callbacks (:meth:`run`). Without, each chunk is launched after
        them."""
        lane = _Lane(self.state.h.device, ahead)
        state = self.state
        queued = None
        if ahead and not self._wizard_due(it, t, force=True):
            queued = self._launch(lane, state, it, t)
        versions = _versions(state) if ahead else None
        self._open(it, t, series_writers)
        chunk = self._settle(lane, queued, state, versions, it, t)
        while chunk is not None:
            with tracing.span("chunk"):
                lane.arrive(chunk)
                state, series = chunk.output
                it, t = chunk.end
                queued = None
                if ahead and not self._wizard_due(it, t):
                    queued = self._launch(lane, state, it, t, ours=True)
                self.state = state
                if series_writers:
                    self._write_rows(series_writers, chunk.it, chunk.t,
                                     chunk.dt, chunk.n, _to_host(series))
                # no version counter under inference mode
                versions = _versions(state) if ahead else None
                self._fire(it, t)
                chunk = self._settle(lane, queued, state, versions, it, t)
        return it

    def _steps_remaining(self, it: int, t: float) -> int:
        n = 10 ** 12
        if self.stop_iteration is not None:
            n = min(n, self.stop_iteration - it)
        if self.stop_time is not None:
            n = min(n, int(round((self.stop_time - t) / self.dt)))
        return n


class TimeStepWizard:
    """Adaptive Δt toward a target CFL: attach as a Callback; it rescales
    ``sim.dt`` by ``cfl / current`` clipped to ``[min_change,
    max_change]``, then to ``[min_dt, max_dt]``, where ``current`` is the
    larger of :func:`~swmhd_tpu_torch.diagnostics.cfl_numbers`. A change
    clears the simulation's steppers (a kernel stepper's step closes over
    Δt).

    The maxima come from ``sim.diagnose``: global on every rank of a
    decomposed run (a MAX all-reduce, exact, so every rank takes the same
    Δt), on the device until one device→host copy per adjustment. Each
    call reads ``sim.model``, so a wizard attached to another simulation
    uses that model's grid spacings."""

    def __init__(self, cfl: float = 0.7, max_change: float = 1.1,
                 min_change: float = 0.5, min_dt: float = 0.0,
                 max_dt: Optional[float] = None):
        self.cfl = cfl
        self.max_change = max_change
        self.min_change = min_change
        self.min_dt = min_dt
        self.max_dt = max_dt

    def __call__(self, sim: "Simulation"):
        from . import diagnostics
        model = sim.model
        maxima = _to_host(sim.diagnose(
            lambda s: diagnostics.cfl_maxima(model, s)))
        adv, wave = diagnostics.cfl_of_maxima(model, maxima, sim.dt)
        current = max(adv, wave)
        if current <= 0:
            return
        factor = min(self.max_change,
                     max(self.min_change, self.cfl / current))
        new_dt = sim.dt * factor
        if self.max_dt is not None:
            new_dt = min(new_dt, self.max_dt)
        new_dt = max(new_dt, self.min_dt)
        if abs(new_dt - sim.dt) / sim.dt > 1e-12:
            logger.info("TimeStepWizard: dt %.3e -> %.3e (CFL %.3f)",
                        sim.dt, new_dt, current)
            sim.dt = new_dt
            sim._steppers.clear()


def progress_callback(h0=None):
    """Logs time, iteration, max|u|, max A, min h and the wall time per
    interval; one device→host copy per report. ``h0`` is accepted, as in
    the JAX package, and not used."""
    last_wall = [time.perf_counter()]

    def cb(sim: Simulation):
        from . import diagnostics
        st = sim.state

        def extrema(s):
            u, v = sim.model.velocities(s)
            return diagnostics.extrema_report(u, v, s.h, s.A, sim.model.grid)
        rep = _to_host(sim.diagnose(extrema))
        now = time.perf_counter()
        logger.info(
            "Time: %12s, iteration: %d, max(|u|): %.2e, max(A): %.2e, "
            "min(h): %.2e, wall time: %s",
            prettytime(st.clock.time), st.clock.iteration,
            rep["max_abs_u"], rep["max_A"], rep["min_h"],
            prettytime(now - last_wall[0]))
        last_wall[0] = now

    return cb
