"""Simulation driver, port of :mod:`swmhd_tpu.simulation`: schedules,
callbacks, output writers and the chunked run loop.

The driver advances in chunks sized so that no schedule event falls
inside one, and fires callbacks and writers between chunks. Scalar series
are computed after every step and stay on the device for the whole
chunk: one device→host copy per chunk, never one per step.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable as _Callable, Dict, Optional

import torch

from .models.state import Clock, State
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
    host = torch.stack([d[n] for n in names]).cpu().tolist()
    return dict(zip(names, host))


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
        for cb in self.callbacks.values():
            if cb.schedule.is_due(iteration, t, self.dt) or force:
                cb.fn(self)
        for w in self.output_writers.values():
            if id(w) in series:
                continue
            if w.schedule.is_due(iteration, t, self.dt) or force:
                w.write(self)

    def run(self, state: State) -> State:
        """Advance to stop_time / stop_iteration, firing schedules."""
        self.state = state
        t0_wall = time.perf_counter()

        it = int(state.clock.iteration)
        t = float(state.clock.time)
        series_writers = self._series_writers()
        self._fire(it, t, force=True)
        if series_writers:
            diag0 = _to_host(self.diagnose(self._diag_fn()))
            for w in series_writers:
                w.write_series([t], [it], {k: [v] for k, v in diag0.items()})

        while True:
            remaining = self._steps_remaining(it, t)
            if remaining <= 0:
                break
            n = remaining
            for s in self._schedules():
                n = min(n, s.steps_until_due(it, t, self.dt))
            n = max(1, n)
            # the host's f64 time is exact; the chunk counts from it
            self.state = self.state.replace(clock=Clock(t, it))
            out = self._stepper(n)(self.state)
            if series_writers:
                self.state, series = out
                times = [t + self.dt * k for k in range(1, n + 1)]
                iters = [it + k for k in range(1, n + 1)]
                series = _to_host(series)
                for w in series_writers:
                    w.write_series(times, iters, series)
            else:
                self.state = out
            it += n
            t += n * self.dt
            self._fire(it, t)

        if self.state.h.is_cuda:
            torch.cuda.synchronize(self.state.h.device)
        self.run_wall_time = time.perf_counter() - t0_wall
        logger.info("simulation finished in %s (%d iterations)",
                    prettytime(self.run_wall_time), it)
        for w in self.output_writers.values():
            w.close()
        return self.state

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
