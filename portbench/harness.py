"""One run of one benchmark cell: ``Simulation.run`` of the port as the
CLI assembles it, timed chunk by chunk, traced on request, and compared
with the plain reference once the window has closed.

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); its own file
(``portbench/workloads/<cell>.json``) holds the comparison's parameters
and limits. Per-layer metrics are readers ``portbench/metrics/<name>.py``.
Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Callable, Optional

import torch

from . import forbidden_modules
from . import traffic as traffic_gen
from . import tracefile
from .check import REACH, Judge, decide
from .roofline import DTYPES

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: str = ROOT, pkg: str = PKG) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files under
    ``pkg``; the metrics are those the cell reports (a metric with a
    ``workloads`` list only in the cells it lists)."""
    bench = load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{', '.join(sorted(cells))}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def here(m):
        return name in m.get("workloads", (name,))
    return Cell(name=name, chips=int(w["chips"]),
                config=load(os.path.join(root, conf["file"])),
                traffic=load(os.path.join(pkg, "traffic",
                                          w["traffic"] + ".json")),
                check=load(os.path.join(pkg, "workloads", name + ".json")),
                end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])


# -- the program under test ---------------------------------------------------------

def build_program(cell: Cell, perturb: dict, device: str):
    """``(model, state)``: the traffic's scenario as
    ``scenarios.build`` makes it, on the traffic's grid, in the
    configuration's dtype (float32 or float64), with the seeded bumps
    added to h and A."""
    conf, tr = cell.config, cell.traffic
    if conf["dtype"] not in DTYPES:
        raise ValueError(f"{conf['name']}: the benchmark takes a dtype of "
                         f"{' or '.join(DTYPES)}; the configuration states "
                         f"{conf['dtype']!r}")
    from swmhd_tpu_torch import scenarios
    from swmhd_tpu_torch.forcing import (divergence_lorentz_forcing,
                                         jacobian_lorentz_forcing)
    from swmhd_tpu_torch.grid import Grid
    from swmhd_tpu_torch.models.shallow_water import ShallowWaterModel
    from swmhd_tpu_torch.physics.coriolis import FPlane

    sc = scenarios.get(tr["scenario"])
    ini = tr["initial"]
    if (sc.h0, sc.A_bg_grad_y, sc.topology[1]) != (
            ini["h0"], ini["A_bg_grad_y"], ini["topology_y"]):
        raise ValueError(f"{tr['scenario']}: h0, the A gradient and the y "
                         f"topology are ({sc.h0}, {sc.A_bg_grad_y}, "
                         f"{sc.topology[1]}), the traffic states {ini}")
    if conf["closure"] is not None:
        raise ValueError("the benchmark builds no closure")
    N, L = int(tr["N"]), float(conf["L"])
    dtype = getattr(torch, conf["dtype"])
    grid = Grid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                        topology=sc.topology, dtype=dtype, device=device)
    lorentz = {"jacobian": jacobian_lorentz_forcing,
               "divergence": divergence_lorentz_forcing}[conf["lorentz"]]
    model = ShallowWaterModel(
        grid=grid, formulation=conf["formulation"],
        gravitational_acceleration=conf["g"], coriolis=FPlane(f=conf["f"]),
        momentum_advection=conf["momentum_advection"],
        mass_advection=conf["mass_advection"],
        tracer_advection=conf["tracer_advection"],
        vector_invariant_stencil=conf.get("vector_invariant_stencil",
                                          "velocity"),
        closure=None, forcing=lorentz(sc.A_bg_grad_y),
        A_background_gradient_y=sc.A_bg_grad_y)
    u0, v0 = sc.u0, sc.v0
    if conf["formulation"] == "conservative" and u0 is not None:
        u0 = lambda x, y: sc.u0(x, y) * sc.h0   # noqa: E731
        v0 = lambda x, y: sc.v0(x, y) * sc.h0   # noqa: E731
    state = model.initial_state(u=u0, v=v0, h=sc.h0, A=sc.A0)

    def bumps(spec):
        def fn(x, y):
            out = torch.zeros_like(x)
            for x0, y0, a, w in spec:
                out = out + a * torch.exp(-((x - x0) ** 2 + (y - y0) ** 2)
                                          / w ** 2)
            return out
        return grid.evaluate(fn, "cc")
    return model, state.replace(h=state.h + bumps(perturb["h"]),
                                A=state.A + bumps(perturb["A"]))


def _stacked(state):
    return torch.stack(state.fields()).clone()


class Recorder:
    """Chunk times, snapshots for the comparison and the traced chunks,
    driven by the progress callback's wrapper (every chunk ends in a
    progress report). The window closes at the first chunk's end past
    ``seconds``; in a traced run ``trace_chunks`` chunks follow it under
    the profiler, inside one scenario run and none its first, so that the
    profiler's start, stop and after-effects touch none of the window.

    Ranks of a decomposed run each drive one: ``agree`` puts rank 0's
    decision to close in every rank's place (from it the traced chunks
    and the end follow alike on all), and ``snapshot``, a collective
    there, is taken at the same chunks on all."""

    def __init__(self, seconds, checked, trace_chunks=0, chunk_steps=1,
                 run_steps=1, on_trace=None, snapshot=_stacked,
                 agree=bool):
        if trace_chunks and (trace_chunks + 1) * chunk_steps > run_steps:
            raise ValueError(f"{trace_chunks} traced chunks, none a run's "
                             f"first, do not fit in a run of {run_steps} "
                             f"steps")
        self.seconds = seconds
        self.checked = set(checked)
        self.trace_chunks = trace_chunks
        self.chunk_steps, self.run_steps = chunk_steps, run_steps
        self.on_trace = on_trace          # fn(start: bool)
        self.snapshot = snapshot          # fn(state) -> what is compared
        self.agree = agree                # fn(this clock's close) -> close
        self.profiling = False            # the profiler runs
        self.traced_from = None           # the first traced chunk
        self.timing = False
        self.t0 = self.t_end = None       # the window's open and close
        self.n_window = None              # chunks completed in the window
        self.chunks = []                  # (start, end, steps)
        self.spans = []                   # per chunk {name: seconds}
        self.pre, self.post, self.rows = {}, {}, {}
        self.mark = None                  # (time, iteration) of the start
        self.open = {}
        self.done = False

    def start_run(self, now):
        self.mark = (now, 0)
        self.open = {}

    def span(self, name, seconds):
        if self.timing:
            self.open[name] = self.open.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def annotate(self, name):
        """A profiler annotation of the harness's span, while the profiler
        runs."""
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield

    def _room(self, it):
        """Whether the traced chunks fit in this scenario run from
        iteration ``it``, none of them its first."""
        return (it > 0 and it + self.trace_chunks * self.chunk_steps
                <= self.run_steps)

    def boundary(self, sim, now):
        """After a progress report: the end of a chunk, or at iteration 0
        the start of a scenario run."""
        it = int(sim.state.clock.iteration)
        if not self.timing:
            return
        k = len(self.chunks)
        if it != self.mark[1]:
            start, it0 = self.mark
            self.chunks.append((start, now, it - it0))
            self.spans.append(self.open)
            self.open = {}
            if k in self.checked:
                self.post[k] = self.snapshot(sim.state)
            k += 1
            if self.t_end is None and self.agree(now - self.t0
                                                 >= self.seconds):
                self.t_end, self.n_window = now, k
            if self.t_end is not None:
                if (self.profiling
                        and k >= self.traced_from + self.trace_chunks):
                    self.on_trace(False)
                if (self.trace_chunks and self.traced_from is None
                        and self._room(it)):
                    self.on_trace(True)
                    self.traced_from = k
                    # the traced chunk starts once the profiler runs
                    now = time.perf_counter()
                elif not self.profiling and (self.traced_from is not None
                                             or not self.trace_chunks):
                    self.done = True
                    sim.stop_iteration = it
                    return
            self.mark = (now, it)
        # at iteration 0 the run's first chunk counts from start_run
        if k in self.checked:
            self.pre[k] = (self.snapshot(sim.state), it)

    def want_rows(self):
        """Whether the series rows now being written are of a checked
        chunk."""
        return self.timing and len(self.chunks) in self.checked


def _series_writer_class():
    from swmhd_tpu_torch.io import ScalarSeriesWriter

    class Kept(ScalarSeriesWriter):
        """The CLI's series writer, keeping the host rows of the checked
        chunks and timing its writes."""

        def __init__(self, recorder, *a, **kw):
            super().__init__(*a, **kw)
            self.recorder = recorder

        def write_series(self, times, iterations, series):
            t = time.perf_counter()
            rec = self.recorder
            with rec.annotate("portbench.series_write"):
                super().write_series(times, iterations, series)
            if rec.want_rows():
                rec.rows[len(rec.chunks)] = {n: list(v)
                                             for n, v in series.items()}
            rec.span("series_write", time.perf_counter() - t)
    return Kept


class TimedStepper:
    """The stepper the CLI selects, with a span around each chunk's call;
    while the profiler runs the span waits for the device, so that the
    loop's self time in the traced chunks is the host's own. Outside them
    the stepper runs as the CLI runs it."""

    def __init__(self, inner, recorder):
        self.inner, self.recorder = inner, recorder
        if hasattr(inner, "tile_diagnostics"):
            # a decomposed stepper's: the simulation's reports are global
            self.tile_diagnostics = inner.tile_diagnostics

    def step_fn(self, dt, n_steps=1, diagnostics=None):
        fn = self.inner.step_fn(dt, n_steps, diagnostics=diagnostics)

        def timed(state):
            t = time.perf_counter()
            with self.recorder.annotate("portbench.stepper"):
                out = fn(state)
                if self.recorder.profiling and state.h.is_cuda:
                    torch.cuda.synchronize(state.h.device)
            self.recorder.span("stepper", time.perf_counter() - t)
            return out
        return timed


@dataclasses.dataclass
class Outcome:
    line: dict                     # None on a rank other than 0
    readings: list                 # the program's numbers, a checked chunk
    others: dict                   # what took the program's place -> its
                                   # {correct, checks, readings}
    snapshots: dict = dataclasses.field(default_factory=dict)
                                   # with keep_snapshots: checked chunk ->
                                   # the state (a rank's tile) at its end


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             stepper_hook: Optional[Callable] = None,
             series_hook: Optional[Callable] = None,
             work_dir: Optional[str] = None, others=(), ranks=None,
             keep_snapshots: bool = False) -> Outcome:
    """One run: set-up, the window, the comparison and the metrics.

    With ``ranks`` (:class:`portbench.ranks.Ranks`) this process is one
    rank of a decomposed run, built as ``cli.cmd_run`` builds it under
    ``torchrun``: the global model and state, ``cli._decomposition``,
    this rank's tile, the stepper ``cli.select_stepper(model, dd=dd)``.
    Rank 0's clock closes the window for all; every rank traces its card
    and compares its own tile; rank 0's trace gives the per-layer
    metrics, and its line the result, ``device`` over all the ranks.

    ``stepper_hook(stepper, model)`` and ``series_hook(fn)`` replace what
    the CLI would select (tests plant faults through them). ``others``
    puts each of its entries in the program's place and judges it as the
    program is judged: a dtype, the reference computed in it (the
    control); ``"plain"``, the port's own plain step of the
    configuration's dtype from the program's state (a second witness;
    ``portbench/calibrate.py``)."""
    from swmhd_tpu_torch import cli
    from swmhd_tpu_torch.ops import substage as K
    from swmhd_tpu_torch.simulation import (Callback, IterationInterval,
                                            Simulation, progress_callback)

    on_card = torch.device(device).type == "cuda"
    marks = {}

    def mark(name):
        if on_card:
            torch.cuda.synchronize()
        marks[name] = time.perf_counter() - t_start

    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    mark("card")
    tr = cell.traffic
    perturb = traffic_gen.perturbation(tr["perturbation"], seed)
    checked = traffic_gen.checked_chunks(cell.check, seed)
    model, state0 = build_program(cell, perturb, device)
    h0 = state0.h
    n_points = int(tr["N"]) ** 2
    dd, tile_points, chips = None, None, 1 if on_card else 0
    if ranks is not None:
        h0 = None
        dd, state0 = ranks.decompose(
            cell, model, state0,
            3 * REACH * int(tr["progress_every"]))
        tile_points, chips = dd.nx * dd.ny, ranks.world if on_card else 0
    mark("model")

    profiler = {}

    def on_trace(start):
        if start:
            if on_card:
                torch.cuda.synchronize()
            profiler["counts"] = (K.substage.launches, K.multistep.launches)
            profiler["first"] = len(rec.chunks)
            p = torch.profiler.profile(activities=tracefile.activities())
            p.start()
            profiler["prof"] = p
            rec.profiling = True
        elif rec.profiling:
            if on_card:
                torch.cuda.synchronize()
            profiler["prof"].stop()
            rec.profiling = False
            profiler["stopped"] = len(rec.chunks)
            profiler["counts"] = tuple(
                b - a for a, b in zip(profiler["counts"],
                                      (K.substage.launches,
                                       K.multistep.launches)))

    chunk_steps = int(tr["progress_every"])
    rec = Recorder(seconds, checked,
                   trace_chunks=int(tr["trace"]["chunks"]) if trace else 0,
                   chunk_steps=chunk_steps,
                   run_steps=round(float(tr["stop_time"]) / float(tr["dt"])),
                   on_trace=on_trace,
                   snapshot=_stacked if ranks is None else ranks.snapshot,
                   agree=bool if ranks is None else ranks.agree)

    stepper = cli.select_stepper(model, dd=dd)[0]
    if stepper is None:
        stepper = model
    if stepper_hook is not None:
        stepper = stepper_hook(stepper, model)
    sim = Simulation(model, dt=float(tr["dt"]),
                     stop_time=float(tr["stop_time"]),
                     stepper=TimedStepper(stepper, rec))
    progress = progress_callback()

    def report(s):
        t = time.perf_counter()
        with rec.annotate("portbench.progress"):
            progress(s)
        now = time.perf_counter()
        rec.span("progress", now - t)
        rec.boundary(s, now)
    sim.callbacks["progress"] = Callback(report,
                                         IterationInterval(chunk_steps))

    # the series file and the trace: a directory of this run's own under
    # TMPDIR, removed at the end
    work = work_dir or tempfile.mkdtemp(prefix="portbench-")
    os.makedirs(work, exist_ok=True)
    series_path = os.path.join(work, "energies.csv")
    series_fn = None
    if tr.get("series_every"):
        def series_fn(model, state):
            return cli.energies(model, state, h0)
        if series_hook is not None:
            series_fn = series_hook(series_fn)
    Kept = _series_writer_class()

    def one_run():
        if series_fn is not None:
            sim.output_writers["energies"] = Kept(
                rec, fn=series_fn,
                schedule=IterationInterval(int(tr["series_every"])),
                path=series_path)
        rec.start_run(time.perf_counter())
        sim.run(state0)
        if os.path.exists(series_path):
            os.remove(series_path)

    # set-up: every shape the window uses, from the same initial state
    sim.stop_iteration = int(tr.get("warm_chunks", 2)) * chunk_steps
    one_run()
    sim.stop_iteration = None
    if ranks is not None:
        ranks.settle()
    mark("warm")

    rec.timing = True
    rec.t0 = time.perf_counter()
    setup_s = rec.t0 - t_start
    while not rec.done:
        one_run()
    if on_card:
        torch.cuda.synchronize()
    t_end, window = rec.t_end, rec.chunks[:rec.n_window]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules that must not load were loaded: "
                         f"{', '.join(bad)}")
    print("setup_phases_s " + " ".join(f"{k} {v!r}" for k, v in marks.items())
          + f" window {setup_s!r}", file=sys.stderr, flush=True)

    kernel_kind = torch.cuda.get_device_name() if on_card else "cpu"
    trace_path = tf = None
    if "prof" in profiler:
        trace_path = os.path.join(work, "trace.json")
        profiler["prof"].export_chrome_trace(trace_path)
        tf = tracefile.Trace(trace_path)
        os.remove(trace_path)
    busy = (tf.busy_s(), tf.window_s()) if tf is not None else None
    if ranks is not None:
        # the fullest card's peak, each card's busy and traced seconds
        mine = {"peak": int(peak), "busy": busy}
        every = ranks.gather(mine)
        peak = max(r["peak"] for r in every)
        if busy is not None:
            busy = tuple(statistics.mean(r["busy"][i] for r in every)
                         for i in (0, 1))
        if ranks.rank != 0:
            tf = None
    # free the program's state before the reference runs
    dtype = state0.h.dtype
    del sim, stepper, state0, model, dd
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t_ref = time.perf_counter()
    judge = Judge(cell, perturb, device,
                  None if ranks is None else ranks.block)
    checks, failed, readings = judge.compare(rec)
    print(f"reference_s {time.perf_counter() - t_ref!r} reference_peak_bytes "
          f"{torch.cuda.max_memory_allocated() if on_card else 0}",
          file=sys.stderr)
    for r in readings:
        print("checked " + " ".join(f"{k} {v!r}" for k, v in r.items()),
              file=sys.stderr)
    judged = {}
    for o in others:
        if o == "plain" and ranks is not None:
            raise ValueError("no plain witness of a decomposed run")
        other = (plain_witness(cell, perturb, device, dtype, judge.series)
                 if o == "plain" else judge.control(o))
        c, f, r = judge.compare(rec, other)
        judged[str(o).replace("torch.", "")] = {
            "correct": decide(c, f), "checks": c, "readings": r}

    snapshots = ({k: judge.block.crop(v) if judge.block else v
                  for k, v in rec.post.items()} if keep_snapshots else {})
    shutil.rmtree(work, ignore_errors=True)
    if ranks is not None and ranks.rank != 0:
        return Outcome(line=None, readings=readings, others=judged,
                       snapshots=snapshots)

    metrics, dev, breakdown = {}, {
        "platform": "gpu" if on_card else "cpu", "kind": kernel_kind,
        "count": chips, "memory_peak_bytes": int(peak)}, None
    if not trace:
        metrics = end_to_end(cell, window, t_end - rec.t0, setup_s,
                             n_points)
    elif tf is not None:
        first, last = profiler["first"], profiler["stopped"]
        ctx = Context(cell=cell, trace=tf,
                      chunks=rec.chunks[first:last],
                      spans=rec.spans[first:last], n_points=n_points,
                      launches=dict(zip(("substage", "multistep"),
                                        profiler["counts"])),
                      kind=kernel_kind,
                      window_steps=sum(c[2] for c in window),
                      window_seconds=t_end - rec.t0,
                      window_chunks=window,
                      tile_points=tile_points, chips=max(chips, 1))
        metrics = per_layer(cell, ctx)
        dev["busy_s"], dev["window_s"] = busy
        breakdown = {"device_ops": tf.top_ops(10),
                     "idle_gaps": tf.idle_by_host(10)}

    line = {"correct": decide(checks, failed), "attempted": len(window),
            "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return Outcome(line=line, readings=readings, others=judged,
                   snapshots=snapshots)


def plain_witness(cell, perturb, device, dtype, series):
    """The port's plain step (``ShallowWaterModel.step_fn``, no kernel) of
    ``dtype``, to put in the program's place: from a checked chunk's start
    it returns the stacked state and, in a cell with the series, the CLI's
    energies after each step, on the host."""
    from swmhd_tpu_torch import cli
    model, state0 = build_program(cell, perturb, device)
    h0 = state0.h
    dt = float(cell.traffic["dt"])

    def other(start, steps):
        s = state0.replace(**{n: f.to(device, dtype) for n, f in
                              zip(("h", "u", "v", "A"), start)})
        diag = (lambda st: cli.energies(model, st, h0)) if series else None
        out = model.step_fn(dt, steps, diagnostics=diag)(s)
        if not series:
            return torch.stack(out.fields()), None
        out, rows = out
        return torch.stack(out.fields()), {
            n: v.double().cpu().tolist() for n, v in rows.items()}
    return other


def end_to_end(cell, chunks, seconds, setup_s, n_points):
    """``points_per_s``, ``chunk_ms_p95``, ``setup_s`` of the window: every
    point-step of its ``chunks`` over its wall time ``seconds``; the 95th
    percentile of the chunks' wall times."""
    steps = sum(c[2] for c in chunks)
    walls = [(b - a) * 1e3 for a, b, _ in chunks]
    values = {
        "points_per_s": (n_points * steps / seconds, "points/s"),
        "chunk_ms_p95": (percentile(walls, 95), "ms"),
        "setup_s": (setup_s, "s"),
    }
    print(f"chunks {len(walls)} median_ms {statistics.median(walls)!r} "
          f"p95_ms {percentile(walls, 95)!r} steps {steps}",
          file=sys.stderr, flush=True)
    out = {}
    for m in cell.end_to_end:
        v, unit = values[m["name"]]
        out[m["name"]] = {"value": v, "unit": unit}
    return out


def percentile(values, q):
    """The q-th percentile, linear between the two nearest ranks."""
    s = sorted(values)
    k = (len(s) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the traced sub-window's chunks
    ``(start, end, steps)`` and the harness's host spans of each, the
    trace, the launch counters' growth over it, the grid's points, the
    card's name, and the steps and wall time of the window, which runs
    before the traced chunks as an untraced run's does. In a decomposed
    run the trace, the spans and the counters are rank 0's, whose card
    computes ``tile_points`` of the grid's points, one of ``chips``."""
    cell: Cell
    trace: object
    chunks: list
    spans: list
    n_points: int
    launches: dict
    kind: str
    window_steps: int = 0          # the window's steps, untraced
    window_seconds: float = 0.0    # and its wall time
    window_chunks: list = dataclasses.field(default_factory=list)
                                   # the window's chunks (start, end, steps)
    tile_points: Optional[int] = None   # the traced card's points, where
                                        # it holds a tile
    chips: int = 1                 # the cards the grid is spread over

    @property
    def traced_points(self):
        """The points whose kernels the trace holds."""
        return self.tile_points or self.n_points

    @property
    def steps(self):
        return sum(c[2] for c in self.chunks)

    @property
    def seconds(self):
        return self.chunks[-1][1] - self.chunks[0][0] if self.chunks else 0.0


def per_layer(cell, ctx):
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
