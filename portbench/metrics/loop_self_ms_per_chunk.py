"""The simulation loop's self time a chunk, inside the program, ms: each
``swmhd.chunk`` span (one iteration of ``Simulation.run``'s loop) less
the union of the program's spans it holds (``swmhd.step``,
``swmhd.to_host``, ``swmhd.series_write``, ``swmhd.fire`` and what they
hold), the mean over the chunks the trace holds whole. The profiler
starts and stops inside a chunk's ``swmhd.fire``: a span still open at
the stop ends at it, and a chunk after which no host event starts is
left out. None where the trace holds no whole chunk."""

from __future__ import annotations

from portbench.metrics.idle_in_graph import PROGRAM, annotations, holds
from portbench.tracefile import HOST_CATS, Trace, merge


def read(ctx):
    trace = ctx.trace
    ours = annotations(trace)
    last = max((Trace.span(e)[0] for e in trace.events
                if e.get("cat") in HOST_CATS), default=None)
    whole = [c for c in ours if c["name"] == PROGRAM + "chunk"
             and Trace.span(c)[1] < last]
    if not whole:
        return None
    selfs = []
    for c in whole:
        kids = merge(Trace.span(e) for e in ours if holds(c, e))
        selfs.append(float(c["dur"]) - sum(b - a for a, b in kids))
    return sum(selfs) / len(selfs) / 1e3
