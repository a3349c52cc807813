"""The device's idle share of the traced window inside CUDA-graph
replays, %: the idle gaps (over the window of ``device_idle``) between a
device operation that ends where the gap starts and one that starts where
it ends, both of the ``args.correlation`` of one ``cudaGraphLaunch`` that
lies inside the program's span ``swmhd.graph_replay``. At most
``device_idle``; the rest of it is idle outside the graph replays. None
where the trace has no device operation or none of the program's
``swmhd.`` spans (a program without them)."""

from __future__ import annotations

from portbench.tracefile import Trace

PROGRAM = "swmhd."


def annotations(trace, name=None):
    """The program's spans in the trace, or those named ``name``."""
    return [e for e in trace.events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PROGRAM)
            and (name is None or e["name"] == name)]


def holds(outer, e):
    """Whether event ``outer`` holds event ``e`` on its thread."""
    (a, b), (c, d) = Trace.span(outer), Trace.span(e)
    return (outer.get("tid") == e.get("tid") and a <= c and d <= b
            and outer is not e)


def correlation(e):
    return (e.get("args") or {}).get("correlation")


def read(ctx):
    trace = ctx.trace
    if not trace.device or not annotations(trace) or trace.window_s() <= 0:
        return None
    replays = annotations(trace, PROGRAM + "graph_replay")
    graphs = {correlation(e) for e in trace.events
              if e.get("cat") == "cuda_runtime"
              and e.get("name", "").startswith("cudaGraphLaunch")
              and any(holds(r, e) for r in replays)}
    graphs.discard(None)
    ends, starts = {}, {}
    for e in trace.device:
        a, b = Trace.span(e)
        ends.setdefault(b, set()).add(correlation(e))
        starts.setdefault(a, set()).add(correlation(e))
    idle = sum(b - a for a, b in trace.gaps()
               if ends.get(a, set()) & starts.get(b, set()) & graphs)
    return 100.0 * idle / 1e6 / trace.window_s()
