"""The readers of the program's spans on synthetic Chrome traces:
``idle_in_graph``, ``loop_self_ms_per_chunk`` and ``setup_program_s``."""

import json
import sys
import types

import pytest

from portbench import tracefile
from portbench.metrics import (device_idle, idle_in_graph,
                               loop_self_ms_per_chunk, setup_program_s)


def x(name, ts, dur, cat, corr=None, tid=1):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def kernel(ts, dur, corr):
    return x("k", ts, dur, "kernel", corr, tid=7)


def ctx_of(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(trace=tracefile.Trace(str(path)))


def replay(ts, dur, corr):
    """A ``swmhd.graph_replay`` span holding its ``cudaGraphLaunch``."""
    return [x("swmhd.graph_replay", ts, dur, "user_annotation"),
            x("cudaGraphLaunch", ts + 1, dur - 2, "cuda_runtime", corr)]


def test_gaps_inside_one_graph_launch_count(tmp_path):
    """Window 0–100 µs. Launch 5's kernels at 10–20, 25–30, 40–50 leave
    gaps of 5 and 10 inside it; the gap 50–60 lies between launch 5 and
    launch 6, the gap 65–70 between a kernel of launch 6 and one of a
    plain launch (9): neither counts."""
    events = (replay(0, 10, 5) + replay(52, 6, 6) + [
        kernel(10, 10, 5), kernel(25, 5, 5), kernel(40, 10, 5),
        kernel(60, 5, 6), x("cudaLaunchKernel", 62, 2, "cuda_runtime", 9),
        kernel(70, 30, 9)])
    ctx = ctx_of(tmp_path, events)
    assert idle_in_graph.read(ctx) == pytest.approx(15.0)
    # busy 10 + 5 + 10 + 5 + 30 of the 100
    assert device_idle.read(ctx) == pytest.approx(40.0)
    assert idle_in_graph.read(ctx) <= device_idle.read(ctx)


def test_a_launch_outside_a_replay_span_does_not_count(tmp_path):
    events = [x("swmhd.chunk", 0, 100, "user_annotation"),
              x("cudaGraphLaunch", 1, 2, "cuda_runtime", 5),
              kernel(10, 10, 5), kernel(30, 10, 5)]
    assert idle_in_graph.read(ctx_of(tmp_path, events)) == 0.0


def test_a_trace_with_no_graph_reads_zero(tmp_path):
    events = [x("swmhd.step", 0, 50, "user_annotation"),
              x("cudaLaunchKernel", 1, 2, "cuda_runtime", 3),
              x("cudaLaunchKernel", 4, 2, "cuda_runtime", 4),
              kernel(10, 10, 3), kernel(30, 10, 4)]
    ctx = ctx_of(tmp_path, events)
    assert idle_in_graph.read(ctx) == 0.0
    assert device_idle.read(ctx) > 0


def test_no_program_spans_or_no_device_reads_nothing(tmp_path):
    """The parent program has no ``swmhd.`` spans; a CPU trace has no
    device operations."""
    no_spans = replay(0, 10, 5)[1:] + [kernel(10, 10, 5), kernel(30, 5, 5)]
    assert idle_in_graph.read(ctx_of(tmp_path, no_spans)) is None
    no_device = replay(0, 10, 5)
    assert idle_in_graph.read(ctx_of(tmp_path, no_device)) is None
    assert loop_self_ms_per_chunk.read(ctx_of(tmp_path, no_spans)) is None


def test_idle_in_graph_never_exceeds_device_idle(tmp_path):
    """Kernels of one launch with gaps everywhere, and another stream's
    kernel of the same launch overlapping one gap."""
    events = replay(0, 5, 5) + [kernel(10 * i, 4, 5) for i in range(1, 9)]
    events.append(x("k2", 43, 10, "kernel", 5, tid=8))
    ctx = ctx_of(tmp_path, events)
    got, idle = idle_in_graph.read(ctx), device_idle.read(ctx)
    assert 0 < got <= idle


def chunk(ts, dur, kids, tid=1):
    """A ``swmhd.chunk`` span and its children ``(name, start, length)``
    relative to it."""
    return [x("swmhd.chunk", ts, dur, "user_annotation", tid=tid)] + [
        x("swmhd." + n, ts + a, d, "user_annotation", tid=tid)
        for n, a, d in kids]


def test_loop_self_subtracts_overlapping_children_once(tmp_path):
    """Chunk 1 (1000 µs): step 0–600 holding graph_replay 10–20 and a
    to_host 590–650 that overlaps it (590–600 counted once), series_write
    700–750, fire 800–900 holding to_host 810–820; self 1000 − 650 − 50 −
    100 = 200 µs. Chunk 2 (2000 µs): step 0–1000, self 1000 µs. Chunk 3
    is cut by the profiler's stop: nothing starts after it."""
    events = (chunk(0, 1000, [("step", 0, 600), ("graph_replay", 10, 10),
                              ("to_host", 590, 60),
                              ("series_write", 700, 50),
                              ("fire", 800, 100), ("to_host", 810, 10)])
              + chunk(1000, 2000, [("step", 0, 1000)])
              + chunk(3000, 500, [("step", 0, 100), ("fire", 150, 350)])
              + [x("aten::copy_", 3010, 5, "cpu_op")])
    ctx = ctx_of(tmp_path, events)
    assert loop_self_ms_per_chunk.read(ctx) == pytest.approx(
        (0.2 + 1.0) / 2)


def test_loop_self_leaves_other_threads_out(tmp_path):
    events = (chunk(0, 1000, [("step", 0, 400)])
              + [x("swmhd.to_host", 500, 300, "user_annotation", tid=2),
                 x("aten::empty", 2000, 1, "cpu_op")])
    ctx = ctx_of(tmp_path, events)
    assert loop_self_ms_per_chunk.read(ctx) == pytest.approx(0.6)


def test_a_trace_of_one_cut_chunk_reads_nothing(tmp_path):
    ctx = ctx_of(tmp_path, chunk(0, 1000, [("step", 0, 400)]))
    assert loop_self_ms_per_chunk.read(ctx) is None


def test_setup_program_s_reads_the_programs_totals(monkeypatch):
    tracing = pytest.importorskip("swmhd_tpu_torch.tracing")
    monkeypatch.setattr(tracing, "_totals", {
        "swmhd.library_load": [1, 0.25], "swmhd.graph_capture": [2, 0.5]})
    assert setup_program_s.read(None) == pytest.approx(0.75)
    monkeypatch.setattr(tracing, "_totals", {})
    assert setup_program_s.read(None) is None


def test_setup_program_s_without_the_program_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "swmhd_tpu_torch.tracing", None)
    assert setup_program_s.read(None) is None
