"""Spans at the port's layer boundaries, on the clock of ``torch.profiler``.

``span(name)`` is, while a ``torch.profiler`` runs, a
``torch.profiler.record_function("swmhd.<name>")`` range: it lands in the
profiler's Chrome trace as a ``user_annotation`` beside the card's
kernels and runtime calls, on the same clock, so that each idle gap of
the device can be put beside what the host was doing. Spans nest by time
on their thread. With no profiler running a span reads one flag and
records nothing. :func:`swmhd_tpu_torch.profiling.trace` and any other
``torch.profiler`` session pick the spans up as they are.

``span(name, setup=True)`` marks set-up work (building the kernel
library, readying a kernel, building a stepper, capturing a CUDA graph):
the same range, and always an in-memory count and host-clock seconds by
name, read by :func:`setup_totals`. A set-up span's seconds are its own,
less those of the set-up spans it holds, so that each second counts once
however they nest. No hot path holds a set-up span.

The spans and what reads them (PERF.md §3):

- ``swmhd.chunk``: one iteration of ``Simulation.run``'s loop; its
  children ``swmhd.step`` (a stepper's call: where one chunk runs ahead,
  the next chunk's launch, and the first chunk's lies before the loop),
  ``swmhd.to_host`` (each blocking device→host copy),
  ``swmhd.series_write`` and ``swmhd.fire`` (due callbacks and writers).
- ``swmhd.graph_replay``: one CUDA-graph replay of a ``GraphChunk``.
- set-up: ``swmhd.library_load``, ``swmhd.kernel_ready``,
  ``swmhd.stepper_build``, ``swmhd.graph_warm``, ``swmhd.graph_capture``.
"""

from __future__ import annotations

import contextlib
import time

from torch.autograd import profiler as _profiler

PREFIX = "swmhd."
_OFF = contextlib.nullcontext()
_totals = {}        # span name -> [count, seconds]
_open = []          # the set-up spans open, outermost first


def span(name: str, setup: bool = False):
    """The context of span ``swmhd.<name>`` (see the module's doc). The
    flag read is the one ``torch.profiler``'s start and stop set."""
    if setup:
        return _SetupSpan(PREFIX + name)
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _OFF


class _SetupSpan:
    __slots__ = ("name", "range", "t0", "inner")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        _open.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        took = time.perf_counter() - self.t0
        _open.pop()
        if _open:
            _open[-1].inner += took
        total = _totals.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += took - self.inner
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def setup_totals() -> dict:
    """``{span name: (count, seconds)}`` of the set-up spans closed in
    this process; the seconds of all names sum to the host time spent in
    set-up spans."""
    return {k: (n, s) for k, (n, s) in _totals.items()}


def setup_delta(before: dict) -> dict:
    """What :func:`setup_totals` gained since ``before``, one of its
    earlier readings."""
    out = {}
    for k, (n, s) in _totals.items():
        n0, s0 = before.get(k, (0, 0.0))
        if n != n0:
            out[k] = (n - n0, s - s0)
    return out
