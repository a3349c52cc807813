"""Reading a ``torch.profiler`` Chrome trace of the traced sub-window:
the device's busy time as the union of its operations, the traced
window, the device operations that took most time, and the device's idle
gaps by what the host was doing.
"""

from __future__ import annotations

import json
import re

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without ``void``, its template arguments' detail
    past 100 characters, or its argument list."""
    name = re.sub(r"^void ", "", name)
    name = name.split("(", 1)[0] if not name.startswith("(") else name
    return name[:100]


class Trace:
    """The complete events of one Chrome trace; times in microseconds."""

    def __init__(self, path: str):
        with open(path) as f:
            tr = json.load(f)
        evs = tr["traceEvents"] if isinstance(tr, dict) else tr
        self.events = [e for e in evs if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in self.events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in self.events
                 if e.get("cat") in DEVICE_CATS + HOST_CATS]
        self.start = min((a for a, _ in spans), default=0.0)
        self.end = max((b for _, b in spans), default=0.0)
        self.busy = merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                          for e in self.device)

    @staticmethod
    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(float(e["dur"]) for e in self.kernels
                   if match(e.get("name", ""))) / 1e6

    def top_ops(self, n: int):
        """``[[name, seconds]]`` of the device operations that took most
        time, summed by name."""
        tot = {}
        for e in self.device:
            k = short_name(e.get("name", ""))
            tot[k] = tot.get(k, 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def gaps(self):
        """The device's idle intervals within the traced window."""
        out, t = [], self.start
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def idle_by_host(self, n: int):
        """``[[what the host did, idle seconds]]``: each idle gap of the
        device is put to the innermost harness annotation
        (``portbench.*``) open at its middle, else to the innermost host
        operator, else to "host"; summed by that name, the largest
        first."""
        notes = sorted((self.span(e) + (e.get("name", ""),)
                        for e in self.events
                        if e.get("cat") == "user_annotation"
                        and e.get("name", "").startswith("portbench.")))
        ops = sorted(self.span(e) + (e.get("name", ""),)
                     for e in self.events if e.get("cat") == "cpu_op")
        gaps = self.gaps()
        mids = [0.5 * (a + b) for a, b in gaps]
        by_op = innermost_at(mids, ops)
        by_note = innermost_at(mids, notes)
        tot = {}
        for (a, b), note, op in zip(gaps, by_note, by_op):
            name = note or op or "host"
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


def innermost_at(points, intervals):
    """For each of the sorted ``points``, the name of the shortest of the
    sorted ``(start, end, name)`` intervals that holds it, or None."""
    out, active, i = [], [], 0
    for p in points:
        while i < len(intervals) and intervals[i][0] <= p:
            active.append(intervals[i])
            i += 1
        active = [x for x in active if x[1] >= p]
        out.append(min(active, key=lambda x: x[1] - x[0])[2]
                   if active else None)
    return out
