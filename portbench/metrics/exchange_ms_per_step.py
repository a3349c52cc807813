"""The NCCL kernels' time a step on the traced card, ms: the union of the
intervals of its kernels whose names hold ``nccl`` (the halo exchange's
send and receive, two rounds a substage, and the progress report's
all-reduces), waiting for the peers included, over the traced steps.
None where the trace holds no such kernel (a run on one card)."""

from __future__ import annotations

from portbench.tracefile import merge


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def read(ctx):
    spans = merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in ctx.trace.kernels if is_nccl(e.get("name", "")))
    if not spans or not ctx.steps:
        return None
    return sum(b - a for a, b in spans) / 1e3 / ctx.steps
