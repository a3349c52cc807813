"""The NCCL kernels' time in the median substage on the traced card, ms:
the traced card's timeline cut at the starts of its stepper kernels (K3,
one a substage), and in each stretch from one stepper kernel's end to
the next one's start, the union of the kernels whose names hold
``nccl`` (the substage's two exchange rounds; a chunk's first stretch
also holds the report's all-reduces). Waiting for a peer that lags in
a few substages moves the median little, where it moves
``exchange_ms_per_step``'s sum. None where the trace holds no NCCL
kernel or fewer than two stepper kernels."""

from __future__ import annotations

import statistics

from portbench.metrics.exchange_ms_per_step import is_nccl
from portbench.metrics.kernel_roofline import is_stepper
from portbench.tracefile import merge


def read(ctx):
    span = ctx.trace.span
    steps = sorted(span(e) for e in ctx.trace.kernels
                   if is_stepper(e.get("name", "")))
    nccl = merge(span(e) for e in ctx.trace.kernels
                 if is_nccl(e.get("name", "")))
    if not nccl or len(steps) < 2:
        return None
    per = []
    for (_, lo), (hi, _) in zip(steps, steps[1:]):
        per.append(sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in nccl))
    return statistics.median(per) / 1e3
