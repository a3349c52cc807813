"""The padding copies' time a step on the traced card, ms: the union of
the intervals of its ``torch.cat`` kernels (names holding
``CatArrayBatchedCopy``), which ``DomainDecomposition.pad_for_kernel``
launches twice a substage to lay the received halo around the tile
before K3, over the traced steps. None where the trace holds none (a
run on one card)."""

from __future__ import annotations

from portbench.tracefile import merge


def is_pad_copy(name: str) -> bool:
    return "CatArrayBatchedCopy" in name


def read(ctx):
    spans = merge(ctx.trace.span(e) for e in ctx.trace.kernels
                  if is_pad_copy(e.get("name", "")))
    if not spans or not ctx.steps:
        return None
    return sum(b - a for a, b in spans) / 1e3 / ctx.steps
