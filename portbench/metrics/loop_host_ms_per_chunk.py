"""The simulation loop's self time a chunk, ms: a chunk's wall time less
the harness's spans inside it (the stepper's call, which in a traced run
waits for the device, the series writes and the progress report), the
mean over the traced chunks."""

from __future__ import annotations


def read(ctx):
    if not ctx.chunks:
        return None
    selfs = [(end - start) - sum(spans.values())
             for (start, end, _), spans in zip(ctx.chunks, ctx.spans)]
    return 1e3 * sum(selfs) / len(selfs)
