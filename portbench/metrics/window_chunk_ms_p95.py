"""The 95th percentile of the window's chunk wall times, ms (host clock),
as ``chunk_ms_p95`` takes it end to end: every chunk of the window, which
in a traced run runs untraced before the traced chunks. Read per layer
in a cell whose host swings this tail too widely for a bound. None where
the window holds no chunk."""

from __future__ import annotations

from portbench.harness import percentile


def read(ctx):
    if not ctx.window_chunks:
        return None
    return percentile([(end - start) * 1e3
                       for start, end, _ in ctx.window_chunks], 95)
