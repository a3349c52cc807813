"""The whole step's share of the cards' float32 peak, %: the frozen
operations of the window's point-steps over its wall time (host clock)
times the peak of the cards the grid is spread over. The window of a
traced run runs as an untraced run's does; the traced chunks follow
it."""

from __future__ import annotations

from portbench import roofline


def read(ctx):
    fp = roofline.peak(roofline.FP32_PEAK_GFLOPS, ctx.kind)
    if fp is None or ctx.window_seconds <= 0 or not ctx.window_steps:
        return None
    ops = (roofline.ops_per_point_step(ctx.cell) * ctx.n_points
           * ctx.window_steps)
    return 100.0 * ops / (ctx.window_seconds * ctx.chips * fp * 1e9)
