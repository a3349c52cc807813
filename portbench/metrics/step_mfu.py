"""The whole step's share of the cards' peak in the configuration's dtype
(float32 or float64: :func:`portbench.roofline.yardstick`), %: the frozen
operations of the window's point-steps over its wall time (host clock)
times the peak of the cards the grid is spread over. The window of a
traced run runs as an untraced run's does; the traced chunks follow
it."""

from __future__ import annotations

from portbench import roofline


def read(ctx):
    fp = roofline.yardstick(ctx.cell, ctx.kind)[0]
    if fp is None or ctx.window_seconds <= 0 or not ctx.window_steps:
        return None
    ops = (roofline.ops_per_point_step(ctx.cell) * ctx.n_points
           * ctx.window_steps)
    return 100.0 * ops / (ctx.window_seconds * ctx.chips * fp * 1e9)
