"""Device time of the traced kernels that are not the stepper's (the
energy series, with the progress report's extrema), ms a step."""

from __future__ import annotations

from portbench.metrics.kernel_roofline import is_stepper


def read(ctx):
    if not ctx.cell.traffic.get("series_every") or not ctx.steps:
        return None
    seconds = ctx.trace.kernel_seconds(lambda n: not is_stepper(n))
    return 1e3 * seconds / ctx.steps if seconds > 0 else None
