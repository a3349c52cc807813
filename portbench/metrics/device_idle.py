"""The device's idle share of the traced window, %: one less the union of
its operations' time over the window from the first traced event to the
end of the last."""

from __future__ import annotations


def read(ctx):
    window, busy = ctx.trace.window_s(), ctx.trace.busy_s()
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
