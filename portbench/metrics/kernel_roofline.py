"""The stepper kernels' share of their roofline, %: the least time the
card could take for the traced steps (the larger of the frozen operations
over the peak of the configuration's dtype and that dtype's bytes a
point-step, 96 for float32 and 192 for float64, over the device-memory
peak: :func:`portbench.roofline.yardstick`) over the device time of the
stepper's kernels in the trace. Of a decomposed run, the traced card's
tile and its kernels (K3 is the one-substage kernel on a tile with a
halo)."""

from __future__ import annotations

import re

from portbench import roofline

# the stepper's kernels: the one-substage tile kernels (K1) and the
# resident kernels (K2) of either formulation
STEPPER_KERNELS = re.compile(r"(^|[^A-Za-z0-9_])(vi|cons)_(substage|resident)<")


def is_stepper(name: str) -> bool:
    return STEPPER_KERNELS.search(name) is not None


def read(ctx):
    seconds = ctx.trace.kernel_seconds(is_stepper)
    fp, nbytes = roofline.yardstick(ctx.cell, ctx.kind)
    bw = roofline.peak(roofline.HBM_PEAK_GBPS, ctx.kind)
    if seconds <= 0 or fp is None or bw is None:
        return None
    point_steps = ctx.traced_points * ctx.steps
    least = max(roofline.ops_per_point_step(ctx.cell) * point_steps
                / (fp * 1e9),
                nbytes * point_steps / (bw * 1e9))
    return 100.0 * least / seconds
