"""The stepper kernels' share of their roofline, %: the least time the
card could take for the traced steps (the larger of the frozen operations
over the float32 peak and 96 B a point-step over the device-memory peak)
over the device time of the stepper's kernels in the trace. Of a
decomposed run, the traced card's tile and its kernels (K3 is the
one-substage kernel on a tile with a halo)."""

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
    fp = roofline.peak(roofline.FP32_PEAK_GFLOPS, ctx.kind)
    bw = roofline.peak(roofline.HBM_PEAK_GBPS, ctx.kind)
    if seconds <= 0 or fp is None or bw is None:
        return None
    point_steps = ctx.traced_points * ctx.steps
    least = max(roofline.ops_per_point_step(ctx.cell) * point_steps
                / (fp * 1e9),
                roofline.BYTES_PER_POINT_STEP * point_steps / (bw * 1e9))
    return 100.0 * least / seconds
