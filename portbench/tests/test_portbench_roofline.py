"""The frozen operations a point-step are the reference's count."""

import pytest
import torch

from portbench import roofline
from portbench.reference import swmhd as R

KEYS = sorted(roofline.OPS_PER_POINT_STEP)


@pytest.mark.parametrize("key", KEYS)
def test_frozen_ops_equal_a_fresh_count(key):
    formulation, topology_y, bg = key.split("/")
    m = R.Model(R.Grid(32, 10.0, topology_y), formulation, 9.81, 1.0,
                -0.05 if bg == "bg" else 0.0)
    s = R.initial_state(m, {"h0": 1.0, "A": ["two_gaussians", 0.5],
                            "uv": ["vortex", 1.0]}, {"h": [], "A": []},
                        dtype=torch.float32)
    n = roofline.count_ops(lambda: R.step(m, s, 0.01))
    assert n / 32 ** 2 == roofline.OPS_PER_POINT_STEP[key]


def test_peaks_of_the_h100():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.peak(roofline.FP32_PEAK_GFLOPS, kind) == 67000.0
    assert roofline.peak(roofline.HBM_PEAK_GBPS, kind) == 3350.0
    assert roofline.peak(roofline.HBM_PEAK_GBPS, "cpu") is None


def test_step_mfu_reads_the_window(tmp_path):
    """``step_mfu`` is the frozen operations of the window's point-steps
    over its host-clock seconds and the peak; it reads nothing where the
    window completed no step."""
    from portbench import harness
    from portbench.metrics import step_mfu
    from helpers import tiny_cell
    cell = tiny_cell(tmp_path, "tiny.series")
    ctx = harness.Context(cell=cell, trace=None, chunks=[], spans=[],
                          n_points=2048 ** 2, launches={},
                          kind="NVIDIA H100 80GB HBM3",
                          window_steps=30000, window_seconds=30.0)
    ops = roofline.ops_per_point_step(cell)
    assert step_mfu.read(ctx) == pytest.approx(
        100.0 * ops * 2048 ** 2 * 30000 / (30.0 * 67000.0e9))
    ctx.window_steps = 0
    assert step_mfu.read(ctx) is None
