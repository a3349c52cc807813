"""The configuration's dtype sets what the harness builds, the yardstick
of ``kernel_roofline`` and ``step_mfu`` and the control of ``correct``:
float32 and float64, at 32² on the CPU."""

import contextlib
import dataclasses
import io
import json
import types

import pytest
import torch

from portbench import calibrate, harness, roofline
from portbench.check import CONTROL
from portbench.metrics import kernel_roofline, step_mfu

from helpers import config_copy, run_tiny, tiny_cell

H100 = "NVIDIA H100 80GB HBM3"


def f64_cell(tmp_path):
    """``tiny.f64`` under a float64 copy of ``jacobian``."""
    return tiny_cell(tmp_path, "tiny.f64", config="jacobian.f64",
                     configs=[config_copy("jacobian", "jacobian.f64",
                                          dtype="float64")])


def test_a_float64_cell_is_correct_and_its_float32_control_is_not(
        tmp_path):
    cell = f64_cell(tmp_path)
    assert CONTROL[cell.config["dtype"]] is torch.float32
    out = run_tiny(tmp_path, cell, others=(torch.float32,))
    assert out.line["correct"] is True and out.line["failed"] == 0
    assert len(out.readings) == cell.check["chunks"]
    control = out.others["float32"]
    assert control["correct"] is False and control["readings"]
    limit = cell.check["limits"]["state_gap"]
    assert all(r["state_gap"] > limit for r in control["readings"])


def calibrated(tmp_path, cell):
    """``(exit code, the JSON lines)`` of ``calibrate.read_seeds`` on two
    seeds of ``cell``, the control on the first."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
            io.StringIO()):
        rc = calibrate.read_seeds(cell, [2 ** 31 + 21, 2 ** 33 + 1], 1, 1.0,
                                  "cpu", out_path=str(tmp_path / "c.jsonl"))
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("traffic,control", [
    ("tiny.series", "bfloat16"), ("tiny.walls", "bfloat16"),
    ("tiny.f64", "float32")])
def test_calibrate_judges_the_control_below_the_dtype(tmp_path, traffic,
                                                      control):
    """Float32 cells keep bfloat16 as their control, a float64 cell takes
    float32; each comes out not correct, and calibrate exits 0."""
    cell = (f64_cell(tmp_path) if traffic == "tiny.f64"
            else tiny_cell(tmp_path, traffic))
    rc, lines = calibrated(tmp_path, cell)
    assert rc == 0 and [sorted(r["others"]) for r in lines] == [[control],
                                                               []]
    assert all(r["correct"] is True for r in lines)
    assert lines[0]["others"][control]["correct"] is False


def test_calibrate_exits_1_where_the_control_passes(tmp_path):
    """Limits too wide for the float64 cell's float32 control to fail."""
    cell = f64_cell(tmp_path)
    cell = dataclasses.replace(cell, check={**cell.check,
                                            "limits": {"state_gap": 1.0}})
    rc, lines = calibrated(tmp_path, cell)
    assert rc == 1 and lines[0]["others"]["float32"]["correct"] is True


def test_a_dtype_outside_the_two_raises(tmp_path):
    cell = tiny_cell(tmp_path, "tiny.f64")
    cell = dataclasses.replace(cell, config={**cell.config,
                                             "dtype": "float16"})
    with pytest.raises(ValueError, match="float32 or float64"):
        harness.build_program(cell, {"h": [], "A": []}, "cpu")
    assert set(CONTROL) == set(roofline.DTYPES) == {"float32", "float64"}


def traced_ctx(cell):
    """A fixed traced sub-window: three 100-step chunks at 2048², the
    stepper's kernels 0.25 s, and a 30 s window of 30,000 steps."""
    trace = types.SimpleNamespace(kernel_seconds=lambda keep: 0.25)
    return harness.Context(cell=cell, trace=trace,
                           chunks=[(0.0, 0.1, 100)] * 3, spans=[],
                           n_points=2048 ** 2, launches={}, kind=H100,
                           window_steps=30000, window_seconds=30.0)


@pytest.mark.parametrize("traffic", ["tiny.series", "tiny.walls"])
def test_float32_yardsticks_read_as_before(tmp_path, traffic):
    """A float32 cell's readings are the old formulas' (67 TFLOP/s and
    96 B a point-step), to the last bit."""
    cell = tiny_cell(tmp_path, traffic)
    ctx = traced_ctx(cell)
    ops = roofline.ops_per_point_step(cell)
    point_steps = 2048 ** 2 * 300
    old_roofline = 100.0 * max(ops * point_steps / (67000.0 * 1e9),
                               96.0 * point_steps / (3350.0 * 1e9)) / 0.25
    old_mfu = 100.0 * (ops * 2048 ** 2 * 30000) / (30.0 * 1 * 67000.0 * 1e9)
    assert kernel_roofline.read(ctx) == old_roofline
    assert step_mfu.read(ctx) == old_mfu
    assert roofline.yardstick(cell, H100) == (67000.0, 96.0)


def test_float64_yardsticks(tmp_path):
    """A float64 cell reads against 34 TFLOP/s and 192 B a point-step,
    with the same frozen operations."""
    cell = f64_cell(tmp_path)
    ctx = traced_ctx(cell)
    ops = roofline.ops_per_point_step(cell)
    assert ops == roofline.OPS_PER_POINT_STEP[
        "vector_invariant/periodic/nobg"]
    point_steps = 2048 ** 2 * 300
    assert roofline.yardstick(cell, H100) == (34000.0, 192.0)
    assert kernel_roofline.read(ctx) == pytest.approx(
        100.0 * max(ops * point_steps / 34000.0e9,
                    192.0 * point_steps / 3350.0e9) / 0.25)
    assert step_mfu.read(ctx) == pytest.approx(
        100.0 * ops * 2048 ** 2 * 30000 / (30.0 * 34000.0e9))
    for part, want in (("H100 PCIe", 26000.0), ("H100 NVL", 30000.0),
                       ("H100 SXM5 80GB", 34000.0)):
        assert roofline.yardstick(cell, "NVIDIA " + part)[0] == want
    assert roofline.yardstick(cell, "cpu")[0] is None
