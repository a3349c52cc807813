"""Runs of the harness on the CPU at 32² (the plain step in the kernels'
place): the contract's last line, no JAX, a refusal without a card, and
``correct`` false under every fault a cell can have and under the
control."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, run
from portbench.metrics import window_chunk_ms_p95

from helpers import ROOT, run_tiny, tiny_cell

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def last_line(outcome):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        run.emit(outcome.line)
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


def test_run_prints_the_contract_line(tmp_path):
    cell = tiny_cell(tmp_path, "tiny.series")
    line, err = last_line(run_tiny(tmp_path, cell))
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 3
    assert set(line["metrics"]) == {"points_per_s", "chunk_ms_p95",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"state_gap", "energy_gap"}
    assert err.splitlines()[-2].startswith("state_gap ")
    assert err.splitlines()[-1].startswith("energy_gap ")


def test_traced_run_reports_per_layer_metrics(tmp_path):
    cell = tiny_cell(tmp_path, "tiny.series")
    line, _ = last_line(run_tiny(tmp_path, cell, seconds=2.0, trace=True))
    assert line["correct"] is True
    assert "loop_host_ms_per_chunk" in line["metrics"]
    assert not set(line["metrics"]) & {"points_per_s", "chunk_ms_p95"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_window_p95_read_per_layer_as_end_to_end(tmp_path):
    """``window_chunk_ms_p95`` is ``chunk_ms_p95`` of the same window:
    the 95th percentile of every window chunk's wall, the traced chunks
    after the window left out."""
    window = [(float(i), float(i) + 1e-3 * (i + 1), 100) for i in range(20)]
    ctx = harness.Context(cell=None, trace=None, chunks=[(30.0, 31.0, 100)],
                          spans=[{}], n_points=1, launches={}, kind="cpu",
                          window_chunks=window)
    assert window_chunk_ms_p95.read(ctx) == pytest.approx(
        harness.percentile([c[1] - c[0] for c in window], 95) * 1e3)
    assert window_chunk_ms_p95.read(ctx) == pytest.approx(19.05)
    ctx.window_chunks = []
    assert window_chunk_ms_p95.read(ctx) is None
    cell = tiny_cell(tmp_path, "tiny.series")
    line, _ = last_line(run_tiny(tmp_path, cell, seconds=2.0, trace=True))
    assert line["metrics"]["window_chunk_ms_p95"]["value"] > 0


def test_no_jax_after_a_run(tmp_path):
    run_tiny(tmp_path, tiny_cell(tmp_path, "tiny.walls"))
    tops = {m.split(".")[0] for m in sys.modules}
    assert "swmhd_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "swmhd_tpu"}
    assert harness.forbidden_modules() == []


def _run_py(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "jacobian.128.series", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_refuses_without_a_card():
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_refuses_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


# -- each cell at 32²: faults planted in the timed path, and the control ------

CELLS = [w["name"] for w in harness.load(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


def small(name):
    """Cell ``name`` at 32², with its own configuration, step, chunk and
    limits, its first chunk checked."""
    cell = harness.find_cell(name)
    return dataclasses.replace(
        cell, traffic={**cell.traffic, "N": 32, "warm_chunks": 1},
        check={**cell.check, "chunks": 1})


class Broken:
    """The selected stepper with its chunks broken by ``fault``."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def step_fn(self, dt, n_steps=1, diagnostics=None):
        from swmhd_tpu_torch.models.state import Clock
        fn = self.inner.step_fn(dt, n_steps, diagnostics=diagnostics)

        def broken(state):
            if self.fault == "unchanged":
                c = state.clock
                out = state.replace(clock=Clock(c.time + n_steps * dt,
                                                c.iteration + n_steps))
                if diagnostics is None:
                    return out
                rows = [diagnostics(out) for _ in range(n_steps)]
                return out, {k: torch.stack([r[k] for r in rows])
                             for k in rows[0]}
            res = fn(state)
            out = res[0] if isinstance(res, tuple) else res
            if self.fault == "half":       # half of the grid left behind
                n = out.h.shape[0] // 2
                out = out.replace(**{
                    f: torch.cat([getattr(state, f)[:n],
                                  getattr(out, f)[n:]])
                    for f in ("h", "u", "v", "A")})
            elif self.fault == "altered":  # one value of the state wrong
                h = out.h.clone()
                h[3, 5] += 1.0
                out = out.replace(h=h)
            return (out, res[1]) if isinstance(res, tuple) else out
        return broken


def altered_series(fn):
    """The series with its total energy 1% off in every row."""
    def series(model, state):
        out = dict(fn(model, state))
        out["total_energy"] = out["total_energy"] * 1.01
        return out
    return series


FAULTS = [(name, fault) for name in CELLS
          for fault in ("unchanged", "half", "altered", "series")
          if fault != "series"
          or harness.find_cell(name).traffic.get("series_every")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_is_not_correct(tmp_path, name, fault):
    kw = ({"series_hook": altered_series} if fault == "series" else
          {"stepper_hook": lambda s, m: Broken(s, fault)})
    line, _ = last_line(run_tiny(tmp_path, small(name), seconds=0.5, **kw))
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_each_cells_limits(tmp_path, name):
    """The program comes out correct, and the control, the reference in
    bfloat16 in the program's place, comes out not correct through the
    same comparison; each of its readings exceeds one of the limits."""
    cell = small(name)
    out = run_tiny(tmp_path, cell, seconds=0.5, others=(torch.bfloat16,))
    assert out.line["correct"] is True
    control = out.others["bfloat16"]
    assert control["correct"] is False
    limits = cell.check["limits"]
    assert control["readings"]
    for reading in control["readings"]:
        assert any(reading[n] > limits[n] for n in limits), reading


@pytest.mark.parametrize("name", CELLS)
def test_the_ports_plain_step_is_a_correct_witness(tmp_path, name):
    """The port's own plain step, put in the program's place from the
    program's state, comes out correct as the program does."""
    out = run_tiny(tmp_path, small(name), seconds=0.5, others=("plain",))
    witness = out.others["plain"]
    assert witness["correct"] is True and out.line["correct"] is True
    assert [r["chunk"] for r in witness["readings"]] == [
        r["chunk"] for r in out.readings]


def test_gaps_of_a_state_left_unchanged():
    from portbench.check import energy_gap, state_gap
    S = torch.rand(4, 8, 8, dtype=torch.float64)
    R = S + 1e-3 * torch.rand(4, 8, 8, dtype=torch.float64)
    assert state_gap(S.float(), R, S) == pytest.approx(1.0, rel=1e-3)
    rows = {"a": [1.0, 2.0], "b": [0.0, 1e-12]}
    assert energy_gap(rows, rows) == 0.0
    assert energy_gap({"a": [1.0, 2.0]}, rows) == float("inf")


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "jacobian.128.series", "--seed", str(2 ** 31 + 17), "--seconds",
         "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["attempted"] > 0 and "checks" in line


@pytest.mark.parametrize("close_at,traced_from", [(10, 1), (20, 4)])
def test_the_trace_follows_the_window(close_at, traced_from):
    """The window closes at the first chunk's end past its seconds; the
    traced chunks follow it inside one scenario run, none its first, and
    the run stops when they are done."""
    from types import SimpleNamespace
    calls = []

    def on_trace(start):
        calls.append(start)
        rec.profiling = start
    rec = harness.Recorder(seconds=close_at - 0.5, checked=[],
                           trace_chunks=2, chunk_steps=10, run_steps=30,
                           on_trace=on_trace)
    rec.timing, rec.t0 = True, 0.0
    sim = SimpleNamespace(state=None, stop_iteration=None)
    t = 0.0
    for _ in range(3):                      # three scenario runs at most
        rec.start_run(t)
        for it in (0, 10, 20, 30):
            if rec.done:
                break
            sim.state = SimpleNamespace(clock=SimpleNamespace(iteration=it))
            t = float(len(rec.chunks) * 10 + (it > 0) * 10)
            rec.boundary(sim, t)
    assert rec.n_window == close_at // 10 and rec.done
    assert calls == [True, False] and rec.traced_from == traced_from
    assert len(rec.chunks) == traced_from + 2
    assert sim.stop_iteration == 30
