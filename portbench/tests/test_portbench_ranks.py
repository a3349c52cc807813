"""The harness's decomposed path on the CPU: four gloo ranks at 32² (a
2×2 mesh of 16² tiles, the plain decomposed step), started by the
launcher ``run.py`` uses, each run under its own deadline. Besides, the
readers of a four-rank run."""

import json
import os
import socket
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness, ranks, roofline
from portbench.metrics import (exchange_ms_per_step,
                               exchange_ms_per_substage_p50,
                               kernel_roofline, pad_copy_ms_per_step,
                               step_mfu)

from helpers import DATA, ROOT, run_tiny

SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "ranks_script.py")
DEADLINE_S = 50


def tiny_root(tmp_path, dtype="float64"):
    """A root with a BENCHMARK.json whose one cell, ``tiny.decomposed``,
    runs the jacobian physics in ``dtype`` over 4 ranks, a 2×2 mesh."""
    bench = harness.load(os.path.join(ROOT, "BENCHMARK.json"))
    conf = harness.load(os.path.join(ROOT, "portbench", "configs",
                                     "jacobian.nccl2x2.json"))
    conf["dtype"], conf["tile"] = dtype, [16, 16]
    root = tmp_path / "root"
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(conf))
    bench["configs"] = [{**bench["configs"][0], "name": "tiny",
                         "file": "portbench/configs/tiny.json"}]
    bench["workloads"] = [{"name": "tiny.decomposed", "config": "tiny",
                           "traffic": "tiny.decomposed", "chips": 4,
                           "why": "test"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def run_ranks(tmp_path, case, dtype="float64", env=None):
    """``(rc, seconds, {rank: what it saved})`` of the four ranks."""
    out = tmp_path / "out"
    out.mkdir()
    t = time.monotonic()
    rc = ranks.launch([SCRIPT, "--root", tiny_root(tmp_path, dtype),
                       "--out", str(out), "--case", case], 4, str(out),
                      setup_timeout=DEADLINE_S, cwd=ROOT, env=env)
    took = time.monotonic() - t
    saved = {r: torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4) if (out / f"rank{r}.pt").exists()}
    return rc, took, saved


def test_four_ranks_agree_with_one(tmp_path):
    """The gathered snapshots of the four ranks are the one-rank run's,
    to float64 rounding, and both come out correct; the control, judged
    by the four ranks in the program's place, does not."""
    rc, _, saved = run_ranks(tmp_path, "plain")
    assert rc == 0 and sorted(saved) == [0, 1, 2, 3]
    line = saved[0]["line"]
    assert line["correct"] is True and line["device"]["count"] == 0
    control = saved[0]["others"]["bfloat16"]
    assert control["correct"] is False and control["readings"]
    assert all(saved[r]["line"] is None for r in (1, 2, 3))
    cell = harness.find_cell("tiny.decomposed", root=tiny_root(
        tmp_path / "one"), pkg=DATA)
    one = run_tiny(tmp_path, cell, seed=2 ** 31 + 5, keep_snapshots=True)
    assert one.line["correct"] is True
    common = set(one.snapshots).intersection(
        *(saved[r]["snapshots"] for r in range(4)))
    assert 0 in common and len(common) >= 2
    for k in common:
        whole = torch.empty_like(one.snapshots[k])
        for r in range(4):
            x0, x1, y0, y1 = saved[r]["bounds"]
            whole[:, x0:x1, y0:y1] = saved[r]["snapshots"][k]
        scale = one.snapshots[k].abs().max()
        assert (whole - one.snapshots[k]).abs().max() <= 1e-13 * scale
    by_chunk = {c["chunk"]: c["state_gap"] for c in one.readings}
    for c in saved[0]["readings"]:
        assert c["state_gap"] == pytest.approx(by_chunk[c["chunk"]],
                                               rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("case", ["stale", "local", "altered"])
def test_a_fault_in_the_tiles_is_not_correct(tmp_path, case):
    """A halo left stale on one rank, the exchange left out on all, one
    value altered in one rank's tile: each comes out not correct."""
    rc, _, saved = run_ranks(tmp_path, case)
    assert rc == 0
    line = saved[0]["line"]
    assert line["correct"] is False and line["failed"] >= 1


def test_a_rank_whose_clock_closes_early_stops_with_the_others(tmp_path):
    """Rank 2's own clock would close the window at once; rank 0's
    decides, and every rank takes the same steps."""
    rc, took, saved = run_ranks(tmp_path, "early")
    assert rc == 0 and took < DEADLINE_S
    assert len({saved[r]["steps"] for r in range(4)}) == 1
    assert saved[0]["line"]["correct"] is True
    assert saved[0]["line"]["attempted"] > 1


def test_a_port_taken_meanwhile_does_not_stop_the_ranks(tmp_path):
    """The rendezvous port is one the system gives ``torchrun``: a
    ``MASTER_PORT`` that another socket holds is not used."""
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        port = held.getsockname()[1]
        rc, _, saved = run_ranks(tmp_path, "early",
                                 env={"MASTER_PORT": str(port)})
    assert rc == 0 and saved[0]["line"]["correct"] is True


def test_a_killed_rank_ends_the_run_at_once(tmp_path):
    rc, took, saved = run_ranks(tmp_path, "killed")
    assert rc != 0 and took < DEADLINE_S - 10
    assert not saved


def test_a_decomposed_cell_refuses_without_a_card(tmp_path):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "jacobian.weak4096x4", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=DEADLINE_S)
    assert p.returncode != 0 and p.stdout == ""


SLEEPER = """import os, signal, sys, time
open(os.path.join(sys.argv[1], "pid." + os.environ["RANK"]), "w").write(
    str(os.getpid()))
if os.environ["RANK"] == "1":
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
time.sleep(60)
"""


def alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_the_launcher_leaves_nothing_behind(tmp_path, monkeypatch):
    """Ranks that outlive the deadline are ended, one that ignores the
    request to stop too, and none is left."""
    monkeypatch.setattr(ranks, "STOP_GRACE_S", 2)
    script = tmp_path / "sleeper.py"
    script.write_text(SLEEPER)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    t = time.monotonic()
    rc = ranks.launch([str(script), str(run_dir)], 2, str(run_dir),
                      setup_timeout=12)
    assert rc == 124 and time.monotonic() - t < 30
    pids = [int((run_dir / f"pid.{r}").read_text()) for r in (0, 1)]
    assert not [p for p in pids if alive(p)]


def test_the_parent_leaves_no_run_directory(tmp_path):
    """``run.py`` removes the directory its ranks wrote to, after a run
    that fails too."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "jacobian.weak4096x4", "--seed", "7", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                  TMPDIR=str(tmp)),
        capture_output=True, text=True, timeout=DEADLINE_S)
    assert p.returncode != 0 and os.listdir(tmp) == []


# -- the readers of a four-rank run ----------------------------------------------

def four_rank_context(tmp_path, trace=None, chunks=((0.0, 0.1, 25),)):
    cell = harness.find_cell("jacobian.weak4096x4")
    return harness.Context(cell=cell, trace=trace, chunks=list(chunks),
                           spans=[{}], n_points=8192 ** 2, launches={},
                           kind="NVIDIA H100 80GB HBM3", window_steps=7500,
                           window_seconds=30.0, tile_points=4096 ** 2,
                           chips=4)


def test_step_mfu_of_four_cards(tmp_path):
    ctx = four_rank_context(tmp_path)
    ops = roofline.ops_per_point_step(ctx.cell)
    assert step_mfu.read(ctx) == pytest.approx(
        100.0 * ops * 8192 ** 2 * 7500 / (30.0 * 4 * 67000.0e9))


def test_kernel_roofline_of_the_traced_tile(tmp_path):
    """The tile's 4096² points a step against the traced card's K3
    kernels (the one-substage kernel on the exchanged axes)."""
    k3 = "void swmhd::vi_substage<float, (swmhd::Axis)2, (swmhd::Axis)2, " \
         "false>(float const*, float const*, float*, float*)"
    events = [{"ph": "X", "cat": "kernel", "name": k3, "ts": 0,
               "dur": 1000.0 * i, "pid": 0, "tid": 7} for i in (1, 2, 3)]
    events.append({"ph": "X", "cat": "kernel", "ts": 0, "dur": 5000.0,
                   "name": "ncclDevKernel_SendRecv(ncclDevKernelArgs)",
                   "pid": 0, "tid": 8})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    from portbench import tracefile
    ctx = four_rank_context(tmp_path, tracefile.Trace(str(path)))
    ops = roofline.ops_per_point_step(ctx.cell)
    least = max(ops * 4096 ** 2 * 25 / 67000.0e9,
                96.0 * 4096 ** 2 * 25 / 3350.0e9)
    assert kernel_roofline.read(ctx) == pytest.approx(100.0 * least / 6e-3)


def test_exchange_reads_the_union_of_nccl_kernels(tmp_path):
    """Two NCCL kernels overlapping over 10–40 µs and one at 100–110 µs,
    beside a substage kernel, over 2 traced steps: 40 µs, 0.02 ms a
    step."""
    def k(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "pid": 0, "tid": 7}
    events = [k("ncclDevKernel_SendRecv(x)", 10, 20),
              k("ncclKernel_AllReduce_RING_LL_Sum_float(x)", 25, 15),
              k("ncclDevKernel_SendRecv(x)", 100, 10),
              k("void swmhd::vi_substage<float>(x)", 0, 200),
              {"ph": "X", "cat": "cpu_op", "name": "nccl:send", "ts": 0,
               "dur": 300, "pid": 0, "tid": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    from portbench import tracefile
    ctx = types.SimpleNamespace(trace=tracefile.Trace(str(path)), steps=2)
    assert exchange_ms_per_step.read(ctx) == pytest.approx(0.02)
    ctx.trace.kernels = [e for e in ctx.trace.kernels
                         if "nccl" not in e["name"]]
    assert exchange_ms_per_step.read(ctx) is None


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


K3 = "void swmhd::vi_substage<float, (swmhd::Axis)2, (swmhd::Axis)2, false>(x)"


def test_the_median_substage_exchange(tmp_path):
    """Four K3 launches, three stretches between them holding NCCL time
    of 10, 20 (two kernels overlapping by 5) and 400 µs: the median is
    20 µs, where the lagging stretch moves the per-step sum."""
    events = [kernel(K3, t, 100) for t in (0, 200, 400, 1000)]
    events += [kernel("ncclDevKernel_SendRecv(x)", 150, 10),
               kernel("ncclDevKernel_SendRecv(x)", 310, 15),
               kernel("ncclDevKernel_SendRecv(x)", 320, 10),
               kernel("ncclDevKernel_SendRecv(x)", 550, 400),
               kernel("at::native::CatArrayBatchedCopy<x>(y)", 160, 30)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    from portbench import tracefile
    ctx = types.SimpleNamespace(trace=tracefile.Trace(str(path)), steps=1)
    assert exchange_ms_per_substage_p50.read(ctx) == pytest.approx(0.02)
    assert exchange_ms_per_step.read(ctx) == pytest.approx(0.43)
    ctx.trace.kernels = [e for e in ctx.trace.kernels if e["name"] != K3][:1]
    assert exchange_ms_per_substage_p50.read(ctx) is None


def test_the_padding_copies_a_step(tmp_path):
    """The union of the ``torch.cat`` kernels (two overlapping over
    10–50 µs, one at 100–120 µs) over 2 traced steps, and nothing of the
    other copies: 0.03 ms a step."""
    cat = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_"
           "alignedK_contig<at::native::(anonymous namespace)::OpaqueType<4u>,"
           " unsigned int, 3, 128, 1, 16>(x)")
    events = [kernel(cat, 10, 30), kernel(cat, 20, 30), kernel(cat, 100, 20),
              kernel("void at::native::elementwise_kernel<128, 2, at::native"
                     "::direct_copy_kernel_cuda(x)", 200, 50),
              kernel(K3, 0, 300)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    from portbench import tracefile
    ctx = types.SimpleNamespace(trace=tracefile.Trace(str(path)), steps=2)
    assert pad_copy_ms_per_step.read(ctx) == pytest.approx(0.03)
    ctx.trace.kernels = [e for e in ctx.trace.kernels if e["name"] != cat]
    assert pad_copy_ms_per_step.read(ctx) is None


def test_a_one_card_context_reads_as_before(tmp_path):
    """Without the four-rank fields a Context reads the whole grid on one
    card."""
    cell = harness.find_cell("jacobian.2048.periodic")
    ctx = harness.Context(cell=cell, trace=None, chunks=[], spans=[],
                          n_points=2048 ** 2, launches={}, kind="x")
    assert ctx.traced_points == 2048 ** 2 and ctx.chips == 1
