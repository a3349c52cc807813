"""swmhd_tpu_torch.profiling on the CPU: benchmark_step (the mirror of
tests/test_profiling.py), the card tables and their detectors, the trace
parser against swmhd_tpu.profiling.parse_overlap (exact: both are plain
Python), the torch rules for host runtime calls, and measure_overlap of a
decomposed step on two gloo ranks (tests/torch_group_worker.py).
"""

import gzip
import json

import numpy as np
import pytest
import torch

from swmhd_tpu import profiling as jprof
from swmhd_tpu_torch import Grid, ShallowWaterModel, profiling
from swmhd_tpu_torch.profiling import StepBenchmark, benchmark_step
from torch_group_worker import run_group

torch.set_num_threads(1)


def small_model():
    g = Grid.regular(32, 32, (0, 1), (0, 1), dtype=torch.float64,
                     device="cpu")
    return ShallowWaterModel(grid=g, momentum_advection="centered2",
                             mass_advection="centered2",
                             tracer_advection="centered2")


def test_benchmark_step_counts():
    model = small_model()
    state = model.initial_state(h=1.0)
    bench = benchmark_step(model.step_fn(1e-3, 2), state,
                           n_steps_per_call=2, n_calls=3)
    assert isinstance(bench, StepBenchmark)
    assert bench.n_steps == 6
    assert bench.grid_points == 32 * 32
    assert bench.points_per_s > 0
    assert bench.points_per_s == pytest.approx(
        bench.grid_points * bench.n_steps / bench.wall_s)
    assert "pts/s" in str(bench)
    assert len(bench.per_call_s) == 2 and bench.wall_s == min(
        bench.per_call_s)
    assert bench.rel_spread is not None and bench.rel_spread >= 0
    # no roofline on the CPU
    assert bench.hbm_gbps_estimate is None
    assert bench.hbm_fraction_of_light is None
    assert "roofline" not in str(bench)


def test_rel_spread():
    b = StepBenchmark(1.0, 1.0, 1.0, 1, 1, per_call_s=(2.0, 2.5, 2.2))
    assert b.rel_spread == pytest.approx(0.25)
    assert StepBenchmark(1.0, 1.0, 1.0, 1, 1, per_call_s=(2.0,)
                         ).rel_spread is None


def test_detectors_return_none_on_the_cpu(monkeypatch):
    assert profiling.detect_hbm_peak("cpu") is None
    assert profiling.detect_vpu_peak(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.detect_hbm_peak() is None
    assert profiling.detect_vpu_peak() is None


@pytest.mark.parametrize("name,gbps,gflops", [
    ("NVIDIA H100 80GB HBM3", 3350.0, 67000.0),
    ("NVIDIA H100 SXM5 80GB", 3350.0, 67000.0),
    ("NVIDIA H100 PCIe", 2000.0, 51000.0),
    ("NVIDIA H100 NVL", 3900.0, 60000.0),
    ("NVIDIA A100-SXM4-80GB", None, None)])
def test_detectors_pick_the_cards_row(monkeypatch, name, gbps, gflops):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert profiling.detect_hbm_peak("cuda:0") == gbps
    assert profiling.detect_vpu_peak("cuda:0") == gflops


def test_detectors_take_the_longest_key(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 NVL")
    monkeypatch.setitem(profiling.HBM_PEAK_GBPS, "h100", 1.0)
    assert profiling.detect_hbm_peak("cuda:0") == 3900.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 (some other)")
    assert profiling.detect_hbm_peak("cuda:0") == 1.0


def test_tables_hold_only_h100_rows():
    for table in (profiling.HBM_PEAK_GBPS, profiling.VPU_PEAK_GFLOPS):
        assert sorted(table) == ["h10080gbhbm3", "h100nvl", "h100pcie",
                                 "h100sxm"]


def x(name, ts, dur, **kw):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 1, **kw}


def write_trace(path, events):
    data = json.dumps({"traceEvents": events})
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        with open(path, "w") as f:
            f.write(data)
    return path


# JAX-named events (no category), seeded spans: collectives, fusions,
# runtime bookkeeping, instant and metadata events
def jax_events(seed=0):
    rng = np.random.default_rng(seed)
    names = ["collective-permute.3", "all-reduce-start", "rendezvous",
             "fusion.12", "loop_add_fusion", "custom-call.weno",
             "ThunkExecutor::Execute", "wait-for-stream", "end: all-reduce",
             "BufferAllocation", "copy.7", "ppermute"]
    evs = [x(str(rng.choice(names)), float(rng.uniform(0, 1000)),
             float(rng.uniform(0.5, 80))) for _ in range(60)]
    evs += [{"ph": "i", "name": "marker", "ts": 5.0},
            {"ph": "M", "name": "thread_name", "args": {"name": "t"}},
            {"ph": "X", "name": "no duration", "ts": 1.0}]
    return evs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_overlap_equals_jax_on_jax_traces(tmp_path, seed):
    path = write_trace(str(tmp_path / "perfetto_trace.json.gz"),
                       jax_events(seed))
    want = jprof.parse_overlap(path)
    assert want["n_comm_events"] > 0 and want["n_compute_events"] > 0
    assert profiling.parse_overlap(path) == want
    plain = write_trace(str(tmp_path / "trace.json"), jax_events(seed))
    assert profiling.parse_overlap(plain) == want


def test_parse_overlap_torch_rules(tmp_path):
    """On the card only device events are compute: a cudaLaunchKernel or
    cudaStreamSynchronize (host runtime) and an aten:: operator count as
    neither, an NCCL kernel or a gloo annotation as exchange. Without
    device events the host operators are the compute."""
    card = [x("cudaLaunchKernel", 0, 100, cat="cuda_runtime"),
            x("cudaStreamSynchronize", 100, 400, cat="cuda_runtime"),
            x("aten::add", 0, 50, cat="cpu_op"),
            x("void swmhd::vi_substage<float>", 10, 30, cat="kernel"),
            x("Memcpy DtoH (Device -> Pinned)", 40, 10, cat="gpu_memcpy"),
            x("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
              20, 40, cat="kernel"),
            x("gloo:send", 200, 100, cat="user_annotation"),
            x("python: step", 0, 500, cat="python_function")]
    got = profiling.parse_overlap(write_trace(str(tmp_path / "c.json.gz"),
                                              card))
    assert (got["n_compute_events"], got["n_comm_events"]) == (2, 2)
    assert got["compute_ms"] == pytest.approx(40e-3)
    assert got["comm_ms"] == pytest.approx(140e-3)
    assert got["hidden_ms"] == pytest.approx(30e-3)    # 20..50
    assert got["overlap_pct"] == pytest.approx(100 * 30 / 140)
    launch_only = profiling.parse_overlap(write_trace(
        str(tmp_path / "l.json"), card[:2]))
    assert (launch_only["n_compute_events"],
            launch_only["n_comm_events"]) == (0, 0)
    assert launch_only["overlap_pct"] is None

    cpu = [x("aten::mul", 0, 50, cat="cpu_op"),
           x("c10d::send", 40, 30, cat="cpu_op"),
           x("gloo:recv", 60, 30, cat="user_annotation"),
           x("cudaLaunchKernel", 0, 10, cat="cuda_runtime")]
    got = profiling.parse_overlap(write_trace(str(tmp_path / "p.json"), cpu))
    assert (got["n_compute_events"], got["n_comm_events"]) == (1, 2)
    assert got["hidden_ms"] == pytest.approx(10e-3)


def test_parse_overlap_of_chosen_kernels(tmp_path):
    """With a kernel predicate: the chosen kernels' device time and the
    exchange they cover (the interior of the overlap split under a gloo
    transfer), beside the totals, which do not change."""
    evs = [x("void swmhd::vi_substage<float, 2, 2>", 0, 100, cat="kernel",
             args={"grid": [32, 127, 1]}),
           x("void swmhd::vi_substage<float, 2, 2>", 120, 10, cat="kernel",
             args={"grid": [32, 1, 1]}),
           x("c10d::recv_", 50, 75, cat="cpu_op"),
           x("gloo:send", 20, 10, cat="user_annotation")]
    path = write_trace(str(tmp_path / "k.json"), evs)
    got = profiling.parse_overlap(
        path, kernel=lambda e: e["args"]["grid"][1] > 1)
    assert got == {**profiling.parse_overlap(path),
                   "kernel_ms": pytest.approx(0.1),
                   "kernel_hidden_ms": pytest.approx(60e-3),  # 20..30, 50..100
                   "n_kernel_events": 1}
    assert got["hidden_ms"] == pytest.approx(65e-3)   # and 120..125


def test_trace_writes_a_chrome_trace(tmp_path):
    model = small_model()
    state = model.initial_state(h=1.0)
    step = model.step_fn(1e-3, 1)
    with profiling.trace(str(tmp_path / "prof")) as out:
        step(state)
    assert out is None
    path = tmp_path / "prof" / profiling.TRACE_FILE
    with gzip.open(path, "rt") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert any(n.startswith("aten::") for n in names)
    stats = profiling.parse_overlap(str(path))
    assert stats["n_compute_events"] > 0 and stats["n_comm_events"] == 0
    busy = profiling.device_busy(str(path))
    assert busy["n_kernels"] == 0 and busy["busy_ms"] == 0
    assert busy["window_ms"] > 0 and busy["busy_share"] == 0


def test_device_busy_is_the_union_of_kernels(tmp_path):
    path = write_trace(str(tmp_path / "b.json"), [
        x("aten::add", 0, 10, cat="cpu_op"),
        x("k1", 20, 30, cat="kernel"), x("k2", 40, 20, cat="kernel"),
        x("cudaDeviceSynchronize", 10, 90, cat="cuda_runtime"),
        x("python: step", -50, 500, cat="python_function")])
    got = profiling.device_busy(path)
    assert got == {"window_ms": 0.1, "busy_ms": 0.04, "busy_share": 0.4,
                   "n_kernels": 2}


def test_measure_overlap_two_ranks(tmp_path):
    """The decomposed step over two gloo ranks under the profiler: well
    formed exchange and compute statistics on every rank."""
    for ov in run_group("overlap", 2, tmp_path):
        assert ov.get("error") is None, ov
        assert ov["n_comm_events"] > 0, ov
        assert ov["n_compute_events"] > 0, ov
        assert ov["comm_ms"] > 0 and ov["compute_ms"] > 0, ov
        assert ov["overlap_pct"] is None or 0 <= ov["overlap_pct"] <= 100, ov
