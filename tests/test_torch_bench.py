"""swmhd_tpu_torch.bench, the port's headline benchmark, against the repo's
``bench.py`` on the CPU: the model and state of ``build`` (float64, 1e-15),
the steps-a-call rule (exact, read out of ``bench.bench_one`` with its
build and timer stubbed), the operation count a point (the same at two
sizes), the roofline's denominator ``min(measured, analytic)``, the route
per size with the card's L2 stubbed at the H100's 52,428,800 B, and
``main`` on the CPU (the plain step, no roofline: ``vs_baseline`` null).

Tests marked ``cuda`` run the kernels' routes on the card and skip without
one: ``python -m pytest tests/test_torch_bench.py -m cuda`` on the GPU.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from swmhd_tpu import profiling as jax_profiling
from swmhd_tpu_torch import Grid, ShallowWaterModel
from swmhd_tpu_torch import bench
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.profiling import StepBenchmark

torch.set_num_threads(1)

FIELDS = ("u", "v", "h", "A")
H100_L2 = 52_428_800
# NVIDIA H100 SXM: GB/s of device memory, GFLOP/s fp32 outside the tensor
# cores (profiling.HBM_PEAK_GBPS, VPU_PEAK_GFLOPS)
H100_PEAKS = (3350.0, 67000.0)


def test_build_matches_jax():
    """``bench.build(64)`` in float64: every field within 1e-15 of the JAX
    package's."""
    _, js = jax_bench.build(64, dtype=jnp.float64)
    _, ts = bench.build(64, torch.float64, "cpu")
    for name in FIELDS:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.shape == want.shape == (64, 64)
        assert np.max(np.abs(got - want)) <= 1e-15, name


def jax_steps_per_call(N, monkeypatch):
    """The steps a call that ``bench.py``'s ``bench_one(N)`` times, with
    its model build and ``benchmark_step`` stubbed (nothing is built or
    run)."""
    seen = []

    class Model:
        def step_fn(self, dt, n):
            return lambda s: s

    monkeypatch.setattr(jax_bench, "build", lambda N: (Model(), None))
    monkeypatch.setattr(
        jax_profiling, "benchmark_step",
        lambda step, state, n, n_calls: seen.append(n) or "bench")
    jax_bench.bench_one(N, use_fused=False)
    return seen[0]


@pytest.mark.parametrize("N,steps", [(128, 24414), (512, 1525), (2048, 95),
                                     (4096, 23), (8192, 10)])
def test_steps_per_call_is_bench_py_rule(N, steps, monkeypatch):
    assert bench.steps_per_call(N) == steps
    assert jax_steps_per_call(N, monkeypatch) == steps


def test_flops_per_point_is_size_independent():
    """One plain RK3 step on a periodic grid does the same elementwise
    operations a point at 64² and at 128²."""
    a = bench.measure_flops_per_point(64)
    b = bench.measure_flops_per_point(128)
    assert a is not None and a > 0
    assert a == b


@pytest.mark.parametrize("measured", [5000.0, 1000.0, None])
def test_roofline_denominator_is_min_of_measured_and_analytic(measured):
    b = StepBenchmark(steps_per_s=1e3, points_per_s=4.5e9, wall_s=1.0,
                      n_steps=10, grid_points=2048 ** 2,
                      per_call_s=(1.0, 1.1))
    out = bench.headline(2048, "substage-cuda", "card", b, measured,
                         *H100_PEAKS)
    flops = min(measured or bench.ANALYTIC_FLOPS_PER_POINT,
                bench.ANALYTIC_FLOPS_PER_POINT)
    vpu_limit = H100_PEAKS[1] * 1e9 / flops
    hbm_limit = H100_PEAKS[0] * 1e9 / bench.BYTES_PER_POINT
    roofline = min(vpu_limit, hbm_limit)
    assert out["vpu_fraction_of_peak"] == round(4.5e9 / vpu_limit, 4)
    assert out["hbm_fraction_of_light"] == round(4.5e9 / hbm_limit, 4)
    assert out["fraction_of_roofline"] == round(4.5e9 / roofline, 4)
    assert out["vs_baseline"] == round(4.5e9 / (0.8 * roofline), 4)
    assert out["binding_limit"] == ("fp32 compute" if vpu_limit < hbm_limit
                                    else "HBM bandwidth")
    assert out["flops_per_point_analytic"] == 3274.0
    assert ("flops_per_point_measured" in out) == (measured is not None)
    assert out["rel_spread"] == 0.1
    assert f"= {flops:.0f} op/pt" in out["metric"]
    assert "vs_reference_cpu_estimate" not in out


@pytest.mark.parametrize("N,path", [(128, "resident-cuda"),
                                    (512, "resident-cuda"),
                                    (1024, "substage-cuda"),
                                    (2048, "substage-cuda"),
                                    (4096, "substage-cuda"),
                                    (8192, "substage-cuda")])
def test_route_per_size_with_the_h100_l2(N, path, monkeypatch):
    """``takes_resident`` with the card's L2 at the H100's 52,428,800 B:
    the resident kernel where 16 float32 words a point fit."""
    monkeypatch.setattr(K, "l2_bytes", lambda index: H100_L2)
    grid = Grid.regular(N, N, (-5.0, 5.0), (-5.0, 5.0), device="cpu")
    model = ShallowWaterModel(grid=grid)
    assert bench.route(model, torch.empty(0, dtype=torch.float32)) == path


def cpu_main(monkeypatch, capsys, **env):
    """``main(["--device", "cpu"])`` at 32² with 2 steps a call; its
    stdout lines."""
    monkeypatch.setenv("SWMHD_BENCH_N", "32")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "bench_one",
                        functools.partial(bench.bench_one, steps_per_call=2))
    bench.main(["--device", "cpu"])
    return capsys.readouterr().out.strip().splitlines()


def test_main_on_cpu_prints_the_json_line_without_roofline(monkeypatch,
                                                           capsys):
    lines = cpu_main(monkeypatch, capsys, SWMHD_BENCH_LADDER="")
    out = json.loads(lines[-1])
    assert out["vs_baseline"] is None
    assert "vs_reference_cpu_estimate" not in out
    assert "ladder" not in out
    assert out["nonfinite"] == []
    assert out["unit"] == "points/s" and out["value"] > 0
    assert "plain path on cpu" in out["metric"]
    size = json.loads(lines[-2].removeprefix("size "))
    assert size["N"] == 32 and size["path"] == "plain"
    assert size["steps_per_call"] == 2 and size["finite"] is True
    assert size["launches"] == {"substage": 0, "multistep": 0,
                                "multistep_substages": 0}


def test_main_on_cpu_runs_a_ladder(monkeypatch, capsys):
    lines = cpu_main(monkeypatch, capsys, SWMHD_BENCH_LADDER="16,24")
    out = json.loads(lines[-1])
    assert list(out["ladder"]) == ["16", "24"]
    assert all(v > 0 for v in out["ladder"].values())
    assert [json.loads(ln.removeprefix("size "))["N"]
            for ln in lines[:-1]] == [32, 16, 24]


def test_main_names_the_sizes_that_end_nonfinite(monkeypatch, capsys):
    """A size whose state ends inf/NaN keeps its rate in ``ladder`` and is
    named in ``nonfinite``."""
    run = functools.partial(bench.bench_one, steps_per_call=2)

    def bench_one(N, use_fused, device):
        b, path, size = run(N, use_fused, device=device)
        return b, path, dict(size, finite=N != 24)
    monkeypatch.setenv("SWMHD_BENCH_N", "32")
    monkeypatch.setenv("SWMHD_BENCH_LADDER", "16,24")
    monkeypatch.setattr(bench, "bench_one", bench_one)
    bench.main(["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out["ladder"]) == ["16", "24"]
    assert out["nonfinite"] == [24]


def test_kernels_on_the_cpu_raise(monkeypatch):
    monkeypatch.setenv("SWMHD_BENCH_FUSED", "1")
    with pytest.raises(ValueError, match="needs --device cuda"):
        bench.main(["--device", "cpu"])


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("N", [128, 1024])
def test_bench_one_counts_its_route_on_the_card(cuda, N):
    """10 steps a call, 2 calls a repetition: 5 calls in all (warm-up and
    two repetitions), each one resident launch of 10 steps, or 30
    one-substage launches, as ``takes_resident`` picks."""
    b, path, size = bench.bench_one(N, True, steps_per_call=10, n_calls=2,
                                    device=cuda)
    launches = size["launches"]
    if path == "resident-cuda":
        assert launches == {"substage": 0, "multistep": 5,
                            "multistep_substages": 150}
    else:
        assert path == "substage-cuda"
        assert launches == {"substage": 150, "multistep": 0,
                            "multistep_substages": 0}
    assert size["finite"] and b.points_per_s > 0
