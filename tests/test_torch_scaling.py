"""swmhd_tpu_torch.scaling, the port's scaling sweep, against
``benchmarks/scaling.py`` on the CPU: the grid of each rank count and the
efficiency of each row (exact), from the JAX sweep's own ``main`` with
its timing stubbed beside the port's with its rank runs stubbed at the
same rates; ``build_model`` against the JAX one (float32, within 1e-6
of each field's scale); one one-rank and one two-rank gloo run of the
worker at 16² a rank; and ``multihost.run_checked``, which starts the
groups.

Tests marked ``cuda`` run two ranks sharing the card and skip without
one: ``python -m pytest tests/test_torch_scaling.py -m cuda`` on the GPU.
"""

import importlib.util
import json
import math
import os
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from swmhd_tpu_torch import scaling
from swmhd_tpu_torch.parallel import multihost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# points/s of each (rank count, overlap) handed to both sweeps
RATES = {(1, False): 1.25e9, (2, False): 2.1e9, (2, True): 1.9e9,
         (4, False): 3.7e9, (4, True): 3.3e9, (8, False): 6.1e9,
         (8, True): 5.0e9}


@pytest.fixture
def jax_scaling(monkeypatch):
    """``benchmarks/scaling.py`` as a module, imported without its
    jax.config updates (the compile cache it would point at
    ``benchmarks/``) and without keeping its sys.path entry."""
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "jax_scaling", os.path.join(REPO, "benchmarks", "scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_rows(mod, mode, monkeypatch, capsys):
    """The JAX sweep's rows over 8 devices at RATES, with and without
    overlap above one device."""
    monkeypatch.setattr(jax, "devices", lambda: [
        types.SimpleNamespace(device_kind="fake")] * 8)
    monkeypatch.setattr(
        mod, "bench_config",
        lambda n, Nx, Ny, steps, overlap, want_overlap_pct=False: (
            types.SimpleNamespace(points_per_s=RATES[(n, overlap)]), None))
    monkeypatch.setattr(sys, "argv", ["scaling.py", "--mode", mode,
                                      "--local", "64", "--global-size",
                                      "512"])
    mod.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out["results"]


def port_rows(mode, monkeypatch, capsys):
    """The port's rows over 8 ranks with each rank count's run stubbed
    at RATES."""
    monkeypatch.setattr(
        scaling, "run_ranks", lambda n, Nx, Ny, steps, device, overlap: {
            "points_per_s": RATES[(n, overlap)], "launches": {},
            "split": overlap, "overlap_pct": None,
            "comm_ms": None, "device_kind": "fake"})
    out = scaling.main(["--mode", mode, "--local", "64", "--global-size",
                        "512", "--max-ranks", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert [json.loads(ln) for ln in lines[:-1]] == out["results"]
    return out["results"]


@pytest.mark.parametrize("mode", ["weak", "strong"])
def test_rows_match_the_jax_sweep(mode, jax_scaling, monkeypatch, capsys):
    """For n = 1, 2, 4, 8, above one without and with overlap: the same
    rows, grid, points/s and efficiency as ``benchmarks/scaling.py:93-111``
    at the same rates; every row carries its launches, and above one rank
    its split, overlap share and exchange time."""
    want = jax_rows(jax_scaling, mode, monkeypatch, capsys)
    got = port_rows(mode, monkeypatch, capsys)
    assert [(r["devices"], r["overlap"]) for r in got] == [
        (1, False), (2, False), (2, True), (4, False), (4, True),
        (8, False), (8, True)]
    assert len(got) == len(want)
    for r in got:
        assert "launches" in r
        assert ({"split", "overlap_pct", "comm_ms"} <= set(r)) == (
            r["devices"] > 1)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("devices", "grid", "overlap",
                                  "points_per_s", "efficiency")} == {
            k: w[k] for k in ("devices", "grid", "overlap", "points_per_s",
                              "efficiency")}


@pytest.mark.parametrize("n,weak", [(1, (64, 64)), (2, (64, 128)),
                                    (4, (128, 128)), (8, (128, 256))])
def test_grid_for_each_rank_count(n, weak):
    assert scaling.grid_for("weak", n, 64, 512) == weak
    assert scaling.grid_for("strong", n, 64, 512) == (512, 512)
    assert weak[0] * weak[1] == n * 64 * 64


@pytest.mark.parametrize("mode,n,rate,eff", [("weak", 4, 4e9, 0.8),
                                             ("strong", 4, 2e9, 0.4)])
def test_efficiency(mode, n, rate, eff):
    """Against 1.25e9 points/s a rank: weak per rank, strong in total."""
    assert math.isclose(scaling.efficiency(mode, rate, n, 1.25e9), eff)


def test_build_model_matches_jax(jax_scaling):
    """float32 fields within 1e-6 of each field's scale: XLA's and
    PyTorch's exp may round a value to neighbouring floats."""
    _, js = jax_scaling.build_model(32, 48)
    _, ts = scaling.build_model(32, 48, "cpu")
    for name in ("u", "v", "h", "A"):
        got, want = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (32, 48)
        assert (np.max(np.abs(got - want))
                <= 1e-6 * np.max(np.abs(want))), name


def test_two_rank_worker_on_cpu():
    """One gloo group of two ranks on a 16 × 32 grid (a 1×2 mesh of 16²
    tiles), 2 steps a call: the slowest rank's points/s and rank 0's
    overlap of a traced call."""
    rep = scaling.run_ranks(2, 16, 32, 2, "cpu")
    assert rep["device_kind"] == "cpu"
    assert rep["launches"] == {"substage": 0, "multistep": 0,
                               "substage_by_part": {}}
    assert math.isfinite(rep["points_per_s"]) and rep["points_per_s"] > 0
    assert rep["comm_ms"] > 0
    assert 0.0 <= rep["overlap_pct"] <= 100.0


def test_two_rank_worker_with_the_split_on_cpu():
    """Two ranks on 24² tiles (a 1×2 mesh, 3 · 6 <= 24) with overlap: the
    split is taken (its launches are plain calls here), and rank 0's
    traced call has exchange events."""
    rep = scaling.run_ranks(2, 24, 48, 2, "cpu", overlap=True)
    assert rep["split"] is True
    assert rep["launches"] == {"substage": 0, "multistep": 0,
                               "substage_by_part": {}}
    assert math.isfinite(rep["points_per_s"]) and rep["points_per_s"] > 0
    assert rep["comm_ms"] > 0
    assert 0.0 <= rep["overlap_pct"] <= 100.0


def test_one_rank_worker_on_cpu():
    """One rank is a group of its own too, so that the sweep's process
    never holds the card: the plain step, no overlap measured."""
    rep = scaling.run_ranks(1, 16, 16, 2, "cpu")
    assert rep["device_kind"] == "cpu"
    assert rep["launches"] == {"substage": 0, "multistep": 0,
                               "substage_by_part": {}}
    assert math.isfinite(rep["points_per_s"]) and rep["points_per_s"] > 0
    assert rep["overlap_pct"] is None and rep["comm_ms"] is None


def test_run_checked_returns_the_output():
    out = multihost.run_checked(
        [sys.executable, "-c", "import os; print(os.environ['SWMHD_X'])"],
        {"SWMHD_X": "seen"}, timeout=60)
    assert out == "seen\n"


def test_run_checked_raises_on_a_nonzero_exit():
    with pytest.raises(RuntimeError, match="exited 3:\ntail"):
        multihost.run_checked([sys.executable, "-c", "import sys; "
                               "print('tail'); sys.exit(3)"], timeout=60)


def test_run_checked_kills_the_group_on_a_timeout(tmp_path):
    """A timeout raises, and kills the command's children with it."""
    pid_file = tmp_path / "child.pid"
    code = ("import subprocess, sys, time; c = subprocess.Popen([sys."
            "executable, '-c', 'import time; time.sleep(60)']); open(sys."
            "argv[1], 'w').write(str(c.pid)); time.sleep(60)")
    with pytest.raises(RuntimeError, match="did not end within 3 s"):
        multihost.run_checked([sys.executable, "-c", code, str(pid_file)],
                              timeout=3)
    status = f"/proc/{pid_file.read_text()}/status"
    for _ in range(50):
        # gone, or a zombie that nothing has reaped yet
        if not os.path.exists(status) or "\nState:\tZ" in open(
                status).read():
            break
        time.sleep(0.1)
    else:
        raise AssertionError("the child outlived the timeout")


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling.main(["--max-ranks", "1"])


# -- on the card ------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_two_ranks_share_the_card(overlap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rep = scaling.run_ranks(2, 64, 128, 5, "cuda", overlap)
    assert rep["device_kind"] == torch.cuda.get_device_name(0)
    # rank 0's tile substages: 3 a step, 5 steps a call, 7 calls; with
    # the split (64² tiles of a 1×2 mesh) an interior and two bands each
    parts = ({"interior": 105, "band": 210} if overlap
             else {"tile": 105})
    assert rep["split"] == overlap
    assert rep["launches"] == {"substage": sum(parts.values()),
                               "multistep": 0, "substage_by_part": parts}
    assert math.isfinite(rep["points_per_s"]) and rep["points_per_s"] > 0
    assert rep["comm_ms"] > 0
