"""BENCHMARK.json and every file it names: parsed, found by name, within
the contract's limits."""

import importlib
import os
import re

import pytest

from portbench import harness

from helpers import ROOT

BENCH = harness.load(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_units_and_lines():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"points_per_s", "chunk_ms_p95", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"


def test_per_layer_metrics_have_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(reader.read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.find_cell(name)
    assert cell.chips == int(cell.config.get("ranks", 1))
    assert cell.chips in (1, 4)
    tr = cell.traffic
    for key in ("scenario", "initial", "N", "dt", "stop_time",
                "progress_every", "perturbation"):
        assert key in tr
    assert set(cell.check["limits"]) == (
        {"state_gap", "energy_gap"} if tr.get("series_every")
        else {"state_gap"})
    assert cell.check["chunks"] >= 2
    # chunk_ms_p95 is end to end only in the cells it lists, per layer
    # (window_chunk_ms_p95) where the host swings it too widely for a bound
    assert {m["name"] for m in cell.end_to_end} == (
        {"points_per_s", "chunk_ms_p95", "setup_s"}
        if name in E2E["chunk_ms_p95"].get("workloads", CELLS)
        else {"points_per_s", "setup_s"})
    assert all(m["moves"] in {e["name"] for e in cell.end_to_end}
               for m in cell.per_layer)


def test_configs_are_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        conf = harness.load(os.path.join(ROOT, c["file"]))
        assert conf["name"] == c["name"]
        assert conf["dtype"] in ("float32", "float64")
        # only scale is cut: keys of the file, and no width among them
        assert all(k in conf for k in c["reduced"])
        assert not [k for k in c["reduced"]
                    if k.endswith(("_dim", "_rank", "_size", "_factor"))
                    or k in ("tile", "N", "halo")]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_traffic_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_paths_hold_only_names():
    """Every file under paths is named from a name's characters and /."""
    base = os.path.join(ROOT, "portbench")
    for dirpath, dirnames, files in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
