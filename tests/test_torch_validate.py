"""The port's validation driver (``swmhd_tpu_torch.validate``) and its
anchors (``swmhd_tpu_torch.validation_anchors``) against the JAX
package's: the same anchor table, tolerances and verdicts, the same
summaries of the committed series, the same first rows of every case on
the plain float64 path, and no write into the JAX package's records.

The test marked ``cuda`` runs the kernel path and skips without a card:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_validate.py -m cuda``
on the GPU.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from swmhd_tpu_torch import validate
from swmhd_tpu_torch import validation_anchors as anchors

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = os.path.join(REPO, "validation", "series")
SMALLEST = ("conservative", "64x64_two_Gaussians_high_B")   # 1000 steps


def _jax_anchors():
    """``examples/validation_anchors.py``, loaded by path (it imports only
    numpy at module level)."""
    spec = importlib.util.spec_from_file_location(
        "jax_validation_anchors",
        os.path.join(REPO, "examples", "validation_anchors.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = _jax_anchors()


def tag(case):
    return validate.case_tag(*case)


def jax_csv(case):
    return os.path.join(SERIES, f"{tag(case)}.csv")


def jax_f64_summary(case):
    with open(os.path.join(REPO, "validation", "summary.json")) as f:
        rows = json.load(f)
    (row,) = [r for r in rows if (r["formulation"], r["scenario"]) == case]
    return row["got"]


def test_anchor_table_is_the_jax_table():
    assert anchors.REFERENCE == JAX.REFERENCE
    assert anchors.TOL == JAX.TOL
    assert len(anchors.CASES) == 12
    assert set(anchors.CASES) == set(JAX.REFERENCE)


def moved(ref, got, key, inside):
    """``got`` with anchor ``key`` moved just inside or just outside its
    tolerance around ``ref``."""
    tol, f = JAX.TOL, 1 - 1e-6 if inside else 1 + 1e-6
    out = dict(got)
    if key == "ke0" and "ke0" not in ref:
        out["ke0"] = 1e-12 * f
    elif key in ("me0", "ke0"):
        out[key] = ref[key] * (1 + tol["ic_rel"] * f)
    elif key in ("ke_end", "me_end"):
        out[key] = ref[key] * (1 - tol["end_rel"] * f)
    else:
        out[key] = ref[key] * tol["dev_factor"] * f
    return out


@pytest.mark.parametrize("case", anchors.CASES, ids=tag)
def test_judge_agrees_with_jax(case):
    ref = anchors.REFERENCE[case]
    got = jax_f64_summary(case)
    assert anchors.judge(ref, got) == JAX.judge(ref, got)
    assert all(anchors.judge(ref, got).values())
    for key in ("me0", "ke0", "ke_end", "me_end", "dev_max"):
        for inside in (True, False):
            g = moved(ref, got, key, inside)
            checks = anchors.judge(ref, g)
            assert checks == JAX.judge(ref, g)
            assert checks[key] is inside, (key, inside, g[key])


@pytest.mark.parametrize("case", anchors.CASES, ids=tag)
def test_summarize_matches_jax(case):
    ours, theirs = anchors.summarize(jax_csv(case)), JAX.summarize(
        jax_csv(case))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 1e-15, k


def test_compare_series_refuses_other_rows(tmp_path):
    case = SMALLEST
    with open(jax_csv(case)) as f:
        lines = f.readlines()
    short = tmp_path / "short.csv"
    short.write_text("".join(lines[:-1]))
    with pytest.raises(ValueError, match="rows"):
        anchors.compare_series(str(short), jax_csv(case))
    shifted = tmp_path / "shifted.csv"
    rows = [lines[0]] + [",".join([repr(float(r.split(",")[0]) + 1e-6)]
                                  + r.split(",")[1:]) for r in lines[1:]]
    shifted.write_text("".join(rows))
    with pytest.raises(ValueError, match="time"):
        anchors.compare_series(str(shifted), jax_csv(case))


def test_compare_series_of_a_series_with_itself():
    out = anchors.compare_series(jax_csv(SMALLEST), jax_csv(SMALLEST))
    assert set(out) == set(anchors.ENERGIES)
    for v in out.values():
        assert v == dict(early_max=0.0, all_max=0.0, early_rows=500,
                         rows=1001)


@pytest.mark.parametrize("case", anchors.CASES, ids=tag)
def test_run_case_plain_matches_jax_rows(tmp_path, case):
    csv, path, wall = validate.run_case(*case, 0.2, torch.float64, "cpu",
                                        True, str(tmp_path))
    assert path == "plain-f64" and wall > 0
    assert csv == os.path.join(str(tmp_path), "series", "float64",
                               f"{tag(case)}.csv")
    out = anchors.compare_series(csv, jax_csv(case), prefix=True)
    for name, v in out.items():
        assert v["rows"] == 21
        assert v["all_max"] <= 1e-13, (name, v)


def tree_hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_main_leaves_the_jax_records_unchanged(tmp_path):
    """A whole run of the smallest case through ``main`` (1000 steps,
    plain float64): it passes the anchors and the float64 series gate,
    writes only under ``--outdir`` and ``--report``, and changes no file
    under ``validation/``."""
    root = os.path.join(REPO, "validation")
    before = tree_hashes(root)
    report_before = tree_hashes(REPO).get("VALIDATION_H100.md")
    out = tmp_path / "out"
    rc = validate.main(["--device", "cpu", "--dtype", "float64",
                        "--only", tag(SMALLEST), "--outdir", str(out)])
    assert rc == 0
    with open(out / "results" / "float64" / f"{tag(SMALLEST)}.json") as f:
        res = json.load(f)
    assert res["pass"] and res["series_pass"] and res["anchors_pass"]
    assert res["path"] == "plain-f64" and res["device"] == "cpu"
    assert res["jax_f64"] == jax_f64_summary(SMALLEST)
    for v in res["vs_jax"].values():
        assert v["rows"] == 1001 and v["early_max"] <= 1e-10
    # one case of 24 ran: the merged record is incomplete
    assert validate.main(["--merge", "--outdir", str(out), "--report",
                          str(tmp_path / "report.md")]) == 1
    assert tree_hashes(root) == before
    assert tree_hashes(REPO).get("VALIDATION_H100.md") == report_before


def synthetic_result(case, dtype_name, ok=True):
    got = jax_f64_summary(case)
    return {
        "formulation": case[0], "scenario": case[1],
        "path": f"kernel-f{dtype_name[-2:]}", "dtype": dtype_name,
        "steps": 1000, "wall_s": 1.5, "device": "a card",
        "card": "a card, 700.00 W",
        "reference": anchors.REFERENCE[case], "ours": got,
        "checks": {k: ok for k in ("me0", "ke0", "ke_end", "me_end",
                                   "dev_max")},
        "vs_jax": {n: dict(early_max=1e-15, all_max=1e-12, early_rows=500,
                           rows=1001) for n in anchors.ENERGIES},
        "jax_f64": got, "jax_tpu_f32": None, "pass": ok,
    }


@pytest.mark.parametrize("fault", [None, "fail", "missing"])
def test_merge_tables_every_case(tmp_path, fault):
    out = tmp_path / "out"
    for dtype_name in validate.DTYPES:
        d = out / "results" / dtype_name
        d.mkdir(parents=True)
        for k, case in enumerate(anchors.CASES):
            if fault == "missing" and dtype_name == "float32" and k == 3:
                continue
            res = synthetic_result(case, dtype_name,
                                   ok=not (fault == "fail" and k == 5))
            (d / f"{tag(case)}.json").write_text(json.dumps(res))
    report = tmp_path / "VALIDATION_H100.md"
    rc = validate.main(["--merge", "--outdir", str(out), "--report",
                        str(report)])
    assert rc == (0 if fault is None else 1)
    text = report.read_text()
    assert "a card, 700.00 W" in text
    sections = text.split("\n## ")[1:]
    assert [s.split("\n")[0] for s in sections] == list(validate.DTYPES)
    for s in sections:
        rows = [ln for ln in s.split("\n")
                if ln.startswith(("| vector_invariant", "| conservative"))]
        assert len(rows) == 12
    assert ("**FAIL**" in text) == (fault == "fail")
    assert ("**MISSING**" in text) == (fault == "missing")
    for dtype_name in validate.DTYPES:
        with open(out / "results" / dtype_name / "results.json") as f:
            merged = json.load(f)
        n = 11 if fault == "missing" and dtype_name == "float32" else 12
        assert len(merged) == n


def test_cuda_device_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate.main(["--outdir", str(tmp_path)])


def test_plots_without_matplotlib_raise_before_the_run(monkeypatch,
                                                       tmp_path):
    def no_run(*args, **kwargs):
        raise AssertionError("a case ran")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(validate, "run_case", no_run)
    with pytest.raises(ImportError):
        validate.main(["--device", "cpu", "--plots", "--outdir",
                       str(tmp_path)])


def test_the_driver_imports_no_jax():
    code = ("import sys, swmhd_tpu_torch.validate; "
            "bad = [m for m in sys.modules if m in ('jax', 'swmhd_tpu', "
            "'validation_anchors') or m.startswith(('jax.', 'jaxlib', "
            "'swmhd_tpu.', 'examples'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_f64_rows_match_jax_on_card(cuda, tmp_path):
    """100 steps of the walled ``128x128_low_B_low_U`` (A gradient −0.05)
    through the kernel path in float64 against the JAX package's rows."""
    case = ("vector_invariant", "128x128_low_B_low_U")
    csv, path, _ = validate.run_case(*case, 1.0, torch.float64, cuda, True,
                                     str(tmp_path))
    assert path == "kernel-f64"
    out = anchors.compare_series(csv, jax_csv(case), prefix=True)
    for name, v in out.items():
        assert v["rows"] == 101
        assert v["all_max"] <= 1e-10, (name, v)
