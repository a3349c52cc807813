"""Scenario validation of the port, port of ``examples/validate_reference.py``
(float64) and ``examples/validate_tpu_fused.py`` (float32 through the
stepper the CLI ships), in one driver:

    python -m swmhd_tpu_torch.validate --dtype float64      # on the card
    python -m swmhd_tpu_torch.validate --dtype float32
    python -m swmhd_tpu_torch.validate --merge              # the report
    python -m swmhd_tpu_torch.validate --device cpu --dtype float64 \\
        --only conservative_64x64_two_Gaussians_high_B     # plain, CPU

Each of the 12 scenario × formulation cases of
:data:`~swmhd_tpu_torch.validation_anchors.CASES` runs to its reference
stop time through the stepper :func:`swmhd_tpu_torch.cli.select_stepper`
picks (on CUDA the hand-written substage, three launches a step, which the
driver counts; ``--no-fused`` the plain PyTorch step), with the energies
of :func:`~swmhd_tpu_torch.diagnostics.reference_energy_report` written
every iteration. Per case it writes ``<outdir>/series/<dtype>/<tag>.csv``
and ``<outdir>/results/<dtype>/<tag>.json`` and prints that JSON on one
line. ``--merge`` gathers the results of both dtypes into
``results/<dtype>/results.json`` and the report (``VALIDATION_H100.md``).

The gates, each failure an exit code of 1:

- the anchors: ``judge`` passes, in both dtypes;
- float64 only: the series has the rows and times of the JAX package's
  float64 series ``validation/series/<tag>.csv`` and every energy lies
  within 1e-10 of it over the first 500 rows. Later rows are recorded and
  not gated: round-off grows in the turbulent cases.

The JAX package's own records under ``validation/`` are read, never
written: the outputs default to ``validation/h100/``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys

import torch

from .io.readers import ScalarTimeSeries
from .validation_anchors import (CASES, ENERGIES, REFERENCE, compare_series,
                                 judge, summarize)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SERIES = os.path.join(REPO, "validation", "series")
JAX_SUMMARY = os.path.join(REPO, "validation", "summary.json")
JAX_TPU_RESULTS = os.path.join(REPO, "validation", "tpu_r05", "results.json")
OUTDIR = os.path.join(REPO, "validation", "h100")
REPORT = os.path.join(REPO, "VALIDATION_H100.md")
DTYPES = ("float64", "float32")
EARLY_ROWS = 500
SERIES_BOUND = 1e-10      # float64, every energy, the first EARLY_ROWS rows


def case_tag(formulation, name):
    return f"{formulation}_{name}"


def run_case(formulation, name, stop_time, dtype, device, fused, outdir):
    """Run one case to ``stop_time`` with its energy series every
    iteration: ``(csv, path, wall_s)``, ``path`` one of ``kernel-f32``,
    ``kernel-f64``, ``plain-f32``, ``plain-f64``.

    On the kernel path the substage kernel must have launched three times
    a step and no plain substage may have run: ``RuntimeError``
    otherwise."""
    from . import cli, diagnostics, scenarios
    from .io import ScalarSeriesWriter
    from .ops import substage as K
    from .simulation import (Callback, IterationInterval, Simulation,
                             progress_callback)

    model, state, sc = scenarios.build(name, formulation, dtype=dtype,
                                       device=device)
    # a copy: no stepper may move the potential energy's reference height
    h0 = state.h.clone()
    dtype_name = str(dtype).rsplit(".", 1)[-1]
    csv = os.path.join(outdir, "series", dtype_name,
                       f"{case_tag(formulation, name)}.csv")
    stepper, path = cli.select_stepper(model, fused)

    sim = Simulation(model, dt=sc.dt, stop_time=stop_time, stepper=stepper)
    sim.callbacks["progress"] = Callback(progress_callback(),
                                         IterationInterval(2000))
    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=lambda m, st: diagnostics.reference_energy_report(m, st, h0),
        schedule=IterationInterval(1), path=csv)

    def counts():
        return (sum(K.substage.launches_by_branch.values()),
                K.substage_reference.calls)

    launches0, plain0 = counts()
    final = sim.run(state)
    launches, plain = counts()
    steps = int(final.clock.iteration)
    if path == "kernel" and (launches - launches0 != 3 * steps
                             or plain != plain0):
        raise RuntimeError(
            f"{case_tag(formulation, name)}: {steps} steps on the kernel "
            f"path launched the substage {launches - launches0} times "
            f"(expected {3 * steps}) and ran the plain substage "
            f"{plain - plain0} times (expected 0)")
    return csv, f"{path}-f{dtype_name[-2:]}", sim.run_wall_time


def card_line():
    """The card's name and power limit as nvidia-smi prints them, None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.splitlines()[0].strip() if out.returncode == 0 \
        and out.stdout.strip() else None


def jax_summaries():
    """``{tag: (JAX f64 summary, JAX TPU f32 summary)}`` from the JAX
    package's committed records."""
    with open(JAX_SUMMARY) as f:
        f64 = {case_tag(r["formulation"], r["scenario"]): r["got"]
               for r in json.load(f)}
    with open(JAX_TPU_RESULTS) as f:
        f32 = {case_tag(r["formulation"], r["scenario"]): r["ours"]
               for r in json.load(f)}
    return {tag: (f64.get(tag), f32.get(tag)) for tag in f64.keys() | f32}


def case_result(formulation, name, dtype_name, csv, path, wall_s, device,
                card, jax):
    """The record of one case, with its gates and ``pass``."""
    tag = case_tag(formulation, name)
    ref = REFERENCE[(formulation, name)]
    got = summarize(csv)
    checks = judge(ref, got)
    steps = len(ScalarTimeSeries(csv).time) - 1
    try:
        vs_jax = compare_series(csv, os.path.join(JAX_SERIES, f"{tag}.csv"),
                                EARLY_ROWS)
    except ValueError as e:
        vs_jax = {"error": str(e)}
    series_ok = None
    if dtype_name == "float64":
        series_ok = "error" not in vs_jax and all(
            vs_jax[n]["early_max"] <= SERIES_BOUND for n in ENERGIES)
    jax_f64, jax_tpu_f32 = jax.get(tag, (None, None))
    return {
        "formulation": formulation, "scenario": name, "path": path,
        "dtype": dtype_name, "steps": steps, "wall_s": wall_s,
        "device": device,
        "card": card, "reference": ref, "ours": got, "checks": checks,
        "anchors_pass": all(checks.values()), "vs_jax": vs_jax,
        "series_bound": SERIES_BOUND if series_ok is not None else None,
        "series_pass": series_ok, "jax_f64": jax_f64,
        "jax_tpu_f32": jax_tpu_f32,
        "pass": all(checks.values()) and series_ok is not False,
    }


def _max_delta(vs_jax, key):
    if "error" in vs_jax:
        return "rows differ"
    return f"{max(vs_jax[n][key] for n in ENERGIES):.3e}"


def _triple(r, key):
    vals = [r["ours"], r.get("jax_f64"), r.get("jax_tpu_f32")]
    return " / ".join("—" if v is None else f"{v[key]:.5g}" for v in vals)


def write_report(results, path):
    """``VALIDATION_H100.md`` from ``{dtype: [case records]}`` (a case
    that did not run is ``None``): ``(runs passed, runs in all)``."""
    cards = sorted({r["card"] or r["device"] for rows in results.values()
                    for r in rows if r is not None})
    lines = [
        "# VALIDATION_H100 — the port's 12 scenario × formulation runs "
        "on the card",
        "",
        f"Card (`nvidia-smi --query-gpu=name,power.limit`, read by each "
        f"run): {'; '.join(cards) or 'no case ran'}.",
        "",
        "Generator: `python -m swmhd_tpu_torch.validate --dtype float64`, "
        "`--dtype float32`, then `--merge` (`swmhd_tpu_torch/validate.py`)."
        " Each case runs to its reference stop time through the stepper "
        "`swmhd_tpu_torch.cli.select_stepper` picks: path `kernel-*` is "
        "the hand-written CUDA substage, three launches a step, counted "
        "by the driver with no plain substage call. The energies are "
        "`diagnostics.reference_energy_report` every iteration "
        "(`validation/h100/series/`). Anchors, tolerances and `judge`: "
        "`swmhd_tpu_torch/validation_anchors.py`, copied from "
        "`examples/validation_anchors.py`. Beside ours: the JAX package's "
        "float64 CPU run (`validation/summary.json`) and its float32 run "
        "on a TPU (`validation/tpu_r05/results.json`).",
        "",
        "Gates: the anchors in both dtypes; in float64 also the rows and "
        "time column of `validation/series/<tag>.csv` and every energy "
        f"within {SERIES_BOUND:g} of it over the first {EARLY_ROWS} rows. "
        "max |ΔE| is the largest difference of the four energies from the "
        "JAX float64 series; after row 500 it is recorded, not gated "
        "(round-off grows in the turbulent cases). Wall s: the run loop "
        "on the card named above, host included.",
        "",
    ]
    n_pass = n_all = 0
    for dtype_name in DTYPES:
        rows = results.get(dtype_name, [])
        lines += [
            f"## {dtype_name}",
            "",
            "| formulation | scenario | path | anchors ok | me_end ours / "
            "JAX f64 / JAX TPU f32 | ke_end (same) | dev_max (same) | max "
            f"\\|ΔE\\| vs JAX f64, first {EARLY_ROWS} rows | all rows | "
            "wall s | result |",
            "|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        for (formulation, name), r in zip(CASES, rows):
            n_all += 1
            if r is None:
                lines.append(f"| {formulation} | {name} | — | — | — | — | "
                             f"— | — | — | — | **MISSING** |")
                continue
            n_pass += bool(r["pass"])
            ok = sum(bool(v) for v in r["checks"].values())
            lines.append(
                f"| {formulation} | {name} | {r['path']} | "
                f"{ok}/{len(r['checks'])} | {_triple(r, 'me_end')} | "
                f"{_triple(r, 'ke_end')} | {_triple(r, 'dev_max')} | "
                f"{_max_delta(r['vs_jax'], 'early_max')} | "
                f"{_max_delta(r['vs_jax'], 'all_max')} | "
                f"{r['wall_s']:.2f} | "
                f"**{'PASS' if r['pass'] else 'FAIL'}** |")
        ran = [r for r in rows if r is not None]
        if ran:
            wall = sum(r["wall_s"] for r in ran)
            steps = sum(r["steps"] for r in ran)
            lines += ["", f"{len(ran)} runs, {steps} steps, {wall:.2f} s of "
                          f"wall in all ({1e3 * wall / steps:.4f} ms a step)."]
        lines.append("")
    lines.append(f"**{n_pass}/{n_all} runs pass.**")
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return n_pass, n_all


def merge(outdir, report):
    """Gather the per-case records of both dtypes into
    ``results/<dtype>/results.json`` and write ``report``: True when
    every case of both dtypes ran and passed."""
    results = {}
    for dtype_name in DTYPES:
        rdir = os.path.join(outdir, "results", dtype_name)
        rows = []
        for formulation, name in CASES:
            p = os.path.join(rdir, f"{case_tag(formulation, name)}.json")
            if os.path.exists(p):
                with open(p) as f:
                    rows.append(json.load(f))
            else:
                rows.append(None)
        results[dtype_name] = rows
        present = [r for r in rows if r is not None]
        if present:
            with open(os.path.join(rdir, "results.json"), "w") as f:
                json.dump(present, f, indent=1)
    n_pass, n_all = write_report(results, report)
    print(f"wrote {report} ({n_pass}/{n_all} pass)")
    return n_pass == n_all


def selected(args):
    """The cases ``--only`` and ``--shard`` select, in CASES order."""
    k, n = (int(x) for x in (args.shard or "0/1").split("/"))
    for idx, (formulation, name) in enumerate(CASES):
        if idx % n != k:
            continue
        if args.only and args.only not in case_tag(formulation, name):
            continue
        yield formulation, name


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m swmhd_tpu_torch.validate")
    ap.add_argument("--dtype", default="float32", choices=DTYPES)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="on CUDA, step through the hand-written substage "
                         "kernel (default); --no-fused runs the plain "
                         "PyTorch step")
    ap.add_argument("--only", default=None,
                    help="run only the cases whose tag contains this")
    ap.add_argument("--shard", default=None, metavar="K/N",
                    help="run only the cases whose index is K modulo N")
    ap.add_argument("--merge", action="store_true",
                    help="run nothing: gather the results of both dtypes "
                         "and write the report")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--report", default=REPORT,
                    help="where --merge writes the report")
    ap.add_argument("--plots", action="store_true",
                    help="render plots/<dtype>/<tag>.png of each case "
                         "(needs matplotlib)")
    args = ap.parse_args(argv)

    if args.merge:
        return 0 if merge(args.outdir, args.report) else 1
    if args.plots:
        import matplotlib  # noqa: F401  (raises before the run, not after)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available "
                           "(use --device cpu for the plain CPU path)")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    dtype = getattr(torch, args.dtype)
    device_name = (torch.cuda.get_device_name() if args.device == "cuda"
                   else "cpu")
    card = card_line() if args.device == "cuda" else None
    if args.device == "cuda" and args.fused:
        # built before the first case, so that no case's wall holds the build
        from .ops import _build
        lib = _build.load()
        print(f"kernel library {lib.path}: built in {lib.build_seconds:.2f} "
              f"s", flush=True)
    jax = jax_summaries()
    rdir = os.path.join(args.outdir, "results", args.dtype)
    os.makedirs(rdir, exist_ok=True)
    n_pass = n_run = 0
    for formulation, name in selected(args):
        tag = case_tag(formulation, name)
        stop = REFERENCE[(formulation, name)]["stop"]
        print(f"== {tag} {args.dtype} (stop {stop})", flush=True)
        csv, path, wall = run_case(formulation, name, stop, dtype,
                                   args.device, args.fused, args.outdir)
        result = case_result(formulation, name, args.dtype, csv, path, wall,
                             device_name, card, jax)
        with open(os.path.join(rdir, f"{tag}.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result), flush=True)
        if args.plots:
            from .viz import render_energy_plot
            png = os.path.join(args.outdir, "plots", args.dtype, f"{tag}.png")
            os.makedirs(os.path.dirname(png), exist_ok=True)
            render_energy_plot(csv, png, title=tag)
        n_run += 1
        n_pass += result["pass"]
        print(f"   {'PASS' if result['pass'] else 'FAIL'} ({path}, "
              f"{wall:.1f} s)", flush=True)
    print(f"{n_pass}/{n_run} cases pass ({args.dtype}, {device_name})")
    return 0 if n_pass == n_run else 1


if __name__ == "__main__":
    sys.exit(main())
