"""Headline benchmark of the port, counterpart of the repo's ``bench.py``:
grid points per second of the SWMHD RK3 step on one card.

    python -m swmhd_tpu_torch.bench [--device cuda|cpu]

Prints one line per size measured (``size {...}``: the size, the path,
the steps a call, the launches the kernel wrappers counted over the timed
calls and their warm-up, ``rel_spread``, whether the state is finite after
the calls, points/s), then, as its last line, one JSON object with
``bench.py``'s keys: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``fraction_of_roofline``, ``binding_limit``, ``hbm_fraction_of_light``,
``vpu_fraction_of_peak``, ``hbm_gbps_at_min_traffic``,
``flops_per_point_measured``, ``flops_per_point_analytic``,
``rel_spread``, ``ladder``, and one key of its own, ``nonfinite``: the
sizes (the headline's and the ladder's) whose state was not finite after
the timed calls, whose rates are not the kernels' speed on this scheme.
``bench.py``'s ``vs_reference_cpu_estimate`` is left out: it divided by
an estimated CPU rate that the reference never published.

The baseline is the card's roofline: the device-memory limit
(:data:`BYTES_PER_POINT` against ``profiling.HBM_PEAK_GBPS``) and the
float32 limit outside the tensor cores (operations a point against
``profiling.VPU_PEAK_GFLOPS``); the binding one is the smaller rate, and
``vs_baseline`` is achieved / (:data:`TARGET_FRACTION` × binding
roofline). Where the card is not in those tables, or on the CPU, there is
no roofline and ``vs_baseline`` is null.

The operations a point are the smaller of :data:`ANALYTIC_FLOPS_PER_POINT`
and :func:`measure_flops_per_point`, a count of the float32 elementwise
PyTorch operations of one plain RK3 step (``profiling.count_ops``; not
XLA's flops, which the JAX bench counted), so a change of the
discretisation moves the denominator.

Each size runs the route ``cli`` runs (:class:`~.ops.substage.KernelStepper`):
``resident-cuda``, one ``swmhd_multistep`` launch a call, where
``ops.substage.takes_resident`` (the state's 16 words a point fit the
card's L2), else ``substage-cuda``, three ``swmhd_substage`` launches a
step; ``SWMHD_BENCH_FUSED=0`` times the plain PyTorch step on the card
(``plain``). Every size steps with dt = 0.001, as ``bench.py`` does.

Environment knobs (``bench.py``'s):
  SWMHD_BENCH_N      grid size (default 2048)
  SWMHD_BENCH_FUSED  "0": the plain step; "1" (default on the card): the
                     CUDA kernels. On the CPU only the plain step runs,
                     with the same steps a call: hours.
  SWMHD_BENCH_LADDER comma-separated extra sizes reported in "ladder"
                     (default "128,512,4096,8192" where the card has a
                     roofline, else none; "" for none)
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from . import profiling
from .forcing import jacobian_lorentz_forcing
from .grid import Grid, require_device
from .models.shallow_water import VECTOR_INVARIANT, ShallowWaterModel
from .ops import substage as K
from .physics.coriolis import FPlane

TARGET_FRACTION = 0.80  # of the binding roofline

# Least device-memory traffic of one RK3 step in float32: 3 substages x
# (read + write the 4 prognostic fields) x 4 B.
BYTES_PER_POINT = float(profiling.MIN_FIELD_TRANSFERS_PER_STEP
                        * torch.float32.itemsize)

# Hand-derived least float32 operations a point of one RK3 step of this
# scheme (WENO5-Z vector-invariant + jacobian Lorentz; the derivation
# table is PERFORMANCE.md's "Analytic flop floor"). The roofline's
# denominator is min(measured, analytic), the more demanding of the two.
ANALYTIC_FLOPS_PER_POINT = 3274.0

DT = 0.001


def build(N=2048, dtype=torch.float32, device="cuda"):
    """``bench.build(N)``: the vector-invariant model on the periodic
    [-5, 5]² grid of N² points with g = 9.81, FPlane(1) and the jacobian
    Lorentz forcing; a vortex (u, v), h = 1 and a Gaussian dipole A."""
    grid = Grid.regular(N, N, (-5.0, 5.0), (-5.0, 5.0), dtype=dtype,
                        device=device)
    model = ShallowWaterModel(
        grid=grid, formulation=VECTOR_INVARIANT,
        gravitational_acceleration=9.81, coriolis=FPlane(1.0),
        forcing=jacobian_lorentz_forcing())
    state = model.initial_state(
        u=lambda x, y: 5 * y * torch.exp(-(x**2 + y**2)),
        v=lambda x, y: -5 * x * torch.exp(-(x**2 + y**2)),
        h=1.0,
        A=lambda x, y: 0.5 * torch.exp(-((x - 0.5)**2 + y**2))
        - 0.5 * torch.exp(-((x + 0.5)**2 + y**2)))
    return model, state


def measure_flops_per_point(probe_N=512):
    """Float32 elementwise operations a point of ONE plain RK3 step,
    counted on the CPU at ``probe_N``² (``profiling.count_ops``; a
    periodic grid, so the count a point does not depend on the size).
    None if counting fails."""
    try:
        model, state = build(probe_N, torch.float32, "cpu")
        step = model.step_fn(DT, 1)
        return profiling.count_ops(lambda: step(state)) / (probe_N * probe_N)
    except (ImportError, AttributeError, RuntimeError):
        return None


def steps_per_call(N, n_calls=5):
    """Steps a call at N²: about 2e9 point-steps a repetition of
    ``n_calls`` calls, so that the one synchronisation a repetition, and
    the host's work around each call, weigh nothing in its time; at
    least 10."""
    return max(10, int(2e9 / (N * N * n_calls)))


def route(model, s):
    """The path :class:`~.ops.substage.KernelStepper` takes on the stacked
    fields ``s``: ``"resident-cuda"`` where ``takes_resident``, else
    ``"substage-cuda"``."""
    return "resident-cuda" if K.takes_resident(model, s) else "substage-cuda"


def bench_one(N, use_fused, steps_per_call=None, n_calls=5, device="cuda"):
    """``(StepBenchmark, path, size line)`` of the bench model at N²
    float32 through :func:`route`'s kernels (``use_fused``) or the plain
    step: ``profiling.benchmark_step``, one warm-up call, then the fastest
    of two repetitions of ``n_calls`` calls of ``steps_per_call`` steps
    (default: the rule :func:`steps_per_call`). The size line holds what
    the kernel wrappers counted from the warm-up to the last call and
    whether the state after the last call is finite."""
    if torch.device(device).type != "cuda" and use_fused:
        raise ValueError("the CUDA kernels run on the card: "
                         "SWMHD_BENCH_FUSED=1 needs --device cuda")
    if steps_per_call is None:
        # the parameter shadows the module's rule of the same name
        steps_per_call = globals()["steps_per_call"](N, n_calls)
    model, state = build(N, torch.float32, device)
    if use_fused:
        path = route(model, state.h)
        fn = K.KernelStepper(model).step_fn(DT, steps_per_call)
    else:
        path = "plain"
        fn = model.step_fn(DT, steps_per_call)
    last = []

    def step(st):
        last[:] = [fn(st)]
        return last[0]
    K.reset_counters()
    b = profiling.benchmark_step(step, state, steps_per_call,
                                 n_calls=n_calls)
    size = {"N": N, "path": path, "steps_per_call": steps_per_call,
            "launches": {"substage": K.substage.launches,
                         "multistep": K.multistep.launches,
                         "multistep_substages": K.multistep.substages},
            "rel_spread": b.rel_spread,
            "finite": all(bool(torch.isfinite(f).all())
                          for f in last[0].fields()),
            "points_per_s": b.points_per_s}
    print("size " + json.dumps(size), flush=True)
    return b, path, size


def headline(N, path, kind, bench, flops_measured, hbm_peak, vpu_peak):
    """``bench.py``'s JSON object (without ``ladder``) for the benchmark
    ``bench`` of N² through ``path`` on the card ``kind``, with the card's
    peaks in GB/s and GFLOP/s (None: no roofline)."""
    # the more demanding (smaller) denominator governs the roofline
    flops_pt = (min(flops_measured, ANALYTIC_FLOPS_PER_POINT)
                if flops_measured is not None else ANALYTIC_FLOPS_PER_POINT)
    have_roofline = hbm_peak is not None and vpu_peak is not None
    what = (f"grid-points/s/card (SWMHD RK3 step, {N}^2 f32, WENO5-Z "
            f"vector-invariant + jacobian Lorentz, {path} path on {kind}; ")
    if have_roofline:
        hbm_limit = hbm_peak * 1e9 / BYTES_PER_POINT       # pts/s
        vpu_limit = vpu_peak * 1e9 / flops_pt              # pts/s
        binding = ("fp32 compute" if vpu_limit < hbm_limit
                   else "HBM bandwidth")
        roofline = min(hbm_limit, vpu_limit)
        metric = what + (
            f"vs_baseline = achieved / (0.80 x binding roofline = {binding} "
            f"limit at min(measured, analytic) = {flops_pt:.0f} op/pt, AI "
            f"{flops_pt / BYTES_PER_POINT:.1f} op/B; measured = float32 "
            f"elementwise PyTorch operations of the plain step, not XLA "
            f"flops))")
    else:
        metric = what + "no roofline known for this device: vs_baseline is null)"
    pps = bench.points_per_s
    out = {"metric": metric, "value": round(pps, 1), "unit": "points/s"}
    if have_roofline:
        out["vs_baseline"] = round(pps / (TARGET_FRACTION * roofline), 4)
        out["fraction_of_roofline"] = round(pps / roofline, 4)
        out["binding_limit"] = binding
        out["hbm_fraction_of_light"] = round(pps / hbm_limit, 4)
        out["vpu_fraction_of_peak"] = round(pps / vpu_limit, 4)
        out["hbm_gbps_at_min_traffic"] = round(pps * BYTES_PER_POINT / 1e9, 1)
        if flops_measured is not None:
            out["flops_per_point_measured"] = round(flops_measured, 1)
        out["flops_per_point_analytic"] = ANALYTIC_FLOPS_PER_POINT
    else:
        out["vs_baseline"] = None
    if bench.rel_spread is not None:
        out["rel_spread"] = round(bench.rel_spread, 4)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m swmhd_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu, the plain step only")
    device = require_device(ap.parse_args(argv).device)
    on_card = torch.device(device).type == "cuda"
    N = int(os.environ.get("SWMHD_BENCH_N", "2048"))
    use_fused = os.environ.get("SWMHD_BENCH_FUSED",
                               "1" if on_card else "0") == "1"

    bench, path, size = bench_one(N, use_fused, device=device)
    nonfinite = [] if size["finite"] else [N]
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    out = headline(N, path, kind, bench, measure_flops_per_point(),
                   profiling.detect_hbm_peak(device),
                   profiling.detect_vpu_peak(device))

    # bench.py's ladder beside the 2048² headline, each size through the
    # route takes_resident gives it
    default_ladder = ("128,512,4096,8192" if out["vs_baseline"] is not None
                      else "")
    ladder = os.environ.get("SWMHD_BENCH_LADDER", default_ladder)
    if ladder:
        out["ladder"] = {}
        for sz in ladder.split(","):
            b2, _, size = bench_one(int(sz), use_fused, device=device)
            out["ladder"][str(int(sz))] = round(b2.points_per_s, 1)
            if not size["finite"]:
                nonfinite.append(int(sz))
    # beyond bench.py's keys: the sizes whose state ended inf/NaN, so that
    # no rate timed on such a state reads as the kernels' speed
    out["nonfinite"] = nonfinite
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
