"""Weak/strong scaling sweep over ranks, counterpart of
``benchmarks/scaling.py``.

    python -m swmhd_tpu_torch.scaling --mode weak --local 512
    python -m swmhd_tpu_torch.scaling --mode strong --global-size 2048
        [--steps 10] [--max-ranks N] [--device cuda|cpu]

For each rank count n of 1, 2, 4, 8, ... up to ``--max-ranks`` (default:
the cards, ``torch.cuda.device_count()``, as the JAX sweep takes
``len(jax.devices())``; 1 on the CPU) it times the RK3 step of
:func:`build_model` on the grid ``benchmarks/scaling.py`` gives n
(:func:`grid_for`) and prints one JSON row, then, as its last line,
``{"mode", "device_kind", "results"}``. A process group has one size, so
where the JAX sweep loops over device counts in one process, each count
here is a group of its own: ``python -m torch.distributed.run
--nproc-per-node n -m swmhd_tpu_torch.scaling --worker ...``
(:func:`run_ranks`), one rank too, so that the sweep's own process never
holds a card beside the ranks: on four cards, a sweep process that ran
the one-rank row itself read the four-rank row lower in each of two
pairs. With more ranks than cards, ranks share the cards
over gloo (:func:`~swmhd_tpu_torch.parallel.multihost.initialize`), the
counterpart of the JAX sweep's CPU fake mesh.

The route is the kernels': one rank steps through
:class:`~swmhd_tpu_torch.ops.substage.KernelStepper` (the resident
kernel where ``takes_resident``, else three ``swmhd_substage`` launches a
step), more ranks through ``DomainDecomposition(...).fused_stepper()``
(``swmhd_substage`` on halo-exchanged tiles). The JAX sweep timed XLA's
step because it predates its fused decomposed path; on the card the
plain step is a few hundred small PyTorch kernels a step and says nothing
about how the kernels' path scales. The JAX sweep's rows with
``overlap=True`` have no counterpart here: on the kernels' route a
substage is one exchange and one tile launch, as in JAX's fused step,
which takes no split.

A row: ``devices`` (ranks), ``grid``, ``points_per_s`` (the slowest
rank's ``profiling.benchmark_step``, 3 calls of ``--steps`` steps a
repetition), ``efficiency`` (against the one-rank row: per rank for weak
scaling, total / (base × n) for strong), ``launches`` (rank 0's
``swmhd_substage`` and ``swmhd_multistep`` launches over the timed calls
and their warm-up), and above one rank ``overlap_pct`` and ``comm_ms``
of rank 0's ``profiling.measure_overlap`` of one call, traced in the
worker: a process that traced before records no kernel events once
another process has used the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import torch

from . import profiling
from .forcing import jacobian_lorentz_forcing
from .grid import Grid, require_device
from .models.shallow_water import VECTOR_INVARIANT, ShallowWaterModel
from .ops import substage as K
from .parallel import multihost
from .parallel.decomposition import DomainDecomposition
from .physics.coriolis import FPlane

RANK_COUNTS = (1, 2, 4, 8, 16, 32, 64)
DT, N_CALLS = 1e-3, 3


def build_model(Nx, Ny, device="cuda"):
    """``benchmarks/scaling.py``'s ``build_model``: the vector-invariant
    model on the periodic [-5, 5]² grid of Nx × Ny float32 points with
    FPlane(1) and the jacobian Lorentz forcing; a vortex (u, v), h = 1 and
    a Gaussian A."""
    g = Grid.regular(Nx, Ny, (-5.0, 5.0), (-5.0, 5.0), dtype=torch.float32,
                     device=device)
    model = ShallowWaterModel(grid=g, formulation=VECTOR_INVARIANT,
                              coriolis=FPlane(1.0),
                              forcing=jacobian_lorentz_forcing())
    state = model.initial_state(
        u=lambda x, y: y * torch.exp(-(x**2 + y**2)),
        v=lambda x, y: -x * torch.exp(-(x**2 + y**2)),
        h=1.0, A=lambda x, y: 0.1 * torch.exp(-(x**2 + y**2)))
    return model, state


def grid_for(mode, n, local, global_size):
    """``(Nx, Ny)`` for n ranks: weak scaling gives each rank a ``local``²
    tile of the squarest ``px × n/px`` mesh, strong scaling splits one
    ``global_size``² grid."""
    if mode == "weak":
        px = math.isqrt(n)
        while n % px:
            px -= 1
        return local * px, local * (n // px)
    return global_size, global_size


def efficiency(mode, points_per_s, n, base):
    """Parallel efficiency of n ranks against ``base``, the one-rank
    row's points/s a rank."""
    return (points_per_s / n / base if mode == "weak"
            else points_per_s / (base * n))


def worker(Nx, Ny, steps, device, out):
    """One rank of a rank count (under ``torch.distributed.run``): times
    its route and, above one rank, measures the overlap; rank 0 writes
    ``{"points_per_s" (the slowest rank's), "launches" (rank 0's kernel
    launches over the timed calls and their warm-up), "overlap_pct",
    "comm_ms", "device_kind"}`` to ``out``."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n > 1:
        dev = multihost.initialize(device)
    else:
        dev = torch.device(require_device(device))
    model, state = build_model(Nx, Ny, dev)
    if n == 1:
        step, st = K.KernelStepper(model).step_fn(DT, steps), state
    else:
        dd = DomainDecomposition(model)
        step = dd.fused_stepper().step_fn(DT, steps)
        st = dd.shard_state(state)
    K.reset_counters()
    b = profiling.benchmark_step(step, st, steps, n_calls=N_CALLS,
                                 grid_points=Nx * Ny)
    launches = {"substage": K.substage.launches,
                "multistep": K.multistep.launches}
    ov = profiling.measure_overlap(step, st) if n > 1 else {}
    rates = multihost.all_gather(
        torch.tensor([b.points_per_s], dtype=torch.float64, device=dev))
    if multihost.rank() == 0:
        report = {"points_per_s": min(float(r) for r in rates),
                  "launches": launches,
                  "overlap_pct": ov.get("overlap_pct"),
                  "comm_ms": ov.get("comm_ms"),
                  "device_kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu")}
        with open(out, "w") as f:
            json.dump(report, f)
    multihost.shutdown()


def run_ranks(n, Nx, Ny, steps, device, timeout=1800):
    """The report of :func:`worker` on ``n`` ranks, one process each
    (``torch.distributed.run --standalone``), through
    ``multihost.run_checked``: the whole group is killed on a timeout, and
    a timeout or a nonzero exit raises with its output. This process
    never touches the card."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    with tempfile.TemporaryDirectory(prefix="swmhd_scaling_") as tmp:
        out = os.path.join(tmp, "report.json")
        # "--" ends the launcher's options, so none of the worker's is
        # read as an abbreviation of one of them
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}", "-m", "--", "swmhd_tpu_torch.scaling",
               "--worker", "--grid", str(Nx), str(Ny), "--steps", str(steps),
               "--device", device, "--out", out]
        multihost.run_checked(cmd, env, timeout)
        with open(out) as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m swmhd_tpu_torch.scaling",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["weak", "strong"], default="weak")
    ap.add_argument("--local", type=int, default=256,
                    help="per-rank tile size for weak scaling")
    ap.add_argument("--global-size", type=int, default=1024,
                    help="global grid for strong scaling")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--max-ranks", type=int, default=None,
                    help="most ranks (default: the cards; 1 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--grid", type=int, nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(*args.grid, args.steps, args.device, args.out)
    on_card = torch.device(require_device(args.device)).type == "cuda"
    max_ranks = args.max_ranks or (torch.cuda.device_count() if on_card
                                   else 1)
    results, base, kind = [], None, None
    for n in RANK_COUNTS:
        if n > max_ranks:
            break
        Nx, Ny = grid_for(args.mode, n, args.local, args.global_size)
        rep = run_ranks(n, Nx, Ny, args.steps, args.device)
        kind = rep["device_kind"]
        if base is None:
            base = rep["points_per_s"] / n
        row = {"devices": n, "grid": [Nx, Ny],
               "points_per_s": round(rep["points_per_s"], 1),
               "efficiency": round(efficiency(
                   args.mode, rep["points_per_s"], n, base), 3),
               "launches": rep["launches"]}
        if n > 1:
            row["overlap_pct"] = (None if rep["overlap_pct"] is None
                                  else round(rep["overlap_pct"], 1))
            row["comm_ms"] = (None if rep["comm_ms"] is None
                              else round(rep["comm_ms"], 2))
        results.append(row)
        print(json.dumps(row), flush=True)
    out = {"mode": args.mode, "device_kind": kind, "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
