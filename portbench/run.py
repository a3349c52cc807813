"""Run one cell of the port's benchmark once, on the card this process
finds:

    python3 portbench/run.py --workload jacobian.2048.periodic \
        --seed 12345 --seconds 30 --trace 0

Builds the cell's ``Simulation`` as ``swmhd_tpu_torch.cli run`` does,
warms it up, runs scenario after scenario from the seeded initial state
for ``--seconds``, compares the checked chunks with the plain reference,
and prints the numbers compared beside their limits on standard error
and, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (chunks completed in the window), ``failed`` (checked
chunks over a limit), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. Exits 2 without printing a result
where no CUDA card is found.

A cell on several cards (``chips`` > 1) runs as ``torchrun`` runs the
CLI's decomposed run, one process a card (:mod:`portbench.ranks`); this
process starts and watches them and prints rank 0's line.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age() -> float:
    """Seconds since this process started (``/proc``; 0 where it is
    unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def use_caches():
    """Fixed cache directories inside the checkout, set before torch is
    imported: the card runtime's kernels, Triton's, and Python's
    bytecode. An installation that ships no compiled bytecode, under
    ``PYTHONDONTWRITEBYTECODE``, would otherwise have every process compile
    torch's Python sources anew, seconds of set-up that swing from run to
    run; with the cache only a checkout's first run compiles them."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.pycache_prefix = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False


def finite(x):
    """JSON has no infinity: an infinite gap prints as 1e300."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def emit(line: dict):
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() - process_age()
    use_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import ranks
    chips = ranks.cell_chips(args.workload)
    if chips > 1:
        return ranks.run_parent(args, chips, t_start)

    import torch
    print(f"torch_imported_s {time.perf_counter() - t_start!r}",
          file=sys.stderr, flush=True)
    from portbench import harness

    cell = harness.find_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start)
    emit(out.line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
