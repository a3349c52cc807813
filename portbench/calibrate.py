"""Readings that the limits of ``correct`` are set from: the program's
numbers on many seeds, and the control's, the plain reference computed
one step below the configuration's dtype (``portbench.check.CONTROL``:
bfloat16 under float32, float32 under float64) put in the program's place
and judged by the harness's own comparison, on the first few. A control
that comes out correct makes the exit code 1.

    python3 portbench/calibrate.py --workload jacobian.128.series \\
        --seeds 101,102,103 --control-seeds 3 --seconds 15 \\
        --out calib.jsonl

``--witness plain,float32`` puts, on the control seeds, second witnesses
of the program's numbers in its place as well: the port's own plain step
(no kernel) from the program's state, and the reference in float32 (a
float64 configuration's control already).

One process reads every seed; each seed is one run of the cell's window
(:func:`portbench.harness.run_cell`) of ``--seconds``, long enough to
reach the chunks the cell checks. Prints one JSON line a seed and appends
it to ``--out``. The benchmark's own runs never run it.

A cell on several cards runs in as many ranks (:mod:`portbench.ranks`),
each reading every seed; rank 0 prints and appends the lines. Where the
ranks outnumber the cards they share them over gloo, as the CLI does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 3500      # every seed of a cell on several cards
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--witness", default="",
                    help="comma-separated: plain, float32")
    args = ap.parse_args(argv)

    from portbench.run import use_caches
    use_caches()
    import torch
    from portbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench/calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    ranks = None
    if cell.chips > 1:
        from portbench.ranks import Ranks, launch
        if "RANK" not in os.environ:
            rc, outs = launch([sys.executable, os.path.abspath(__file__),
                               *(sys.argv[1:] if argv is None else argv)],
                              cell.chips, setup_timeout=RANKS_TIMEOUT_S)
            sys.stdout.write(outs[0])
            return rc
        ranks = Ranks(args.device)
    device = args.device if ranks is None else ranks.device
    witnesses = [{"plain": "plain", "float32": torch.float32}[w]
                 for w in args.witness.split(",") if w]
    rc = read_seeds(cell, [int(s) for s in args.seeds.split(",")],
                    args.control_seeds, args.seconds, device, witnesses,
                    args.out, ranks)
    if ranks is not None:
        ranks.close()
    return rc


def read_seeds(cell, seeds, control_seeds, seconds, device, witnesses=(),
               out_path=None, ranks=None) -> int:
    """One run of ``cell``'s window a seed, the control of its dtype and
    ``witnesses`` judged beside the program on the first
    ``control_seeds``; prints a JSON line a seed (rank 0) and appends it
    to ``out_path``. 1 where a control came out correct, else 0."""
    from portbench import harness
    from portbench.check import CONTROL

    control = CONTROL[cell.config["dtype"]]
    key = str(control).replace("torch.", "")
    rc = 0
    for i, seed in enumerate(seeds):
        others = (tuple(dict.fromkeys((control, *witnesses)))
                  if i < control_seeds else ())
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, seconds, False,
                               time.perf_counter(), device=device,
                               others=others, ranks=ranks)
        if out.line is None:            # a rank other than 0
            continue
        judged = out.others.get(key)
        if judged is not None and judged["correct"] is not False:
            print(f"seed {seed}: the {key} control came out correct",
                  file=sys.stderr)
            rc = 1
        row = {"workload": cell.name, "seed": seed,
               "correct": out.line["correct"],
               "attempted": out.line["attempted"],
               "program": out.readings, "others": out.others,
               "metrics": out.line["metrics"],
               "memory_peak_bytes": out.line["device"]["memory_peak_bytes"],
               "kind": out.line["device"]["kind"],
               "seconds": time.perf_counter() - t0}
        line = json.dumps(row)
        print(line, flush=True)
        if out_path:
            os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                        exist_ok=True)
            with open(out_path, "a") as f:
                f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
