"""One rank of a tiny decomposed cell on the CPU, for the tests of
``test_portbench_ranks.py``: started by ``portbench.ranks.launch`` (under
``torchrun``) with
``--root`` (a directory with a BENCHMARK.json of the cell and its
configurations) and ``--out`` (where each rank writes what the tests
read: its line on rank 0, its tile's snapshots and bounds, the steps it
took). ``--case`` plants what a test needs:

- ``plain``: nothing; the control (the reference in bfloat16) is judged
  in the program's place beside it;
- ``stale``: rank 1 pads its tile with the halo of its first exchange
  every substage after (the exchange still runs, so every collective
  matches);
- ``local``: no exchange: every rank pads its tile from itself, wrapped;
- ``altered``: rank 2 adds 1 to one value of h in its tile after each
  chunk;
- ``early``: rank 2's own clock would close the window at its first
  chunk;
- ``killed``: rank 3 kills itself at its fourth chunk.
"""

import argparse
import os
import signal
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Counted:
    """The stepper, counting the steps this rank took; ``die_at``: the
    chunk at which the process kills itself."""

    def __init__(self, inner, die_at=None, alter=False):
        self.inner, self.die_at, self.alter = inner, die_at, alter
        self.tile_diagnostics = inner.tile_diagnostics
        self.steps = self.calls = 0

    def step_fn(self, dt, n_steps=1, diagnostics=None):
        fn = self.inner.step_fn(dt, n_steps, diagnostics=diagnostics)

        def counted(state):
            self.calls += 1
            if self.calls == self.die_at:
                os.kill(os.getpid(), signal.SIGKILL)
            self.steps += n_steps
            out = fn(state)
            if self.alter:
                h = out.h.clone()
                h[3, 5] += 1.0
                out = out.replace(h=h)
            return out
        return counted


def stale_halo(dd):
    """``dd.pad`` keeping the ring of its first result for each width."""
    real, first = dd.pad, {}

    def pad(s, H=None):
        H = dd.halo if H is None else H
        p = real(s, H)
        if H not in first:
            first[H] = p.clone()
            return p
        q = first[H].clone()
        q[:, H:H + dd.nx, H:H + dd.ny] = s
        return q
    dd.pad = pad
    return dd


def local_halo(dd):
    """``dd.pad`` from the tile alone, wrapped: the exchange left out."""
    def pad(s, H=None):
        H = dd.halo if H is None else H
        s = torch.cat([s[:, -H:], s, s[:, :H]], 1)
        return torch.cat([s[:, :, -H:], s, s[:, :, :H]], 2)
    dd.pad = pad
    return dd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--workload", default="tiny.decomposed")
    ap.add_argument("--case", default="plain",
                    choices=("plain", "stale", "local", "altered", "early",
                             "killed"))
    ap.add_argument("--seed", type=int, default=2 ** 31 + 5)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()

    from portbench import harness
    from portbench.ranks import Ranks, write_pid
    write_pid(args.out, int(os.environ["RANK"]))
    torch.set_num_threads(1)
    cell = harness.find_cell(args.workload, root=args.root,
                             pkg=os.path.join(HERE, "data"))
    ranks = Ranks("cpu")
    r = ranks.rank
    counted = {}

    def hook(stepper, model):
        if args.case == "stale" and r == 1:
            stepper = stale_halo(stepper)
        if args.case == "local":
            stepper = local_halo(stepper)
        counted["s"] = Counted(
            stepper, die_at=4 if args.case == "killed" and r == 3 else None,
            alter=args.case == "altered" and r == 2)
        return counted["s"]
    seconds = 0.0 if args.case == "early" and r == 2 else args.seconds
    out = harness.run_cell(cell, args.seed, seconds, False,
                           time.perf_counter(), device=ranks.device,
                           stepper_hook=hook, ranks=ranks,
                           work_dir=os.path.join(args.out, f"work{r}"),
                           keep_snapshots=True,
                           others=(torch.bfloat16,) if args.case == "plain"
                           else ())
    torch.save({"line": out.line, "steps": counted["s"].steps,
                "bounds": ranks.bounds[r], "snapshots": out.snapshots,
                "readings": out.readings, "others": out.others},
               os.path.join(args.out, f"rank{r}.pt"))
    ranks.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
