"""A cell decomposed over several cards, run as the CLI's documented
deployment runs (``torchrun --nproc-per-node 4 -m swmhd_tpu_torch.cli
run ...``): one process a card, each holding one tile of the grid.

The parent (``portbench/run.py`` for a cell whose ``chips`` > 1) starts
``python -m torch.distributed.run --standalone`` with this file as the
script, in a session of its own, and prints rank 0's line, which rank 0
writes to a file of the run's directory (in ``TMPDIR``). It imports no
torch. ``torchrun`` gives the ranks their environment and a rendezvous
port the system picks, and ends every rank when one fails; the parent
exits with its code and prints nothing then. A run past its deadline
(until rank 0 opens the window, a checkout's first run building the
kernels; from there for the window, the traced chunks and the
comparison) is ended: ``torchrun`` is told to stop its ranks, then
killed, and so is any rank left.

Each rank (:func:`rank_main`) holds itself to its own share of the cores
(:func:`pin_cores`), joins the process group as the CLI does
(``parallel.multihost.initialize``: NCCL, a card each), and runs
:func:`portbench.harness.run_cell` with a :class:`Ranks`: the program
built as ``cli.cmd_run`` builds it under ``torchrun``, rank 0's clock
deciding for all, and the comparison made by every rank on its own
tile. The harness's own collectives go over a gloo group of their own
with a timeout.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETUP_TIMEOUT_S = 1100      # the start to the window's open
AFTER_OPEN_S = 270          # the window's open to the ranks' end, beside
                            # the window's seconds
STOP_GRACE_S = 20           # torchrun's time to stop its ranks when told
COLLECTIVE_TIMEOUT_S = 120  # one collective of the harness's gloo group
SETTLE_TIMEOUT_S = 1000     # the barrier before the window: the slowest
                            # rank's set-up, a build included
WINDOW_MARK = "window"      # the file rank 0 writes when the window opens
LINE_FILE = "line.json"     # the file rank 0 writes its line to


def cell_chips(name: str, root: str = ROOT) -> int:
    """The ``chips`` of cell ``name`` in ``<root>/BENCHMARK.json``; 1
    where there is no such cell (the caller reports it)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        if w["name"] == name:
            return int(w["chips"])
    return 1


def _kill(pid: int, sig=signal.SIGKILL):
    try:
        os.kill(pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def launch(script_argv, world: int, run_dir: str, *, env=None, cwd=None,
           setup_timeout=SETUP_TIMEOUT_S, after_open=None) -> int:
    """Run ``script_argv`` (a Python script and its arguments) as ``world``
    ranks under ``torchrun --standalone`` and wait: its exit code, or 124
    past the deadline, ``setup_timeout`` seconds from the start and, once
    ``<run_dir>/window`` exists, ``after_open`` seconds from then. The
    ranks write ``<run_dir>/pid.<rank>``; whatever ends the run, a signal
    to this process too, every rank left is killed and waited for.
    Everything the ranks and ``torchrun`` print goes to standard error."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(world), "--max-restarts", "0",
           "--monitor-interval", "0.5", "--log-dir",
           os.path.join(run_dir, "torchelastic"), *script_argv]
    mark = os.path.join(run_dir, WINDOW_MARK)

    def stop(signum, frame):
        raise SystemExit(128 + signum)
    old = {s: signal.signal(s, stop) for s in (signal.SIGTERM, signal.SIGINT)}
    agent = subprocess.Popen(cmd, cwd=cwd, env=dict(os.environ, **(env or {})),
                             stdout=sys.stderr, start_new_session=True)
    rc = 124
    try:
        deadline, opened = time.monotonic() + setup_timeout, False
        while time.monotonic() < deadline:
            if agent.poll() is not None:
                rc = agent.returncode
                break
            if not opened and after_open and os.path.exists(mark):
                opened, deadline = True, time.monotonic() + after_open
            time.sleep(0.1)
        else:
            print(f"portbench: the ranks did not end within their deadline "
                  f"({'after the window opened' if opened else 'in set-up'})",
                  file=sys.stderr, flush=True)
    finally:
        if agent.poll() is None:
            _kill(agent.pid, signal.SIGTERM)
            try:
                agent.wait(STOP_GRACE_S)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(agent.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        agent.wait()
        for name in os.listdir(run_dir):
            if name.startswith("pid."):
                with open(os.path.join(run_dir, name)) as f:
                    pid = int(f.read() or 0)
                for _ in range(100):
                    if not pid or _zombie(pid):
                        break
                    _kill(pid)
                    time.sleep(0.01)
        for s, h in old.items():
            signal.signal(s, h)
    return rc


def _zombie(pid: int) -> bool:
    """Whether ``pid`` has ended: gone, or waiting only for its parent to
    reap it."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return True


def run_parent(args, chips: int, t_start: float) -> int:
    """``run.py`` for a cell on ``chips`` cards: the ranks, then rank 0's
    line as the last line of standard output."""
    from portbench import forbidden_modules, run
    run_dir = tempfile.mkdtemp(prefix="portbench-ranks-")
    try:
        rc = launch([os.path.abspath(__file__), "--workload", args.workload,
                     "--seed", str(args.seed), "--seconds", repr(args.seconds),
                     "--trace", str(args.trace), "--t-start", repr(t_start),
                     "--run-dir", run_dir], chips, run_dir,
                    after_open=args.seconds + AFTER_OPEN_S)
        if rc != 0:
            print(f"portbench: the ranks of {args.workload} exited {rc}",
                  file=sys.stderr)
            return rc
        bad = forbidden_modules()
        if bad:
            print(f"portbench: modules that must not load were loaded: "
                  f"{', '.join(bad)}", file=sys.stderr)
            return 1
        try:
            with open(os.path.join(run_dir, LINE_FILE)) as f:
                line = json.load(f)
        except (OSError, ValueError):
            print("portbench: rank 0 wrote no result", file=sys.stderr)
            return 1
        run.emit(line)
        return 0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _cpu_list(text: str) -> list:
    """``"0-3,8"`` -> ``[0, 1, 2, 3, 8]``."""
    out = []
    for part in text.strip().split(","):
        if part:
            a, _, b = part.partition("-")
            out.extend(range(int(a), int(b or a) + 1))
    return out


def _cards_cores(world: int):
    """For each of the first ``world`` cards in the CUDA runtime's order
    (the bus order, for cards of one kind), the cores the system names
    as near it; None where it names none or the visible cards are
    narrowed."""
    if os.environ.get("CUDA_VISIBLE_DEVICES") is not None:
        return None
    try:
        buses = sorted(os.listdir("/proc/driver/nvidia/gpus"))[:world]
        lists = []
        for bus in buses:
            with open(f"/sys/bus/pci/devices/{bus.lower()}/local_cpulist") as f:
                lists.append(tuple(_cpu_list(f.read())))
    except (OSError, ValueError):
        return None
    return lists if len(lists) == world else None


def pin_cores(rank: int, world: int) -> list:
    """Hold this process, and every thread it starts from now on, to a
    share of the cores it may run on that no other rank gets: of the
    cores near its card, split among the ranks whose cards share them;
    else of all. Called before torch loads. Returns the cores."""
    allowed = sorted(os.sched_getaffinity(0))
    near = _cards_cores(world)
    pool, mates = allowed, list(range(world))
    if near is not None:
        mine = [c for c in near[rank] if c in allowed]
        mates = [r for r in range(world) if near[r] == near[rank]]
        if len(mine) >= len(mates):
            pool = mine
        else:
            mates = list(range(world))
    i, n = mates.index(rank), len(mates)
    share = pool[i * len(pool) // n:(i + 1) * len(pool) // n] or pool
    os.sched_setaffinity(0, share)
    return share


class Ranks:
    """This process's place among the ranks of a decomposed run, and the
    harness's collectives over them (a gloo group of its own, each
    collective with :data:`COLLECTIVE_TIMEOUT_S`).

    ``device`` is ``"cuda"`` or ``"cpu"``; joining is
    ``parallel.multihost.initialize``, the CLI's. ``run_dir``: where rank
    0 marks the window open for :func:`launch`'s deadline."""

    def __init__(self, device: str = "cuda", run_dir=None):
        import torch.distributed as dist
        from swmhd_tpu_torch.parallel import multihost
        self.dist, self.run_dir = dist, run_dir
        self.device = multihost.initialize(device)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.ctl = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=COLLECTIVE_TIMEOUT_S))
        self.bounds = None      # each rank's tile (x0, x1, y0, y1)
        self.block = None       # this rank's block (check.Block)

    # -- the program, as cli.cmd_run builds it under torchrun ---------------------

    def decompose(self, cell, model, state, halo: int):
        """``(dd, tile)``: ``cli._decomposition(model)`` (the squarest mesh,
        ``overlap`` off) and this rank's tile of the global ``state``;
        sets the blocks the comparison follows, ``halo`` cells around
        each tile. The configuration's ``ranks`` and ``mesh`` must be the
        run's."""
        from swmhd_tpu_torch import cli

        from portbench.check import Block
        conf = cell.config
        if int(conf.get("ranks", 1)) != self.world:
            raise ValueError(f"{cell.name}: the configuration states "
                             f"{conf.get('ranks', 1)} ranks, the run has "
                             f"{self.world}")
        dd = cli._decomposition(model)
        if list(conf.get("mesh", (dd.px, dd.py))) != [dd.px, dd.py]:
            raise ValueError(f"{cell.name}: the configuration states the "
                             f"mesh {conf['mesh']}, the CLI builds "
                             f"{dd.px}x{dd.py}")
        if list(conf.get("tile", (dd.nx, dd.ny))) != [dd.nx, dd.ny]:
            raise ValueError(f"{cell.name}: the configuration states "
                             f"{conf['tile']} tiles, the run has "
                             f"{dd.nx}x{dd.ny}")
        if cell.traffic.get("series_every"):
            raise ValueError("the benchmark compares no series of a "
                             "decomposed run")
        if model.grid.topology_y != "periodic":
            raise ValueError("the comparison's blocks wrap: a decomposed "
                             "cell is periodic in y")
        self.bounds = self.gather(tuple(dd.bounds))
        x0, x1, y0, y1 = dd.bounds
        self.block = Block(n=model.grid.Nx, x0=x0, nx=x1 - x0, y0=y0,
                           ny=y1 - y0, halo=halo, reduce=self.reduce_max)
        return dd, dd.shard_state(state)

    # -- agreement ----------------------------------------------------------------

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank (one broadcast)."""
        import torch
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        self.dist.broadcast(t, src=0, group=self.ctl)
        return bool(t.item())

    def settle(self):
        """The barrier before the window; then rank 0 marks the window
        open for the parent's deadline."""
        self.dist.monitored_barrier(
            group=self.ctl,
            timeout=datetime.timedelta(seconds=SETTLE_TIMEOUT_S))
        if self.rank == 0 and self.run_dir:
            with open(os.path.join(self.run_dir, WINDOW_MARK), "w"):
                pass

    def gather(self, obj) -> list:
        """``[obj of rank 0, obj of rank 1, ...]`` on every rank."""
        out = [None] * self.world
        self.dist.all_gather_object(out, obj, group=self.ctl)
        return out

    def reduce_max(self, values):
        """The maxima over ranks of a 1-D float64 CPU tensor."""
        t = values.clone()
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX, group=self.ctl)
        return t

    def snapshot(self, state):
        """This rank's block of the global state, stacked: every rank's
        tile gathered (the process group's own collective, a collective
        of all ranks) and placed by its bounds."""
        import torch
        tile = torch.stack(state.fields()).contiguous()
        parts = [torch.empty_like(tile) for _ in range(self.world)]
        self.dist.all_gather(parts, tile)
        n = self.block.n
        whole = tile.new_empty((tile.shape[0], n, n))
        for (x0, x1, y0, y1), p in zip(self.bounds, parts):
            whole[:, x0:x1, y0:y1] = p
        del parts
        return self.block.cut(whole)

    def close(self):
        """Leave the process group once every rank is done."""
        self.dist.monitored_barrier(
            group=self.ctl,
            timeout=datetime.timedelta(seconds=SETTLE_TIMEOUT_S))
        self.dist.destroy_process_group()


def write_pid(run_dir: str, rank: int):
    """``<run_dir>/pid.<rank>``, for :func:`launch` to end what is left."""
    path = os.path.join(run_dir, f"pid.{rank}")
    with open(path + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.replace(path + ".tmp", path)


def rank_main(argv=None) -> int:
    """One rank of ``run.py``'s decomposed cell: rank 0 writes the line to
    ``<run-dir>/line.json``."""
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/ranks.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--run-dir", required=True)
    args = ap.parse_args(argv)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    write_pid(args.run_dir, rank)
    cores = pin_cores(int(os.environ.get("LOCAL_RANK", rank)), world)
    print(f"rank {rank} cores {cores[0]}-{cores[-1]} ({len(cores)})",
          file=sys.stderr, flush=True)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.run import finite, use_caches
    use_caches()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"portbench: {args.workload} needs {world} CUDA cards; found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from portbench import harness
    cell = harness.find_cell(args.workload)
    ranks = Ranks("cuda", args.run_dir)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           args.t_start, device=ranks.device, ranks=ranks)
    if ranks.rank == 0:
        path = os.path.join(args.run_dir, LINE_FILE)
        with open(path + ".tmp", "w") as f:
            json.dump(finite(out.line), f)
        os.replace(path + ".tmp", path)
    ranks.close()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
