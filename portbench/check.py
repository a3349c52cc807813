"""The comparison that decides ``correct``.

The program's chunks are compared one by one with the plain reference
(:mod:`portbench.reference.swmhd`) in float64: a checked chunk's state,
and in a cell with the series its energy rows, against the reference's
steps from the state the chunk started from. A chunk that starts a
scenario run starts the reference from its own initial state, built from
the traffic file and the seed; any other starts it from the program's
state before the chunk (the reference cannot follow tens of thousands of
float32 steps from the start).

``state_gap``: the widest gap of a field, max|P − R|, over the most the
reference moved that field in the chunk, max|R − S| (S the chunk's start):
1 for a state left unchanged. ``energy_gap``: the widest gap of an energy
over the chunk's rows, over the larger of that energy's largest value and
the median of the five energies' largest values (the cross helicity can
be all but zero). A number that is not finite is infinite.

What takes the program's place is judged by the same code: the control,
the reference computed one step below the configuration's dtype
(:data:`CONTROL`: bfloat16 under float32, float32 under float64), and the
port's own plain step, a second witness of the program's numbers
(``portbench/calibrate.py``).

A cell decomposed over ranks is compared by every rank on its own tile
(:class:`Block`): the reference follows the chunk on the tile with a halo
wide enough that what the wrap at the block's edge spoils never reaches
the tile, which is then the reference's value there bit for bit; each
field's two maxima are taken over the ranks before the gap is formed.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Callable, Optional

import torch

from .reference import swmhd as R


FIELDS = ("h", "u", "v", "A")

# cells a substage of the reference reaches along an axis: 3 in the
# vector-invariant formulation, 4 in the conservative one
# (portbench/tests/test_portbench_blocks.py measures them)
REACH = 4

# a configuration's dtype -> its control's: the reference one step below
CONTROL = {"float32": torch.bfloat16, "float64": torch.float32}


def state_gaps(P, Rf, S, reduce=None) -> list:
    """Of stacked fields, each field's max|P − R| / max|R − S|; with
    ``reduce`` (maxima over ranks of a 1-D float64 tensor) each maximum
    is over every rank's tile."""
    nums = [float((p.double() - r.double()).abs().max())
            for p, r in zip(P, Rf)]
    dens = [float((r.double() - s.double()).abs().max())
            for r, s in zip(Rf, S)]
    if reduce is not None:
        both = reduce(torch.tensor([x if math.isfinite(x) else math.inf
                                    for x in nums + dens],
                                   dtype=torch.float64)).tolist()
        nums, dens = both[:len(nums)], both[len(nums):]
    out = []
    for num, den in zip(nums, dens):
        if not math.isfinite(num) or not math.isfinite(den):
            out.append(math.inf)
        elif num > 0:
            out.append(num / den if den > 0 else math.inf)
        else:
            out.append(0.0)
    return out


def state_gap(P, Rf, S) -> float:
    """Of stacked fields: max over fields of max|P − R| / max|R − S|."""
    return max(state_gaps(P, Rf, S))


def decide(checks: dict, failed: int) -> bool:
    """``correct``: no checked chunk over a limit, every number within."""
    return failed == 0 and all(c["value"] <= c["limit"]
                               for c in checks.values())


def energy_gap(P: dict, Rr: dict) -> float:
    """Of rows ``{name: [values]}``: max over names of max|P − R| over
    max(max|R|, the median of the names' max|R|)."""
    scale = {n: max(abs(x) for x in Rr[n]) for n in Rr}
    med = statistics.median(scale.values())
    worst = 0.0
    for n in Rr:
        if n not in P or len(P[n]) != len(Rr[n]):
            return math.inf
        num = max(abs(a - b) for a, b in zip(P[n], Rr[n]))
        if not math.isfinite(num):
            return math.inf
        den = max(scale[n], med)
        worst = max(worst, num / den if den > 0 else math.inf)
    return worst


@dataclasses.dataclass(frozen=True)
class Block:
    """A rank's tile ``[x0, x0 + nx) × [y0, y0 + ny)`` of a periodic ``n``²
    grid with ``halo`` cells around it, wrapped: what the reference
    follows for that rank. An axis on which the tile and its halo would
    cover the grid is taken whole, starting at the tile. ``reduce`` takes
    the maxima over ranks of a 1-D float64 tensor."""
    n: int
    x0: int
    nx: int
    y0: int
    ny: int
    halo: int
    reduce: Optional[Callable] = None

    def _axis(self, start, size):
        """``(offset of the tile, global indices)`` along one axis."""
        h = self.halo if size + 2 * self.halo < self.n else 0
        length = size + 2 * h if h else self.n
        return h, (start - h + torch.arange(length)) % self.n

    def cut(self, a):
        """The block of global fields ``a`` (``(..., n, n)``)."""
        (_, ix), (_, iy) = self._axis(self.x0, self.nx), self._axis(
            self.y0, self.ny)
        return a.index_select(-2, ix.to(a.device)).index_select(
            -1, iy.to(a.device))

    def crop(self, b):
        """The tile of block fields ``b``."""
        hx, hy = self._axis(self.x0, self.nx)[0], self._axis(
            self.y0, self.ny)[0]
        return b[..., hx:hx + self.nx, hy:hy + self.ny]

    @property
    def shape(self):
        return (len(self._axis(self.x0, self.nx)[1]),
                len(self._axis(self.y0, self.ny)[1]))


@dataclasses.dataclass(frozen=True)
class _BlockGrid(R.Grid):
    """The reference's grid of a block: the global grid's spacing."""
    spacing: float = 0.0

    @property
    def dx(self):
        return self.spacing

    @property
    def dy(self):
        return self.spacing


class Judge:
    """The reference of one cell and run: its model, its own initial
    state of the seeded inputs, and the limits of the cell's file. With
    ``block`` the reference follows that block of the grid, and the
    numbers are those of its tile taken with every rank's."""

    def __init__(self, cell, perturb: dict, device, block=None):
        conf, tr = cell.config, cell.traffic
        R.check_scheme(conf)
        ini = tr["initial"]
        grid = R.Grid(int(tr["N"]), float(conf["L"]), ini["topology_y"])
        self.model = R.Model(grid, conf["formulation"], float(conf["g"]),
                             float(conf["f"]), float(ini["A_bg_grad_y"]))
        self.init = R.initial_state(self.model, ini, perturb, torch.float64,
                                    device)
        self.block = block
        if block is not None:
            self.init = tuple(block.cut(f) for f in self.init)
            self.model = dataclasses.replace(self.model, grid=_BlockGrid(
                block.shape[0], grid.L, grid.topology_y, spacing=grid.dx))
        self.dt = float(tr["dt"])
        self.series = bool(tr.get("series_every"))
        self.limits = cell.check["limits"]
        self.device = device
        self.refs = {}                   # chunk -> the reference's follow

    def follow(self, start, steps, dtype=torch.float64):
        """The reference's ``steps`` steps in ``dtype`` from ``start``
        (fields h, u, v, A): the last state, and the energy rows after
        each step where the cell has the series."""
        s = tuple(f.to(self.device, dtype) for f in start)
        h0 = self.init[0].to(dtype)
        rows = {n: [] for n in R.ENERGY_NAMES}
        for _ in range(steps):
            s = R.step(self.model, s, self.dt)
            if self.series:
                e = R.energies(self.model, s, h0)
                for n in rows:
                    rows[n].append(e[n])
        host = ({n: torch.stack(v).double().cpu().tolist()
                 for n, v in rows.items()} if self.series else None)
        return torch.stack(s), host

    def readings(self, rec, other=None):
        """``[{number: value, "field": the field of the widest state
        gap}]``, one entry a checked chunk that completed: the program's
        numbers, or those of ``other(start, steps)`` put in the program's
        place (it returns the stacked state and the rows, as
        :meth:`follow` does)."""
        out = []
        for k in sorted(rec.post):
            pre, it = rec.pre[k]
            start = self.init if it == 0 else tuple(pre.unbind(0))
            steps = rec.chunks[k][2]
            if k not in self.refs:
                self.refs[k] = self.follow(start, steps)
            ref, ref_rows = self.refs[k]
            if other is None:
                got, rows = rec.post[k], rec.rows.get(k)
            else:
                got, rows = other(start, steps)
            S = torch.stack(tuple(f.to(self.device, torch.float64)
                                  for f in start))
            if self.block is None:
                gaps = state_gaps(got.to(self.device), ref, S)
            else:
                crop = self.block.crop
                gaps = state_gaps(crop(got.to(self.device)), crop(ref),
                                  crop(S), self.block.reduce)
            nums = {"chunk": k, "state_gap": max(gaps),
                    "field": FIELDS[gaps.index(max(gaps))]}
            if self.series:
                nums["energy_gap"] = (energy_gap(rows, ref_rows)
                                      if rows is not None else math.inf)
            out.append(nums)
            del got
        return out

    def control(self, dtype):
        """The reference computed in ``dtype``, to put in the program's
        place."""
        return lambda start, steps: self.follow(start, steps, dtype)

    def compare(self, rec, other=None):
        """``(checks, failed, per_chunk)`` of the program, or of ``other``
        in its place: each number's worst value over the checked chunks
        beside its limit, how many checked chunks exceed a limit (a run
        that completed no checked chunk fails), and :meth:`readings`."""
        per_chunk = self.readings(rec, other)
        names = ["state_gap"] + (["energy_gap"] if self.series else [])
        checks = {n: {"value": max((c[n] for c in per_chunk),
                                   default=math.inf),
                      "limit": float(self.limits[n])} for n in names}
        failed = sum(any(not c[n] <= self.limits[n] for n in names)
                     for c in per_chunk)
        return checks, (failed if per_chunk else 1), per_chunk
