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

What takes the program's place is judged by the same code: the control
(the reference in a lower precision) and the port's own plain step, a
second witness of the program's numbers (``portbench/calibrate.py``).
"""

from __future__ import annotations

import math
import statistics

import torch

from .reference import swmhd as R


FIELDS = ("h", "u", "v", "A")


def state_gaps(P, Rf, S) -> list:
    """Of stacked fields, each field's max|P − R| / max|R − S|."""
    out = []
    for p, r, s in zip(P, Rf, S):
        num = float((p.double() - r.double()).abs().max())
        den = float((r.double() - s.double()).abs().max())
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


class Judge:
    """The reference of one cell and run: its model, its own initial
    state of the seeded inputs, and the limits of the cell's file."""

    def __init__(self, cell, perturb: dict, device):
        conf, tr = cell.config, cell.traffic
        R.check_scheme(conf)
        ini = tr["initial"]
        grid = R.Grid(int(tr["N"]), float(conf["L"]), ini["topology_y"])
        self.model = R.Model(grid, conf["formulation"], float(conf["g"]),
                             float(conf["f"]), float(ini["A_bg_grad_y"]))
        self.init = R.initial_state(self.model, ini, perturb, torch.float64,
                                    device)
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
            gaps = state_gaps(got.to(self.device), ref, S)
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
