"""Readback of the writers' stores, port of :mod:`swmhd_tpu.io.readers`
(numpy only): :class:`FieldTimeSeries` over a FieldWriter directory,
stitching per-process slabs, and :class:`ScalarTimeSeries` over a CSV.

Two changes from the reference: a slab still being written carries a
``.tmp`` suffix that the slab glob cannot match, and the stitch checks by
a mask that the slabs cover every point exactly once (an area sum lets a
gap and an overlap cancel).
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np


class FieldTimeSeries:
    """Snapshots of one field: ``times``, ``iterations``, ``len``, ``[i]``
    (negative indices count from the end) and :meth:`stack`."""

    def __init__(self, path: str, name: str):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self.times = np.asarray(meta["times"])
        self.iterations = np.asarray(meta["iterations"])
        self.grid_meta = meta.get("grid")
        self._dir = os.path.join(path, name)
        self._n = len(self.times)

    def __len__(self):
        return self._n

    def __getitem__(self, i: int) -> np.ndarray:
        if i < 0:
            i += self._n
        single = os.path.join(self._dir, f"{i:06d}.npy")
        slabs = sorted(glob.glob(os.path.join(self._dir, f"{i:06d}.p*.npz")))
        if os.path.exists(single):
            if slabs:
                raise RuntimeError(
                    f"snapshot {i:06d} exists both as a single .npy and as "
                    f"per-process slabs in {self._dir}: two runs wrote into "
                    f"one store")
            return np.load(single)
        if not slabs:
            raise FileNotFoundError(
                f"no snapshot {i:06d} (neither .npy nor .p*.npz) in "
                f"{self._dir}")
        out = covered = None
        for path in slabs:
            with np.load(path) as z:
                x0, x1, y0, y1 = (int(b) for b in z["bounds"])
                if out is None:
                    shape = tuple(int(s) for s in z["shape"])
                    out = np.empty(shape, dtype=z["data"].dtype)
                    covered = np.zeros(shape, dtype=bool)
                if covered[x0:x1, y0:y1].any():
                    raise RuntimeError(f"snapshot {i:06d}: slab {path} "
                                       f"overlaps another slab")
                out[x0:x1, y0:y1] = z["data"]
                covered[x0:x1, y0:y1] = True
        if not covered.all():
            raise RuntimeError(
                f"snapshot {i:06d}: slabs cover {int(covered.sum())} of "
                f"{covered.size} points (incomplete write)")
        return out

    def stack(self) -> np.ndarray:
        """``(T, Nx, Ny)`` array of all snapshots."""
        return np.stack([self[i] for i in range(self._n)])


class ScalarTimeSeries:
    """Columns of a scalar CSV as numpy arrays (attribute or item
    access)."""

    def __init__(self, path: str):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        header, data = rows[0], rows[1:]
        self.columns = {name: np.asarray([float(r[i]) for r in data])
                        for i, name in enumerate(header)}

    def __getattr__(self, name):
        try:
            return self.__dict__["columns"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name):
        return self.columns[name]
