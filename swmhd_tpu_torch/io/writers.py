"""Output writers, port of the single-process :mod:`swmhd_tpu.io.writers`,
with the same files and columns so the JAX package's readers open them.

:class:`FieldWriter` writes ``<path>/<name>/<index:06d>.npy`` plus
``<path>/meta.json``; :class:`ScalarSeriesWriter` writes a CSV of
``time, iteration, <names...>`` rows.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
from typing import Callable, Mapping

import numpy as np


class FieldWriter:
    """Named 2-D fields on a schedule; ``outputs`` maps name ->
    callable(simulation) -> tensor."""

    def __init__(self, outputs: Mapping[str, Callable], schedule, path: str,
                 overwrite_existing: bool = True):
        self.outputs = dict(outputs)
        self.schedule = schedule
        self.path = path
        self._times = []
        self._iters = []
        self._idx = 0
        if overwrite_existing and os.path.isdir(path):
            shutil.rmtree(path)
        for name in self.outputs:
            os.makedirs(os.path.join(path, name), exist_ok=True)
        self._grid_meta = None

    def write(self, sim):
        st = sim.state
        self._times.append(float(st.clock.time))
        self._iters.append(int(st.clock.iteration))
        for name, fn in self.outputs.items():
            np.save(os.path.join(self.path, name, f"{self._idx:06d}.npy"),
                    fn(sim).detach().cpu().numpy())
        if self._grid_meta is None:
            g = sim.model.grid
            self._grid_meta = {
                "Nx": g.Nx, "Ny": g.Ny, "Lx": g.Lx, "Ly": g.Ly,
                "x0": g.x0, "y0": g.y0,
                "topology": [g.topology_x, g.topology_y],
            }
        self._idx += 1
        self._flush_meta()

    def _flush_meta(self):
        meta = {"times": self._times, "iterations": self._iters,
                "fields": sorted(self.outputs), "grid": self._grid_meta,
                "n_processes": 1}
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def close(self):
        self._flush_meta()


class ScalarSeriesWriter:
    """Scalar series → CSV. ``fn(model, state) -> {name: 0-d tensor}`` is
    evaluated after every step inside the simulation's chunk; rows whose
    iteration is on ``schedule`` (an IterationInterval) are written."""

    def __init__(self, fn: Callable, schedule, path: str,
                 overwrite_existing: bool = True):
        self.fn = fn
        self.schedule = schedule
        self.path = path
        self._every = int(getattr(schedule, "n", 1))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._overwrite = overwrite_existing
        self._f = None
        self._csv = None
        self._names = None

    def _open(self, names):
        mode = "w" if self._overwrite or not os.path.exists(self.path) \
            else "a"
        self._f = open(self.path, mode, newline="")
        self._csv = csv.writer(self._f)
        self._names = sorted(names)
        if mode == "w":
            self._csv.writerow(["time", "iteration"] + self._names)

    def write_series(self, times, iterations, series: Mapping):
        """Append the rows on this writer's cadence; ``series`` maps each
        name to host values, one per entry of ``times``."""
        if self._f is None:
            self._open(series.keys())
        cols = [series[n] for n in self._names]
        for k, (t, it) in enumerate(zip(times, iterations)):
            if int(it) % self._every == 0:
                self._csv.writerow([float(t), int(it)]
                                   + [float(c[k]) for c in cols])
        self._f.flush()

    def close(self):
        if self._f is not None and not self._f.closed:
            self._f.close()
