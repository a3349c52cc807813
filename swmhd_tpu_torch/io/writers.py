"""Output writers, port of :mod:`swmhd_tpu.io.writers`, with the same
files and columns so either package's readers open them.

:class:`FieldWriter` writes ``<path>/<name>/<index:06d>.npy`` plus
``<path>/meta.json``; in a decomposed run (more than one process, a
``decomposition`` given) each rank writes its tile as the slab
``<path>/<name>/<index:06d>.p<rank:05d>.npz`` (``data``, ``bounds``,
``shape``) and rank 0 writes ``meta.json``. :class:`ScalarSeriesWriter`
and :class:`ScalarWriter` write a CSV of ``time, iteration, <names...>``
rows, on rank 0.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
from typing import Callable, Mapping

import numpy as np
import torch

from ..parallel import multihost


class FieldWriter:
    """Named 2-D fields on a schedule; ``outputs`` maps name ->
    callable(simulation) -> tensor, this rank's tile of the field when a
    ``decomposition`` (a ``DomainDecomposition``) is given. Directories
    are made by rank 0, with barriers at init and at close."""

    def __init__(self, outputs: Mapping[str, Callable], schedule, path: str,
                 overwrite_existing: bool = True, decomposition=None):
        self.outputs = dict(outputs)
        self.schedule = schedule
        self.path = path
        self._times = []
        self._iters = []
        self._idx = 0
        self._rank = multihost.rank()
        self._dd = decomposition if multihost.world_size() > 1 else None
        if self._rank == 0:
            if overwrite_existing and os.path.isdir(path):
                shutil.rmtree(path)
            for name in self.outputs:
                os.makedirs(os.path.join(path, name), exist_ok=True)
        multihost.sync("fieldwriter:init:" + os.path.basename(path))
        self._grid_meta = None

    def _write_array(self, name, arr):
        dirpath = os.path.join(self.path, name)
        data = arr.detach().cpu().numpy()
        if self._dd is not None:
            # the temp name ends in .tmp, so no reader's slab glob
            # (<index>.p*.npz) matches a slab that is still being written
            final = os.path.join(dirpath,
                                 f"{self._idx:06d}.p{self._rank:05d}.npz")
            g = self._dd.model.grid
            with open(final + ".tmp", "wb") as f:
                np.savez(f, data=data, bounds=np.asarray(self._dd.bounds),
                         shape=np.asarray((g.Nx, g.Ny)))
            os.replace(final + ".tmp", final)
        elif self._rank == 0:
            np.save(os.path.join(dirpath, f"{self._idx:06d}.npy"), data)

    def write(self, sim):
        st = sim.state
        self._times.append(float(st.clock.time))
        self._iters.append(int(st.clock.iteration))
        for name, fn in self.outputs.items():
            self._write_array(name, fn(sim))
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
        if self._rank != 0:
            return
        meta = {"times": self._times, "iterations": self._iters,
                "fields": sorted(self.outputs), "grid": self._grid_meta,
                "n_processes": multihost.world_size()}
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def close(self):
        self._flush_meta()
        multihost.sync("fieldwriter:close:" + os.path.basename(self.path))


class ScalarSeriesWriter:
    """Scalar series → CSV. ``fn(model, state) -> {name: 0-d tensor}`` is
    evaluated after every step inside the simulation's chunk; rows whose
    iteration is on ``schedule`` (an IterationInterval) are written, by
    rank 0 alone in a run of several processes."""

    def __init__(self, fn: Callable, schedule, path: str,
                 overwrite_existing: bool = True):
        self.fn = fn
        self.schedule = schedule
        self.path = path
        self._every = int(getattr(schedule, "n", 1))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._overwrite = overwrite_existing
        self._rank = multihost.rank()
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
        if self._rank != 0:
            return
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


class ScalarWriter:
    """Scalars on a schedule → CSV rows of ``time, iteration, <names...>``.
    ``outputs`` maps name -> callable(simulation) -> 0-d tensor or number.

    Every rank evaluates every output, as a value may be reduced over
    ranks (``sim.diagnose``); rank 0 alone opens and writes the file. The
    values of a row reach the host in one device→host copy."""

    def __init__(self, outputs: Mapping[str, Callable], schedule, path: str,
                 overwrite_existing: bool = True):
        self.outputs = dict(outputs)
        self.schedule = schedule
        self.path = path
        self._rank = multihost.rank()
        self._f = None
        if self._rank != 0:
            return
        mode = "w" if overwrite_existing or not os.path.exists(path) else "a"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, mode, newline="")
        self._csv = csv.writer(self._f)
        if mode == "w":
            self._csv.writerow(["time", "iteration"] + sorted(self.outputs))

    def write(self, sim):
        st = sim.state
        vals = [self.outputs[name](sim) for name in sorted(self.outputs)]
        dev = next((v.device for v in vals if torch.is_tensor(v)), "cpu")
        host = [] if not vals else torch.stack([
            torch.as_tensor(v, dtype=torch.float64, device=dev).reshape(())
            for v in vals]).cpu().tolist()
        if self._f is None:
            return
        self._csv.writerow([float(st.clock.time), int(st.clock.iteration)]
                           + host)
        self._f.flush()

    def close(self):
        if self._f is not None and not self._f.closed:
            self._f.close()
