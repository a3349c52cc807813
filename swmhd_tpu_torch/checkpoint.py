"""Checkpoint / resume in the layouts of :mod:`swmhd_tpu.checkpoint`, so
either package restores the other's files:

- one ``.npz`` (``h, u, v, A, time, iteration`` and a JSON ``meta`` with
  the grid): :func:`save`, :func:`restore`;
- a directory for a decomposed run (:func:`save_sharded`,
  :func:`restore_sharded`): each rank writes ``slab_<rank:05d>.npz`` with
  the global ``bounds`` of its tile and the four fields, rank 0 writes
  ``meta.json`` (``version``, ``n_slabs``, ``time``, ``iteration``,
  ``grid``). A restore assembles each tile from whichever slabs overlap
  it, so the layout may change between save and restore.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .convert import grid_from_meta, state_from_numpy, state_to_numpy
from .grid import Grid
from .models.state import State
from .parallel import multihost

_FORMAT_VERSION = 1


def save(path: str, state: State, grid: Grid) -> None:
    meta = {"version": _FORMAT_VERSION, "grid": grid.meta()}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state_to_numpy(state), meta=json.dumps(meta))
    os.replace(tmp, path)


def restore(path: str, grid: Grid | None = None) -> State:
    """The checkpointed state, on ``grid``'s device and dtype when given
    (its size must match), else on the card in the saved dtype."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {meta['version']}")
        gm = meta["grid"]
        if grid is None:
            grid = grid_from_meta(gm)
        elif (gm["Nx"], gm["Ny"]) != (grid.Nx, grid.Ny):
            raise ValueError(
                f"checkpoint grid {gm['Nx']}x{gm['Ny']} != "
                f"model grid {grid.Nx}x{grid.Ny}")
        return state_from_numpy({k: z[k] for k in z.files if k != "meta"},
                                device=grid.device, dtype=grid.dtype)


def grid_from_checkpoint(path: str, device="cuda") -> Grid:
    with np.load(path, allow_pickle=False) as z:
        return grid_from_meta(json.loads(str(z["meta"]))["grid"], device)



def save_sharded(dirpath: str, state: State, grid: Grid, mesh) -> None:
    """Each rank writes its tile ``state`` as ``slab_<rank:05d>.npz``; rank
    0 writes ``meta.json``. Returns after a barrier, so the directory is
    complete when any rank returns."""
    (x0, x1), (y0, y1) = multihost.process_local_slab(mesh, grid.Nx, grid.Ny)
    pid = multihost.rank()
    if pid == 0:
        os.makedirs(dirpath, exist_ok=True)
    multihost.sync("ckpt:mkdir:" + os.path.basename(dirpath))
    fields = {k: v for k, v in state_to_numpy(state).items()
              if k in State.FIELDS}
    final = os.path.join(dirpath, f"slab_{pid:05d}.npz")
    with open(final + ".tmp", "wb") as f:
        np.savez(f, bounds=np.array([x0, x1, y0, y1]), **fields)
    os.replace(final + ".tmp", final)
    if pid == 0:
        meta = {"version": _FORMAT_VERSION,
                "n_slabs": multihost.world_size(),
                "time": float(state.clock.time),
                "iteration": int(state.clock.iteration),
                "grid": grid.meta()}
        with open(os.path.join(dirpath, "meta.json.tmp"), "w") as f:
            json.dump(meta, f)
        os.replace(os.path.join(dirpath, "meta.json.tmp"),
                   os.path.join(dirpath, "meta.json"))
    multihost.sync("ckpt:save:" + os.path.basename(dirpath))


def restore_sharded(dirpath: str, grid: Grid, mesh) -> State:
    """This rank's tile of the state saved by :func:`save_sharded` (by
    either package, under any layout), on ``grid``'s device and dtype."""
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {meta['version']}")
    gm = meta["grid"]
    if (gm["Nx"], gm["Ny"]) != (grid.Nx, grid.Ny):
        raise ValueError(f"checkpoint grid {gm['Nx']}x{gm['Ny']} != "
                         f"model grid {grid.Nx}x{grid.Ny}")
    (x0, x1), (y0, y1) = multihost.process_local_slab(mesh, grid.Nx, grid.Ny)
    out = {k: np.empty((x1 - x0, y1 - y0), dtype=np.dtype(grid.dtype_name))
           for k in State.FIELDS}
    covered = np.zeros((x1 - x0, y1 - y0), dtype=bool)
    for pid in range(meta["n_slabs"]):
        with np.load(os.path.join(dirpath, f"slab_{pid:05d}.npz")) as z:
            a0, a1, b0, b1 = (int(b) for b in z["bounds"])
            i0, i1 = max(x0, a0), min(x1, a1)
            j0, j1 = max(y0, b0), min(y1, b1)
            if i0 >= i1 or j0 >= j1:
                continue
            dst = (slice(i0 - x0, i1 - x0), slice(j0 - y0, j1 - y0))
            if covered[dst].any():
                raise RuntimeError(f"slab {pid} overlaps another slab")
            covered[dst] = True
            for k in State.FIELDS:
                out[k][dst] = z[k][i0 - a0:i1 - a0, j0 - b0:j1 - b0]
    if not covered.all():
        raise RuntimeError(f"slabs cover {int(covered.sum())} of "
                           f"{covered.size} points of this rank's tile")
    return state_from_numpy(dict(out, time=meta["time"],
                                 iteration=meta["iteration"]),
                            device=grid.device, dtype=grid.dtype)
