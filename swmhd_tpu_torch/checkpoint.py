"""Checkpoint / resume in the ``.npz`` layout of :mod:`swmhd_tpu.checkpoint`
(``h, u, v, A, time, iteration`` and a JSON ``meta`` with the grid), so
either package restores the other's file."""

from __future__ import annotations

import json
import os

import numpy as np

from .convert import grid_from_meta, state_from_numpy, state_to_numpy
from .grid import Grid
from .models.state import State

_FORMAT_VERSION = 1


def save(path: str, state: State, grid: Grid) -> None:
    meta = {"version": _FORMAT_VERSION, "grid": grid.meta()}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state_to_numpy(state), meta=json.dumps(meta))
    os.replace(tmp, path)


def restore(path: str, grid: Grid | None = None) -> State:
    """The checkpointed state, on ``grid``'s device and dtype when given
    (its size must match), else on the CPU in the saved dtype."""
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


def grid_from_checkpoint(path: str, device="cpu") -> Grid:
    with np.load(path, allow_pickle=False) as z:
        return grid_from_meta(json.loads(str(z["meta"]))["grid"], device)

