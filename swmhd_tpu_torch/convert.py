"""State and grid across the package boundary as plain numpy data.

The JAX package's checkpoint layout (``h, u, v, A, time, iteration`` plus
``meta["grid"]``) is the exchange format: it needs neither framework.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .grid import Grid, require_device
from .models.state import Clock, State


def state_from_numpy(arrays: Mapping, device="cuda",
                     dtype: torch.dtype = torch.float32) -> State:
    """``{"h", "u", "v", "A", "time", "iteration"}`` -> :class:`State`."""
    require_device(device)
    fields = {k: torch.as_tensor(np.array(arrays[k]), dtype=dtype,
                                 device=device)
              for k in State.FIELDS}
    clock = Clock(float(np.asarray(arrays.get("time", 0.0))),
                  int(np.asarray(arrays.get("iteration", 0))))
    return State(clock=clock, **fields)


def state_to_numpy(state: State) -> dict:
    out = {k: getattr(state, k).detach().cpu().numpy() for k in State.FIELDS}
    out["time"] = np.float64(state.clock.time)
    out["iteration"] = np.int32(state.clock.iteration)
    return out


def grid_from_meta(meta: Mapping, device="cuda") -> Grid:
    """A grid from the checkpoint's ``meta["grid"]`` keys."""
    return Grid(Nx=int(meta["Nx"]), Ny=int(meta["Ny"]),
                Lx=float(meta["Lx"]), Ly=float(meta["Ly"]),
                x0=float(meta["x0"]), y0=float(meta["y0"]),
                topology_x=meta.get("topology_x", "periodic"),
                topology_y=meta.get("topology_y", "periodic"),
                dtype_name=meta.get("dtype_name", "float32"),
                device=str(device))
