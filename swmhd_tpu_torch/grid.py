"""Staggered Arakawa C-grid, PyTorch port of :mod:`swmhd_tpu.grid`.

Arrays are shaped ``(Nx, Ny)`` with axis 0 = x, so y is the contiguous
axis. Face ``i`` is the left edge of cell ``i``:

    xf[i] = x0 + i*dx          xc[i] = x0 + (i + 1/2)*dx

Field locations by (x, y) staggering: ``cc`` centers (h, A), ``fc``
(u), ``cf`` (v), ``ff`` corners (vorticity). Coordinates are computed in
the grid dtype with the same operation order as the JAX grid, so float32
initial conditions agree with it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

PERIODIC = "periodic"
BOUNDED = "bounded"

_VALID_TOPOLOGIES = (PERIODIC, BOUNDED)


def require_device(device) -> str:
    """``device`` as a string, or ``RuntimeError`` for a CUDA device when
    CUDA is not available: nothing moves to the CPU unless asked to."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} but CUDA is not "
                           f"available (pass device='cpu' for the CPU)")
    return str(device)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the checkpoint's spelling)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform rectilinear staggered grid (2-D, z Flat) on one device:
    the card unless ``device="cpu"`` is asked for."""

    Nx: int
    Ny: int
    Lx: float
    Ly: float
    x0: float  # coordinate of x-face 0 (left domain edge)
    y0: float  # coordinate of y-face 0 (bottom domain edge)
    topology_x: str = PERIODIC
    topology_y: str = PERIODIC
    dtype_name: str = "float32"
    device: str = "cuda"

    def __post_init__(self):
        require_device(self.device)

    @staticmethod
    def regular(Nx: int, Ny: int,
                extent_x: Tuple[float, float],
                extent_y: Tuple[float, float],
                topology: Tuple[str, str] = (PERIODIC, PERIODIC),
                dtype: torch.dtype = torch.float32,
                device="cuda") -> "Grid":
        tx, ty = (t.lower() for t in topology)
        if tx not in _VALID_TOPOLOGIES or ty not in _VALID_TOPOLOGIES:
            raise ValueError(f"topology must be in {_VALID_TOPOLOGIES}")
        return Grid(Nx=int(Nx), Ny=int(Ny),
                    Lx=float(extent_x[1] - extent_x[0]),
                    Ly=float(extent_y[1] - extent_y[0]),
                    x0=float(extent_x[0]), y0=float(extent_y[0]),
                    topology_x=tx, topology_y=ty,
                    dtype_name=dtype_name(dtype), device=str(device))

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @property
    def dx(self) -> float:
        return self.Lx / self.Nx

    @property
    def dy(self) -> float:
        return self.Ly / self.Ny

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.Nx, self.Ny)

    # Face and cell areas of the uniform grid with Flat z (dz = 1), the
    # factors of the divergence-form Lorentz flux.
    @property
    def Ax(self) -> float:  # x-normal face: dy·dz
        return self.dy

    @property
    def Ay(self) -> float:  # y-normal face: dx·dz
        return self.dx

    @property
    def Az(self) -> float:  # horizontal cell: dx·dy
        return self.dx * self.dy

    def _arange(self, n):
        return torch.arange(n, dtype=self.dtype, device=self.device)

    def xf(self) -> torch.Tensor:
        return self.x0 + self.dx * self._arange(self.Nx)

    def xc(self) -> torch.Tensor:
        return self.x0 + self.dx * (self._arange(self.Nx) + 0.5)

    def yf(self) -> torch.Tensor:
        return self.y0 + self.dy * self._arange(self.Ny)

    def yc(self) -> torch.Tensor:
        return self.y0 + self.dy * (self._arange(self.Ny) + 0.5)

    def nodes(self, loc: str = "cc"):
        """2-D coordinate meshes (X, Y) for ``loc`` in {cc, fc, cf, ff}."""
        x = self.xc() if loc[0] == "c" else self.xf()
        y = self.yc() if loc[1] == "c" else self.yf()
        return torch.meshgrid(x, y, indexing="ij")

    def evaluate(self, fn, loc: str = "cc") -> torch.Tensor:
        """``fn(x, y)`` on the staggered mesh of ``loc`` (the ``set!``
        analog)."""
        X, Y = self.nodes(loc)
        return torch.as_tensor(fn(X, Y), dtype=self.dtype,
                               device=self.device)

    def with_dtype(self, dtype) -> "Grid":
        """The same grid, on the same device, in ``dtype`` (a
        ``torch.dtype`` or its name)."""
        return dataclasses.replace(self, dtype_name=dtype_name(dtype))

    def meta(self) -> dict:
        """The checkpoint's ``meta["grid"]`` dictionary."""
        return {"Nx": self.Nx, "Ny": self.Ny, "Lx": self.Lx, "Ly": self.Ly,
                "x0": self.x0, "y0": self.y0,
                "topology_x": self.topology_x,
                "topology_y": self.topology_y,
                "dtype_name": self.dtype_name}

    def __repr__(self) -> str:
        return (f"Grid({self.Nx}x{self.Ny}, Lx={self.Lx}, Ly={self.Ly}, "
                f"topo=({self.topology_x},{self.topology_y}), "
                f"{self.dtype_name}, {self.device})")
