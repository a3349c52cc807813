"""C-grid operator algebra on whole tensors, port of :mod:`swmhd_tpu.operators`.

Index convention (0-based, arrays ``(Nx, Ny)``, axis 0 = x):

    face i   = left edge of cell i
    center i = midpoint of cell i

    ddx_f(c)[i] = (c[i] - c[i-1])/dx      ix_f(c)[i] = (c[i] + c[i-1])/2
    ddx_c(f)[i] = (f[i+1] - f[i])/dx      ix_c(f)[i] = (f[i+1] + f[i])/2

and the same with x<->y on axis 1. Periodic shifts are ``torch.roll``;
a BOUNDED axis clamps the shift at the walls (edge replication), and
the flux differences zero the flux through the far wall face.

Every wall is keyed on the *global* index of a row or column. On a whole
array that is the local index; on a tile of a domain decomposition,
padded with an exchanged halo, the :class:`IndexContext` installed
around the tile's tendency shifts it by the tile's origin, so the same
code clamps and zeroes at the domain's walls and never at a tile edge.
"""

from __future__ import annotations

import dataclasses

import torch

from .grid import Grid, PERIODIC, BOUNDED


# -- global-index context --------------------------------------------------------

@dataclasses.dataclass
class IndexContext:
    """Maps local array indices to global domain indices: ``ox``/``oy``
    are the global indices of local row/column 0, ``gNx``/``gNy`` the
    domain's sizes (what the wall masks compare against)."""
    ox: int
    oy: int
    gNx: int
    gNy: int


_INDEX_CTX = [None]


def set_index_ctx(ctx):
    """Install an IndexContext (None to clear); returns the previous one."""
    old = _INDEX_CTX[0]
    _INDEX_CTX[0] = ctx
    return old


def global_index_x(a: torch.Tensor) -> torch.Tensor:
    """Global x-index of every row of ``a``, shaped to broadcast against
    it."""
    ctx = _INDEX_CTX[0]
    i = torch.arange(a.shape[0], device=a.device).unsqueeze(1)
    return i if ctx is None else i + ctx.ox


def global_index_y(a: torch.Tensor) -> torch.Tensor:
    ctx = _INDEX_CTX[0]
    j = torch.arange(a.shape[1], device=a.device).unsqueeze(0)
    return j if ctx is None else j + ctx.oy


def global_nx(grid: Grid) -> int:
    ctx = _INDEX_CTX[0]
    return grid.Nx if ctx is None else ctx.gNx


def global_ny(grid: Grid) -> int:
    ctx = _INDEX_CTX[0]
    return grid.Ny if ctx is None else ctx.gNy


# -- shifts -------------------------------------------------------------------

def shift_x(a: torch.Tensor, n: int, grid: Grid) -> torch.Tensor:
    """out[i, j] = a[i+n, j], periodic wrap or bounded edge clamp."""
    if n == 0:
        return a
    if grid.topology_x == PERIODIC:
        return torch.roll(a, -n, 0)
    return _clamped_shift(a, n, 0)


def shift_y(a: torch.Tensor, n: int, grid: Grid) -> torch.Tensor:
    """out[i, j] = a[i, j+n]."""
    if n == 0:
        return a
    if grid.topology_y == PERIODIC:
        return torch.roll(a, -n, 1)
    return _clamped_shift(a, n, 1)


def _clamped_shift(a: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    # out[i] = a[i + n] with the read clamped to the GLOBAL wall rows: a
    # read past a wall takes the wall row (at its local index, clamped
    # into the array as the reference's dynamic_slice does); any other
    # read wraps like a roll, which only a tile's halo ring ever sees.
    N = a.shape[axis]
    ctx = _INDEX_CTX[0]
    origin = 0 if ctx is None else (ctx.ox if axis == 0 else ctx.oy)
    gN = N if ctx is None else (ctx.gNx if axis == 0 else ctx.gNy)
    j = torch.arange(N, device=a.device) + n
    g = j + origin
    lo = min(max(-origin, 0), N - 1)
    hi = min(max(gN - 1 - origin, 0), N - 1)
    idx = torch.where(g < 0, lo, torch.where(g > gN - 1, hi, j % N))
    return torch.index_select(a, axis, idx)


# -- differences (δ) ----------------------------------------------------------

def dx_f(a, grid):  # center -> face: a[i] - a[i-1]
    return a - shift_x(a, -1, grid)


def dx_c(a, grid):  # face -> center: a[i+1] - a[i]
    return shift_x(a, 1, grid) - a


def dy_f(a, grid):
    return a - shift_y(a, -1, grid)


def dy_c(a, grid):
    return shift_y(a, 1, grid) - a


# -- flux differences (wall-aware) ---------------------------------------------

def dx_c_flux(f, grid):
    up = shift_x(f, 1, grid)
    if grid.topology_x == BOUNDED:
        up = torch.where(global_index_x(up) == global_nx(grid) - 1, 0.0, up)
    return up - f


def dy_c_flux(f, grid):
    up = shift_y(f, 1, grid)
    if grid.topology_y == BOUNDED:
        up = torch.where(global_index_y(up) == global_ny(grid) - 1, 0.0, up)
    return up - f


def ddx_c_flux(f, grid):
    return dx_c_flux(f, grid) / grid.dx


def ddy_c_flux(f, grid):
    return dy_c_flux(f, grid) / grid.dy


# -- derivatives (∂ = δ/Δ) -----------------------------------------------------

def ddx_f(a, grid):
    return dx_f(a, grid) / grid.dx


def ddx_c(a, grid):
    return dx_c(a, grid) / grid.dx


def ddy_f(a, grid):
    return dy_f(a, grid) / grid.dy


def ddy_c(a, grid):
    return dy_c(a, grid) / grid.dy


# -- interpolations (ℑ, 2-point means) ----------------------------------------

def ix_f(a, grid):
    return 0.5 * (a + shift_x(a, -1, grid))


def ix_c(a, grid):
    return 0.5 * (shift_x(a, 1, grid) + a)


def iy_f(a, grid):
    return 0.5 * (a + shift_y(a, -1, grid))


def iy_c(a, grid):
    return 0.5 * (shift_y(a, 1, grid) + a)


# -- 4-point corner means --------------------------------------------------------

def ixy_fc(a, grid):
    """(c,f) field -> (f,c)."""
    return ix_f(iy_c(a, grid), grid)


def ixy_cf(a, grid):
    """(f,c) field -> (c,f)."""
    return ix_c(iy_f(a, grid), grid)


def ixy_ff(a, grid):
    return ix_f(iy_f(a, grid), grid)


def ixy_cc(a, grid):
    return ix_c(iy_c(a, grid), grid)


# -- composite diagnostics ------------------------------------------------------

def vorticity_ff(u, v, grid):
    """ζ = ∂x v − ∂y u at corners (f,f)."""
    return ddx_f(v, grid) - ddy_f(u, grid)


def divergence_cc(u, v, grid):
    return ddx_c(u, grid) + ddy_c(v, grid)


def laplacian_cc(a, grid):
    return ddx_c(ddx_f(a, grid), grid) + ddy_c(ddy_f(a, grid), grid)


def kinetic_energy_cc(u, v, grid):
    """K = (ℑxᶜ(u²) + ℑyᶜ(v²))/2 at centers."""
    return 0.5 * (ix_c(u * u, grid) + iy_c(v * v, grid))
