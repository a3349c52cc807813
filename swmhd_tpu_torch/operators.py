"""C-grid operator algebra on whole tensors, port of :mod:`swmhd_tpu.operators`.

Index convention (0-based, arrays ``(Nx, Ny)``, axis 0 = x):

    face i   = left edge of cell i
    center i = midpoint of cell i

    ddx_f(c)[i] = (c[i] - c[i-1])/dx      ix_f(c)[i] = (c[i] + c[i-1])/2
    ddx_c(f)[i] = (f[i+1] - f[i])/dx      ix_c(f)[i] = (f[i+1] + f[i])/2

and the same with x<->y on axis 1. Periodic shifts are ``torch.roll``;
a BOUNDED axis clamps the shift at the walls (edge replication), and
the flux differences zero the flux through the far wall face.
"""

from __future__ import annotations

import torch

from .grid import Grid, PERIODIC, BOUNDED


def index_x(a: torch.Tensor) -> torch.Tensor:
    """x-index of every row of ``a``, shaped to broadcast against it."""
    return torch.arange(a.shape[0], device=a.device).unsqueeze(1)


def index_y(a: torch.Tensor) -> torch.Tensor:
    return torch.arange(a.shape[1], device=a.device).unsqueeze(0)


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
    # out[i] = a[clip(i + n, 0, N - 1)]
    N = a.shape[axis]
    idx = torch.clamp(torch.arange(N, device=a.device) + n, 0, N - 1)
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
        up = torch.where(index_x(up) == grid.Nx - 1, 0.0, up)
    return up - f


def dy_c_flux(f, grid):
    up = shift_y(f, 1, grid)
    if grid.topology_y == BOUNDED:
        up = torch.where(index_y(up) == grid.Ny - 1, 0.0, up)
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
