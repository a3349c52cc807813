"""Scalar diagnostics, port of :mod:`swmhd_tpu.diagnostics`: energies,
cross-helicity, enstrophy, the progress extrema and the CFL numbers, as
tensor reductions that stay on the device, and the derived-field set.

Domain integrals are ``mean(·)·Lx·Ly``; potential energy is measured
against the initial height field.

On a tile of a domain decomposition the same functions run on the tile
padded with a halo (see ``DomainDecomposition.tile_diagnostics``): under
:func:`tile_reduction` each integral is the tile's share of the sum and
each extremum the tile's, both over the tile without its halo, and the
reduction object combines them over ranks. :func:`cfl_numbers` reduces
its maxima there itself, as they are not extrema of one field.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from . import operators as op
from .models.shallow_water import CONSERVATIVE
from .parallel import multihost
from .physics.lorentz import magnetic_field_cc

_TILE = [None]


class TileReduction:
    """Collects which values of one diagnostics evaluation are extrema
    (every other value is a linear combination of integrals, so a sum over
    ranks) and reduces them: one ``all_reduce`` of the stacked sums, one
    of the stacked maxima and negated minima."""

    def __init__(self, halo: int):
        self.halo = halo
        self._kind = {}       # id(value) -> "max" | "min"
        self._keep = []       # holds the values so their ids stay unique

    def crop(self, a):
        H = self.halo
        return a[H:a.shape[0] - H, H:a.shape[1] - H]

    def mark(self, value, kind):
        self._kind[id(value)] = kind
        self._keep.append(value)
        return value

    def reduce(self, out: dict) -> dict:
        kind = {n: self._kind.get(id(v), "sum") for n, v in out.items()}
        sums = [n for n in out if kind[n] == "sum"]
        ext = [n for n in out if kind[n] != "sum"]
        res = {}
        if sums:
            v = multihost.all_reduce(torch.stack([out[n] for n in sums]))
            res.update(zip(sums, v.unbind(0)))
        if ext:
            v = multihost.all_reduce(
                torch.stack([out[n] if kind[n] == "max" else -out[n]
                             for n in ext]), dist.ReduceOp.MAX)
            res.update((n, x if kind[n] == "max" else -x)
                       for n, x in zip(ext, v.unbind(0)))
        return {n: res[n] for n in out}


@contextlib.contextmanager
def tile_reduction(halo: int):
    """Evaluate diagnostics on a tile padded by ``halo``; yields the
    :class:`TileReduction` that combines the results over ranks."""
    prev, _TILE[0] = _TILE[0], TileReduction(halo)
    try:
        yield _TILE[0]
    finally:
        _TILE[0] = prev


def on_tile() -> bool:
    """Whether diagnostics run on a tile, under :func:`tile_reduction`."""
    return _TILE[0] is not None


def _integral(field, grid):
    t = _TILE[0]
    if t is None:
        return torch.mean(field) * grid.Lx * grid.Ly
    return torch.sum(t.crop(field)) / (grid.Nx * grid.Ny) * grid.Lx * grid.Ly


def _extremum(a, kind):
    t = _TILE[0]
    if t is None:
        return torch.max(a) if kind == "max" else torch.min(a)
    a = t.crop(a)
    return t.mark(torch.max(a) if kind == "max" else torch.min(a), kind)


def kinetic_energy(u, v, h, grid):
    """∫ ½ h (u²+v²), u and v interpolated to centers."""
    u2 = op.ix_c(u * u, grid)
    v2 = op.iy_c(v * v, grid)
    return _integral(0.5 * h * (u2 + v2), grid)


def magnetic_energy(A, h, grid, A_bg_grad_y: float = 0.0):
    """∫ ½ h (Bx²+By²) with B = (−∂yA, ∂xA)/h at centers."""
    Bx, By = magnetic_field_cc(A, h, grid, A_bg_grad_y)
    return _integral(0.5 * h * (Bx * Bx + By * By), grid)


def potential_energy(h, h0, g_acc, grid):
    """∫ ½ g (h−h₀)² against the initial height h₀."""
    return _integral(0.5 * g_acc * (h - h0) ** 2, grid)


def total_energy(u, v, h, A, h0, g_acc, grid, A_bg_grad_y: float = 0.0):
    return (kinetic_energy(u, v, h, grid)
            + magnetic_energy(A, h, grid, A_bg_grad_y)
            + potential_energy(h, h0, g_acc, grid))


def total_energy_deviation(E, E0):
    """|E − E₀|·100, what the reference plots as "relative energy error
    (%)"."""
    return abs(E - E0) * 100.0


def cross_helicity(u, v, A, h, grid, A_bg_grad_y: float = 0.0):
    """∫ h (u·B)."""
    Bx, By = magnetic_field_cc(A, h, grid, A_bg_grad_y)
    uc = op.ix_c(u, grid)
    vc = op.iy_c(v, grid)
    return _integral(h * (uc * Bx + vc * By), grid)


def enstrophy(u, v, grid):
    z = op.vorticity_ff(u, v, grid)
    return _integral(0.5 * z * z, grid)


def extrema_report(u, v, h, A, grid):
    """max speed, max|u|, max A, min h (the progress-log fields)."""
    speed = torch.sqrt(op.ix_c(u, grid) ** 2 + op.iy_c(v, grid) ** 2)
    return {
        "max_speed": _extremum(speed, "max"),
        "max_abs_u": _extremum(torch.abs(u), "max"),
        "max_A": _extremum(A, "max"),
        "min_h": _extremum(h, "min"),
    }


def derived_fields(model, state, h0=None):
    """The reference's derived fields: ``u``, ``v`` (velocities), speed
    ``s`` at centers, ``Bx``, ``By`` at centers, vorticity ``omega``,
    ``h``, ``A`` with its background γ·y added, and ``eta = h − h0`` when
    ``h0`` is given."""
    g = model.grid
    gamma = model.A_background_gradient_y
    u, v = model.velocities(state)
    Bx, By = magnetic_field_cc(state.A, state.h, g, gamma)
    A_total = state.A
    if gamma:
        A_total = state.A + gamma * g.nodes("cc")[1]
    out = {
        "u": u,
        "v": v,
        "s": torch.sqrt(op.ix_c(u, g) ** 2 + op.iy_c(v, g) ** 2),
        "Bx": Bx,
        "By": By,
        "omega": op.vorticity_ff(u, v, g),
        "h": state.h,
        "A": A_total,
    }
    if h0 is not None:
        out["eta"] = state.h - h0
    return out


def cfl_maxima(model, state):
    """max|u|, max|v| (velocities) and max h: what :func:`cfl_numbers`
    reads from the state, as extrema."""
    u, v = model.velocities(state)
    return {"max_abs_u": _extremum(torch.abs(u), "max"),
            "max_abs_v": _extremum(torch.abs(v), "max"),
            "max_h": _extremum(state.h, "max")}


def cfl_of_maxima(model, maxima, dt):
    """(advective, gravity-wave) CFL numbers of :func:`cfl_maxima`'s
    values, 0-d tensors or host floats: ``(max|u|/Δx + max|v|/Δy)·Δt``
    and ``√(g·max h)·(1/Δx + 1/Δy)·Δt``."""
    g = model.grid
    max_h = maxima["max_h"]
    sqrt = torch.sqrt if torch.is_tensor(max_h) else math.sqrt
    adv = maxima["max_abs_u"] / g.dx + maxima["max_abs_v"] / g.dy
    wave = sqrt(model.gravitational_acceleration * max_h) \
        * (1.0 / g.dx + 1.0 / g.dy)
    return adv * dt, wave * dt


def cfl_numbers(model, state, dt):
    """(advective CFL, gravity-wave CFL) for a step of ``dt``. On a tile
    (under :func:`tile_reduction`) the three maxima are reduced over
    ranks first, and the two results are marked as maxima of equal
    values, so an enclosing reduction keeps them."""
    maxima = cfl_maxima(model, state)
    t = _TILE[0]
    if t is None:
        return cfl_of_maxima(model, maxima, dt)
    adv, wave = cfl_of_maxima(model, t.reduce(maxima), dt)
    return t.mark(adv, "max"), t.mark(wave, "max")


def reference_kinetic_energy(u, v, h, grid):
    """∫ ½ h (u²+v²) with staggered fields read index-aligned, the
    reference's own functional."""
    return _integral(0.5 * h * (u * u + v * v), grid)


def reference_magnetic_energy(A, h, grid, A_bg_grad_y: float = 0.0):
    """∫ ½ |∇A|²/h on the staggered points, index-aligned."""
    dyA = op.ddy_f(A, grid) + A_bg_grad_y
    dxA = op.ddx_f(A, grid)
    return _integral(0.5 * (dyA * dyA + dxA * dxA) / h, grid)


def reference_energy_report(model, state, h0):
    """Energies in the reference's index-aligned convention."""
    g = model.grid
    gamma = model.A_background_gradient_y
    if model.formulation == CONSERVATIVE:
        # ½ (uh² + vh²)/h, index-aligned: the functional of divergence_sw_mhd.jl
        uh, vh = state.u, state.v
        ke = _integral(0.5 * (uh * uh + vh * vh) / state.h, g)
    else:
        u, v = model.velocities(state)
        ke = reference_kinetic_energy(u, v, state.h, g)
    me = reference_magnetic_energy(state.A, state.h, g, gamma)
    pe = potential_energy(state.h, h0, model.gravitational_acceleration, g)
    return {
        "kinetic_energy": ke,
        "magnetic_energy": me,
        "potential_energy": pe,
        "total_energy": ke + me + pe,
    }


def energy_report(model, state, h0):
    """All scalar diagnostics as a dict of 0-d tensors."""
    g = model.grid
    gamma = model.A_background_gradient_y
    u, v = model.velocities(state)
    ke = kinetic_energy(u, v, state.h, g)
    me = magnetic_energy(state.A, state.h, g, gamma)
    pe = potential_energy(state.h, h0, model.gravitational_acceleration, g)
    return {
        "kinetic_energy": ke,
        "magnetic_energy": me,
        "potential_energy": pe,
        "total_energy": ke + me + pe,
        "cross_helicity": cross_helicity(u, v, state.A, state.h, g, gamma),
        "enstrophy": enstrophy(u, v, g),
        **extrema_report(u, v, state.h, state.A, g),
    }
