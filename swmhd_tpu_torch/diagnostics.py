"""Scalar diagnostics, port of :mod:`swmhd_tpu.diagnostics`: energies,
cross-helicity, enstrophy and the progress extrema, as tensor reductions
that stay on the device.

Domain integrals are ``mean(·)·Lx·Ly``; potential energy is measured
against the initial height field.
"""

from __future__ import annotations

import torch

from . import operators as op
from .models.shallow_water import CONSERVATIVE
from .physics.lorentz import magnetic_field_cc


def _integral(field, grid):
    return torch.mean(field) * grid.Lx * grid.Ly


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
        "max_speed": torch.max(speed),
        "max_abs_u": torch.max(torch.abs(u)),
        "max_A": torch.max(A),
        "min_h": torch.min(h),
    }


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
