"""Forcing hooks, port of :mod:`swmhd_tpu.forcing`.

A forcing is a callable ``(grid, clock, fields) -> tensor`` returning a
whole tendency contribution at the prognostic's staggering; a tuple key
lets one callable return several contributions at once."""

from __future__ import annotations

from .physics.lorentz import lorentz_force_jacobian, lorentz_force_divergence


def jacobian_lorentz_forcing(A_bg_grad_y: float = 0.0):
    """``{("u", "v"): f}`` with f returning the jacobian-form Lorentz
    force on both momentum components."""
    def f(grid, clock, fields):
        return lorentz_force_jacobian(fields["A"], fields["h"], grid,
                                      A_bg_grad_y)

    # lets the CUDA stepper recognise the force it computes in-kernel
    f.jacobian_lorentz_A_bg_grad_y = float(A_bg_grad_y)
    return {("u", "v"): f}


def divergence_lorentz_forcing(A_bg_grad_y: float = 0.0):
    """``{("uh", "vh"): f}`` with f returning the divergence-form Lorentz
    force ∇·(hB⊗B) on both transports (the conservative formulation)."""
    def f(grid, clock, fields):
        return lorentz_force_divergence(fields["A"], fields["h"], grid,
                                        A_bg_grad_y)

    f.divergence_lorentz_A_bg_grad_y = float(A_bg_grad_y)
    return {("uh", "vh"): f}
