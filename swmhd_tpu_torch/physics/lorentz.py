"""Lorentz force in both forms, port of :mod:`swmhd_tpu.physics.lorentz`.

With the magnetic potential A advected as a tracer, B = (−∂y A, ∂x A)/h.
The vector-invariant momentum equations feel the jacobian form

    force_u = (1/ℑxᶠh) [ ∂xᶠA · ℑxyᶠᶜ(∂yᶠ Bx) − ℑxyᶠᶜ(∂yᶠA) · ∂xᶠ Bx ]
    force_v = (1/ℑyᶠh) [ ℑxyᶜᶠ(∂xᶠA) · ∂yᶠ By − ∂yᶠA · ℑxyᶜᶠ(∂xᶠ By) ]

and the conservative ones the divergence form ∇·(hB⊗B), with hB the
symmetric transport and B reconstructed UpwindBiased3.

``A_bg_grad_y`` γ: the prognostic A is a perturbation on a static linear
background γ·y, whose y-derivative is added analytically.
"""

from __future__ import annotations

from .. import operators as op
from ..advection import (
    upwind_biased_product, left3_x_f, right3_x_f, left3_y_f, right3_y_f,
    left3_x_c, right3_x_c, left3_y_c, right3_y_c,
)


def magnetic_field_cc(A, h, grid, A_bg_grad_y: float = 0.0):
    """(Bx, By) at cell centers = (−ℑyᶜ(∂yᶠA), ℑxᶜ(∂xᶠA))/h."""
    Bx = -op.iy_c(op.ddy_f(A, grid) + A_bg_grad_y, grid) / h
    By = op.ix_c(op.ddx_f(A, grid), grid) / h
    return Bx, By


def lorentz_force_jacobian(A, h, grid, A_bg_grad_y: float = 0.0):
    """(force_u at (f,c), force_v at (c,f))."""
    dAdx_f = op.ddx_f(A, grid)                        # (f,c)
    dAdy_f = op.ddy_f(A, grid) + A_bg_grad_y          # (c,f)

    Bx = -op.iy_c(dAdy_f, grid) / h
    By = op.ix_c(dAdx_f, grid) / h

    jac_x = (dAdx_f * op.ixy_fc(op.ddy_f(Bx, grid), grid)
             - op.ixy_fc(dAdy_f, grid) * op.ddx_f(Bx, grid))
    jac_y = (op.ixy_cf(dAdx_f, grid) * op.ddy_f(By, grid)
             - dAdy_f * op.ixy_cf(op.ddx_f(By, grid), grid))

    force_u = jac_x / op.ix_f(h, grid)
    force_v = jac_y / op.iy_f(h, grid)
    return force_u, force_v


def magnetic_field_faces(A, h, grid, A_bg_grad_y: float = 0.0):
    """(Bx at (f,c), By at (c,f), hBx, hBy): the face-staggered B of the
    divergence form and its h-free numerators, the transport field."""
    hBx = -op.ixy_fc(op.ddy_f(A, grid) + A_bg_grad_y, grid)   # (f,c)
    hBy = op.ixy_cf(op.ddx_f(A, grid), grid)                  # (c,f)
    Bx = hBx / op.ix_f(h, grid)
    By = hBy / op.iy_f(h, grid)
    return Bx, By, hBx, hBy


def lorentz_force_divergence(A, h, grid, A_bg_grad_y: float = 0.0):
    """(force_uh at (f,c), force_vh at (c,f)) = ∇·(hB⊗B): four fluxes,
    each the symmetric transport times the upwinded third-order B, face
    area weighted, differenced with the plain (clamped) differences and
    divided by the cell area."""
    Bx, By, hBx, hBy = magnetic_field_faces(A, h, grid, A_bg_grad_y)
    Ax, Ay, Az = grid.Ax, grid.Ay, grid.Az

    flux_xx = Ax * upwind_biased_product(
        op.ix_c(hBx, grid), left3_x_c(Bx, grid), right3_x_c(Bx, grid))  # (c,c)
    flux_yx = Ay * upwind_biased_product(
        op.ix_f(hBy, grid), left3_y_f(Bx, grid), right3_y_f(Bx, grid))  # (f,f)
    force_uh = (op.dx_f(flux_xx, grid) + op.dy_c(flux_yx, grid)) / Az

    flux_xy = Ax * upwind_biased_product(
        op.iy_f(hBx, grid), left3_x_f(By, grid), right3_x_f(By, grid))  # (f,f)
    flux_yy = Ay * upwind_biased_product(
        op.iy_c(hBy, grid), left3_y_c(By, grid), right3_y_c(By, grid))  # (c,c)
    force_vh = (op.dx_c(flux_xy, grid) + op.dy_f(flux_yy, grid)) / Az
    return force_uh, force_vh
