"""Jacobian-form Lorentz force, port of :mod:`swmhd_tpu.physics.lorentz`.

With the magnetic potential A advected as a tracer, B = (−∂y A, ∂x A)/h,
and the vector-invariant momentum equations feel

    force_u = (1/ℑxᶠh) [ ∂xᶠA · ℑxyᶠᶜ(∂yᶠ Bx) − ℑxyᶠᶜ(∂yᶠA) · ∂xᶠ Bx ]
    force_v = (1/ℑyᶠh) [ ℑxyᶜᶠ(∂xᶠA) · ∂yᶠ By − ∂yᶠA · ℑxyᶜᶠ(∂xᶠ By) ]

``A_bg_grad_y`` γ: the prognostic A is a perturbation on a static linear
background γ·y, whose y-derivative is added analytically.
"""

from __future__ import annotations

from .. import operators as op


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
