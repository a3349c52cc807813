"""Laplacian and biharmonic diffusion closures, port of
:mod:`swmhd_tpu.physics.diffusion`.

Staggered Laplacians:

    center field  c: ∇²c = ∂xᶜ(∂xᶠ c) + ∂yᶜ(∂yᶠ c)
    x-face field  u: ∇²u = ∂xᶠ(∂xᶜ u) + ∂yᶜ(∂yᶠ u)   (u at (f,c))
    y-face field  v: ∇²v = ∂xᶜ(∂xᶠ v) + ∂yᶠ(∂yᶜ v)   (v at (c,f))

On a bounded axis the inner difference is an array of its own, shifted
(clamped at the walls) by the outer one.
"""

from __future__ import annotations

import dataclasses

from .. import operators as op


def laplacian_u(u, grid):
    return op.ddx_f(op.ddx_c(u, grid), grid) + op.ddy_c(op.ddy_f(u, grid), grid)


def laplacian_v(v, grid):
    return op.ddx_c(op.ddx_f(v, grid), grid) + op.ddy_f(op.ddy_c(v, grid), grid)


def laplacian_c(c, grid):
    return op.ddx_c(op.ddx_f(c, grid), grid) + op.ddy_c(op.ddy_f(c, grid), grid)


@dataclasses.dataclass(frozen=True)
class LaplacianDiffusion:
    """ν∇² on momentum, κ∇² on the tracer."""
    nu: float = 0.0
    kappa: float = 0.0
    halo = 1

    def tendency_u(self, u, grid):
        return self.nu * laplacian_u(u, grid)

    def tendency_v(self, v, grid):
        return self.nu * laplacian_v(v, grid)

    def tendency_c(self, c, grid):
        return self.kappa * laplacian_c(c, grid)


@dataclasses.dataclass(frozen=True)
class BiharmonicDiffusion:
    """−ν∇⁴ on momentum, −κ∇⁴ on the tracer."""
    nu: float = 0.0
    kappa: float = 0.0
    halo = 2

    def tendency_u(self, u, grid):
        return -self.nu * laplacian_u(laplacian_u(u, grid), grid)

    def tendency_v(self, v, grid):
        return -self.nu * laplacian_v(laplacian_v(v, grid), grid)

    def tendency_c(self, c, grid):
        return -self.kappa * laplacian_c(laplacian_c(c, grid), grid)
