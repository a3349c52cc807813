"""Advection schemes, port of the shipped flavor of :mod:`swmhd_tpu.advection`.

WENO5 uses WENO-Z weights (Borges et al. 2008) in the divide-free
rational form, eps = 1e-8, linear weights γ = (0.1, 0.6, 0.3), and
left/right pairs that share their smoothness indicators. Centered2 and
UpwindBiased3 come along with the near-wall degradation of BOUNDED axes:
within two (third order) or three (WENO) cells of a wall the
reconstruction falls back to the next lower order, then to first order.

A reconstruction "at faces" gives at index i the value at face i (left
edge of cell i) from center values; "at centers" gives the value at
center i from face values, the face form shifted by one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .grid import BOUNDED
from . import operators as op

WENO_EPS = 1e-8
WENO_GAMMA = (0.1, 0.6, 0.3)


def upwind_biased_product(u_t, pl_, pr):
    """((ũ+|ũ|)ψᴸ + (ũ−|ũ|)ψᴿ)/2, kept branch-free so its roundoff is
    the same wherever it is evaluated."""
    return 0.5 * ((u_t + torch.abs(u_t)) * pl_ + (u_t - torch.abs(u_t)) * pr)


def _sq(x):
    return x * x


# -- third-order biased ------------------------------------------------------------

def _left3(c, sh):
    # (2 c[i] + 5 c[i-1] - c[i-2]) / 6 at face i
    return (2.0 * c + 5.0 * sh(c, -1) - sh(c, -2)) / 6.0


def _right3(c, sh):
    # (-c[i+1] + 5 c[i] + 2 c[i-1]) / 6 at face i
    return (-sh(c, 1) + 5.0 * c + 2.0 * sh(c, -1)) / 6.0


def _sh_x(grid):
    return lambda a, n: op.shift_x(a, n, grid)


def _sh_y(grid):
    return lambda a, n: op.shift_y(a, n, grid)


def left3_x_f(c, grid):
    return _degrade_x_f(_left3(c, _sh_x(grid)), c, grid, left=True)


def right3_x_f(c, grid):
    return _degrade_x_f(_right3(c, _sh_x(grid)), c, grid, left=False)


def left3_y_f(c, grid):
    return _degrade_y_f(_left3(c, _sh_y(grid)), c, grid, left=True)


def right3_y_f(c, grid):
    return _degrade_y_f(_right3(c, _sh_y(grid)), c, grid, left=False)


def left3_x_c(u, grid):
    """At center i from faces: the face form at i+1, as a shift of the
    reconstructed array (under a clamped wall this differs from a window
    offset by one)."""
    return op.shift_x(left3_x_f(u, grid), 1, grid)


def right3_x_c(u, grid):
    return op.shift_x(right3_x_f(u, grid), 1, grid)


def left3_y_c(v, grid):
    return op.shift_y(left3_y_f(v, grid), 1, grid)


def right3_y_c(v, grid):
    return op.shift_y(right3_y_f(v, grid), 1, grid)


def _degrade(r3, i, N, first, left):
    if left:
        r = torch.where(i < 2, first, r3)
        return torch.where(i > N - 1, first, r)
    r = torch.where(i < 1, first, r3)
    return torch.where(i > N - 2, first, r)


def _degrade_x_f(r3, c, grid, left):
    """Near-wall degradation on a BOUNDED x axis."""
    if grid.topology_x != BOUNDED:
        return r3
    first = op.shift_x(c, -1, grid) if left else c
    return _degrade(r3, op.global_index_x(c), op.global_nx(grid), first, left)


def _degrade_y_f(r3, c, grid, left):
    if grid.topology_y != BOUNDED:
        return r3
    first = op.shift_y(c, -1, grid) if left else c
    return _degrade(r3, op.global_index_y(c), op.global_ny(grid), first, left)


# -- WENO5 ------------------------------------------------------------------------

def _normalize_betas(b, eps):
    """Rescale (b0, b1, b2, eps) by about 1/(b0+b1+b2+eps): an exact
    no-op for the weights (degree-0 homogeneous in beta + eps) that keeps
    every float32 intermediate in the normal range at eps = 1e-8, where
    the products (beta + eps)^6 would otherwise underflow to 0/0 on a
    constant field.

    float32 uses the power of two 2^-e read off the exponent bits of the
    sum (exact scaling, no divide), with the subtracted exponent field
    clamped at 1 (2^-126) so a blown-up sum degrades the weights instead
    of zeroing betas and eps together."""
    s = b[0] + b[1] + b[2] + eps
    if s.dtype == torch.float32:
        bits = s.view(torch.int32)
        inv = torch.clamp(0x7F000000 - (bits & 0x7F800000),
                          min=0x00800000).to(torch.int32).view(torch.float32)
    else:
        inv = 1.0 / s
    return (b[0] * inv, b[1] * inv, b[2] * inv), eps * inv


def _weno_combine(ps, b):
    """WENO-Z weights, divide-free rational form; float64 skips the
    normalisation, exactly as the reference package does."""
    eps = WENO_EPS
    if b[0].dtype != torch.float64:
        b, eps = _normalize_betas(b, eps)
    tau2 = _sq(b[0] - b[2])
    q0 = _sq(b[0] + eps)
    q1 = _sq(b[1] + eps)
    q2 = _sq(b[2] + eps)
    a0 = WENO_GAMMA[0] * (q0 + tau2) * (q1 * q2)
    a1 = WENO_GAMMA[1] * (q1 + tau2) * (q0 * q2)
    a2 = WENO_GAMMA[2] * (q2 + tau2) * (q0 * q1)
    return (a0 * ps[0] + a1 * ps[1] + a2 * ps[2]) / (a0 + a1 + a2)


def weno_betas_left(c, sh):
    """Smoothness indicators of the left stencil at face i."""
    cm3, cm2, cm1 = sh(c, -3), sh(c, -2), sh(c, -1)
    c0, cp1 = c, sh(c, 1)
    b0 = (13.0 / 12.0) * _sq(cm3 - 2 * cm2 + cm1) + 0.25 * _sq(cm3 - 4 * cm2 + 3 * cm1)
    b1 = (13.0 / 12.0) * _sq(cm2 - 2 * cm1 + c0) + 0.25 * _sq(cm2 - c0)
    b2 = (13.0 / 12.0) * _sq(cm1 - 2 * c0 + cp1) + 0.25 * _sq(3 * cm1 - 4 * c0 + cp1)
    return (b0, b1, b2)


def shift_betas_left_to_right(bl, sh):
    """β_r,k(i) = β_l,2-k(i+1): the right stencils are the left ones of
    the next face, mirrored."""
    return (sh(bl[2], 1), sh(bl[1], 1), sh(bl[0], 1))


def weno_candidates_left(c, sh):
    cm3, cm2, cm1 = sh(c, -3), sh(c, -2), sh(c, -1)
    c0, cp1 = c, sh(c, 1)
    p0 = (2.0 * cm3 - 7.0 * cm2 + 11.0 * cm1) / 6.0
    p1 = (-cm2 + 5.0 * cm1 + 2.0 * c0) / 6.0
    p2 = (2.0 * cm1 + 5.0 * c0 - cp1) / 6.0
    return (p0, p1, p2)


def weno_candidates_right(c, sh):
    cm2, cm1 = sh(c, -2), sh(c, -1)
    c0, cp1, cp2 = c, sh(c, 1), sh(c, 2)
    p0 = (2.0 * cp2 - 7.0 * cp1 + 11.0 * c0) / 6.0
    p1 = (-cp1 + 5.0 * c0 + 2.0 * cm1) / 6.0
    p2 = (2.0 * c0 + 5.0 * cm1 - cm2) / 6.0
    return (p0, p1, p2)


def _weno5_pair(c, sh):
    """(left, right) WENO5 values at face i, sharing the betas."""
    bl = weno_betas_left(c, sh)
    left = _weno_combine(weno_candidates_left(c, sh), bl)
    right = _weno_combine(weno_candidates_right(c, sh),
                          shift_betas_left_to_right(bl, sh))
    return left, right


def _degrade_weno(r5, i, N, r3, left):
    if left:
        return torch.where((i < 3) | (i > N - 2), r3, r5)
    return torch.where((i < 2) | (i > N - 3), r3, r5)


def weno5_pair_x_f(c, grid):
    l, r = _weno5_pair(c, _sh_x(grid))
    if grid.topology_x != BOUNDED:
        return l, r
    i, N = op.global_index_x(c), op.global_nx(grid)
    return (_degrade_weno(l, i, N, left3_x_f(c, grid), True),
            _degrade_weno(r, i, N, right3_x_f(c, grid), False))


def weno5_pair_y_f(c, grid):
    l, r = _weno5_pair(c, _sh_y(grid))
    if grid.topology_y != BOUNDED:
        return l, r
    j, N = op.global_index_y(c), op.global_ny(grid)
    return (_degrade_weno(l, j, N, left3_y_f(c, grid), True),
            _degrade_weno(r, j, N, right3_y_f(c, grid), False))


def weno5_pair_x_c(u, grid):
    l, r = weno5_pair_x_f(u, grid)
    return op.shift_x(l, 1, grid), op.shift_x(r, 1, grid)


def weno5_pair_y_c(v, grid):
    l, r = weno5_pair_y_f(v, grid)
    return op.shift_y(l, 1, grid), op.shift_y(r, 1, grid)


# -- scheme objects ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdvectionScheme:
    """(left, right) reconstructions of a center field at x- and y-faces
    (``both_*_f``) and of a face field at centers (``both_*_c``).
    ``halo`` is the stencil half-width."""
    name: str
    halo: int
    both_x_f: Callable
    both_y_f: Callable
    both_x_c: Callable
    both_y_c: Callable


def _same(interp):
    def both(c, grid):
        v = interp(c, grid)
        return v, v
    return both


def _pair(left, right):
    return lambda c, grid: (left(c, grid), right(c, grid))


Centered2 = AdvectionScheme("centered2", 1, _same(op.ix_f), _same(op.iy_f),
                            _same(op.ix_c), _same(op.iy_c))
UpwindBiased3 = AdvectionScheme("upwind3", 2, _pair(left3_x_f, right3_x_f),
                                _pair(left3_y_f, right3_y_f),
                                _pair(left3_x_c, right3_x_c),
                                _pair(left3_y_c, right3_y_c))
WENO5 = AdvectionScheme("weno5", 3, weno5_pair_x_f, weno5_pair_y_f,
                        weno5_pair_x_c, weno5_pair_y_c)

SCHEMES = {s.name: s for s in (Centered2, UpwindBiased3, WENO5)}


def get_scheme(name_or_scheme):
    if isinstance(name_or_scheme, AdvectionScheme):
        return name_or_scheme
    return SCHEMES[str(name_or_scheme).lower()]
