"""The plain emulation of the vector-invariant substage kernel's tiling
(``csrc/vi_tile.cuh``): :func:`substage_tiles_reference`.

The kernel computes one ``(TX, TY)`` tile of the unpadded output per
block. It stages the tile's state windows, 3 cells wider on every side
(``TILE_LAYOUTS``), computes the intermediates (the derived arrays of the
reference's tendency) over the regions of the box that the tile's points
read, then G and the Le–Moin update at the tile's points. This module does
the same in PyTorch, tile by tile, with the kernel's index maps and
regions and in the kernel's order of operations:

- a window slot holds the state at the wrapped (periodic), clamped
  (bounded) or padded-array (exchanged, clamped only at the array's end)
  index of its point;
- every read of a shifted array, state or derived, goes through the
  reference's index logic in box coordinates (:class:`Map`): on a bounded
  axis a shift past the wall reads the wall point's slot, and a shift of a
  shifted derived array clamps at each step. That is the edge replication
  of derived arrays, done by index, so the box needs no copies;
- each intermediate exists only in its region of the box; every other
  slot, and on a bounded axis every slot past a wall, holds NaN, so a read
  outside the regions would show in G.

Held to :func:`~swmhd_tpu_torch.ops.substage.substage_reference` and to
the JAX package by ``tests/test_torch_vi_tile.py``. A host build of
``csrc/vi_tile.cuh`` (g++ with stand-in CUDA headers, 256 threads a block
meeting at a barrier, shared memory filled with NaN) matches this
module's arithmetic bit for bit: ``tests/test_torch_vi_tile_host.py``.
The pieces that do not depend on the formulation (:class:`Map`,
:class:`Box`, the reconstructions, :func:`tiles_reference`) serve the
conservative kernel's emulation too (:mod:`.cons_tile`).
"""

from __future__ import annotations

import math

import torch

from ..models.shallow_water import (RK3_GAMMA, RK3_ZETA, CONSERVATIVE,
                                    VECTOR_INVARIANT)
from .. import advection
from .substage import (BOUNDED_AXIS, EXCHANGED_AXIS, PERIODIC_AXIS,
                       TILE_LAYOUTS, TILE_X, TILE_Y, _crop, kernel_params)

R = TILE_LAYOUTS[VECTOR_INVARIANT].lo
WENO5, UPWIND3, CENTERED2 = 0, 1, 2          # csrc/substage.cuh Scheme
LAPLACIAN, BIHARMONIC = 1, 2                 # Closure
H, U, V, A = 0, 1, 2, 3


class Map:
    """The index map of one axis of a tile: local index ``a`` is the point
    ``i0 + a`` of an axis of ``n`` points (the padded extent on an
    exchanged axis) in ``mode``; ``sh`` and ``sh2`` are the reference's
    single and double shifts, as local indices."""

    def __init__(self, mode, i0, n):
        self.mode, self.i0, self.n = mode, i0, n

    def _clamp(self, x):
        return x.clamp(0, self.n - 1)

    def sh(self, a, m):
        if self.mode == PERIODIC_AXIS:
            return a + m
        return self._clamp(self.i0 + a + m) - self.i0

    def sh2(self, a, m, s):
        if self.mode == PERIODIC_AXIS:
            return a + m + s
        if self.mode == BOUNDED_AXIS:
            return self._clamp(self._clamp(self.i0 + a + m) + s) - self.i0
        return self._clamp(self.i0 + a + m + s) - self.i0

    def load(self, a):
        """The index of the array a window slot is loaded from: wrapped
        once (and clamped, for the slots of a ragged tile's far side that
        no point reads) or clamped."""
        x = self.i0 + a
        if self.mode == PERIODIC_AXIS:
            x = torch.where(x < 0, x + self.n, x)
            x = torch.where(x >= self.n, x - self.n, x)
            return x.clamp(max=self.n - 1)
        return self._clamp(x)

    def g(self, a):
        return self.i0 + a

    def outside(self, a):
        """Slots past a wall (a bounded axis only)."""
        if self.mode != BOUNDED_AXIS:
            return torch.zeros_like(a, dtype=torch.bool)
        x = self.i0 + a
        return (x < 0) | (x >= self.n)


# -- the reconstructions of csrc/substage.cuh, elementwise ---------------------

def _sq(x):
    return x * x


def _upwind(ut, l, r):
    return 0.5 * ((ut + ut.abs()) * l + (ut - ut.abs()) * r)


def _betas(cm3, cm2, cm1, c0, cp1):
    return ((13.0 / 12.0) * _sq(cm3 - 2 * cm2 + cm1)
            + 0.25 * _sq(cm3 - 4 * cm2 + 3 * cm1),
            (13.0 / 12.0) * _sq(cm2 - 2 * cm1 + c0) + 0.25 * _sq(cm2 - c0),
            (13.0 / 12.0) * _sq(cm1 - 2 * c0 + cp1)
            + 0.25 * _sq(3 * cm1 - 4 * c0 + cp1))


# the kernel's divisions by constants are products with their
# reciprocals: 1/6 here, 1/dx and 1/dy (rounded in the working type) below
SIXTH = 1.0 / 6.0


def _cands_left(cm3, cm2, cm1, c0, cp1):
    return ((2 * cm3 - 7 * cm2 + 11 * cm1) * SIXTH,
            (-cm2 + 5 * cm1 + 2 * c0) * SIXTH,
            (2 * cm1 + 5 * c0 - cp1) * SIXTH)


def _cands_right(cm2, cm1, c0, cp1, cp2):
    return ((2 * cp2 - 7 * cp1 + 11 * c0) * SIXTH,
            (-cp1 + 5 * c0 + 2 * cm1) * SIXTH,
            (2 * c0 + 5 * cm1 - cm2) * SIXTH)


_combine = advection._weno_combine


def _weno_pair(c):
    left = _combine(_cands_left(*c[:5]), _betas(*c[:5]))
    r = _betas(*c[1:])
    return left, _combine(_cands_right(*c[1:]), (r[2], r[1], r[0]))


def _upwind3_pair(c, q, n, wall):
    left = (2 * c[3] + 5 * c[2] - c[1]) * SIXTH
    right = (-c[4] + 5 * c[3] + 2 * c[2]) * SIXTH
    if wall:
        left = torch.where(q < 2, c[2], left)
        right = torch.where((q < 1) | (q > n - 2), c[3], right)
    return left, right


def _face_pair(scheme, c, q, n, wall):
    if scheme == CENTERED2:
        v = 0.5 * (c[3] + c[2])
        return v, v
    if scheme == UPWIND3:
        return _upwind3_pair(c, q, n, wall)
    left, right = _weno_pair(c)
    if wall:
        l3, r3 = _upwind3_pair(c, q, n, wall)
        left = torch.where((q < 3) | (q > n - 2), l3, left)
        right = torch.where((q < 2) | (q > n - 3), r3, right)
    return left, right


def _vorticity_pair(z, uf, vf, velocity, last):
    def keep(first, second):
        return tuple(torch.where(last, x, y) for x, y in zip(first, second))
    if velocity:
        ua, va = _betas(*uf[:5]), _betas(*vf[:5])
        ub = keep(ua, _betas(*uf[1:]))
        vb = keep(va, _betas(*vf[1:]))
        b = tuple(0.5 * (x + y) for x, y in zip(ua, va))
        r = tuple(0.5 * (x + y) for x, y in zip(ub, vb))
    else:
        b = _betas(*z[:5])
        r = keep(b, _betas(*z[1:]))
    return (_combine(_cands_left(*z[:5]), b),
            _combine(_cands_right(*z[1:]), (r[2], r[1], r[0])))


def _second_difference(rd, m, a, rd_, face):
    """As substage.cuh second_difference_by with the reciprocal spacing
    ``rd_``."""
    if face:
        im = m.sh(a, -1)
        return ((rd(m.sh(a, 1)) - rd(a)) * rd_
                - (rd(m.sh(im, 1)) - rd(im)) * rd_) * rd_
    ip = m.sh(a, 1)
    return ((rd(ip) - rd(m.sh(ip, -1))) * rd_
            - (rd(a) - rd(m.sh(a, -1))) * rd_) * rd_


# -- one tile ---------------------------------------------------------------------

def region(a0, a1, b0, b1):
    """The local points [a0, a1) × [b0, b1), as broadcasting indices."""
    return (torch.arange(a0, a1)[:, None], torch.arange(b0, b1)[None, :])


class Box:
    """The shared memory of one ``TX × TY`` tile of the stacked fields
    ``s`` under the maps ``X``, ``Y``, as the kernel lays it out: the four
    state windows and the box arrays over the local points ``[-lo, TX +
    hi) × [-lo, TY + hi)``; ``rdx``, ``rdy`` the reciprocal spacings
    rounded in the working type."""

    def __init__(self, s, p, X, Y, TX, TY, lo, hi):
        self.X, self.Y, self.lo = X, Y, lo
        self.shape = (TX + lo + hi, TY + lo + hi)
        self.new_full = s.new_full
        self.win = s[:, X.load(torch.arange(-lo, TX + hi))[:, None],
                     Y.load(torch.arange(-lo, TY + hi))[None, :]]
        one = torch.ones((), dtype=s.dtype)
        self.rdx = one / torch.tensor(p.dx, dtype=s.dtype)
        self.rdy = one / torch.tensor(p.dy, dtype=s.dtype)

    def st(self, k, a, b):
        """State field k at local (a, b)."""
        return self.win[k][a + self.lo, b + self.lo]

    def at(self, box, a, b):
        return box[a + self.lo, b + self.lo]

    def new(self, a, b, value):
        """A box array holding ``value`` over the region (a, b) and NaN
        elsewhere and past the walls."""
        nan = float("nan")
        box = self.new_full(self.shape, nan)
        value = torch.where(self.X.outside(a) | self.Y.outside(b), nan,
                            value)
        box[a + self.lo, b + self.lo] = value.expand(a.shape[0], b.shape[1])
        return box

    def laplacian(self, rd2, a, b, fx, fy):
        """∇² at (a, b) of ``rd2(a, b)``; fx, fy: on faces along x, y."""
        return (_second_difference(lambda k: rd2(k, b), self.X, a, self.rdx,
                                   fx)
                + _second_difference(lambda k: rd2(a, k), self.Y, b,
                                     self.rdy, fy))

    def state(self, k):
        return lambda a, b: self.st(k, a, b)

    def of(self, box):
        return lambda a, b: self.at(box, a, b)


def _tile(s, p, X, Y, TX, TY):
    """(G of the tile's TX × TY points, as (4, TX, TY), masked)."""
    box = Box(s, p, X, Y, TX, TY, R, R)
    st, at, new_box, laplacian = box.st, box.at, box.new, box.laplacian
    state, of, rdx, rdy = box.state, box.of, box.rdx, box.rdy
    WX, WY = X.mode == BOUNDED_AXIS, Y.mode == BOUNDED_AXIS
    NX, NY = X.n, Y.n

    # phase 1: mass and tracer, one region
    a, b = region(0, TX + 1, 0, TY + 1)
    l, r = _face_pair(p.mass, [st(H, X.sh(a, k - 3), b) for k in range(6)],
                      X.g(a), NX, WX)
    Uf_v = _upwind(st(U, a, b), l, r)
    l, r = _face_pair(p.tracer, [st(A, X.sh(a, k - 3), b)
                                 for k in range(6)], X.g(a), NX, WX)
    Uf, Fx = new_box(a, b, Uf_v), new_box(a, b, _upwind(Uf_v, l, r))
    l, r = _face_pair(p.mass, [st(H, a, Y.sh(b, k - 3)) for k in range(6)],
                      Y.g(b), NY, WY)
    Vf_v = _upwind(st(V, a, b), l, r)
    l, r = _face_pair(p.tracer, [st(A, a, Y.sh(b, k - 3))
                                 for k in range(6)], Y.g(b), NY, WY)
    Vf, Fy = new_box(a, b, Vf_v), new_box(a, b, _upwind(Vf_v, l, r))
    if p.closure == BIHARMONIC:
        a, b = region(-1, TX + 1, -1, TY + 1)
        LA = new_box(a, b, laplacian(state(A), a, b, False, False))

    a, b = region(0, TX, 0, TY)
    last_x = (X.g(a) == NX - 1) & WX
    last_y = (Y.g(b) == NY - 1) & WY
    zero = torch.zeros((), dtype=s.dtype)
    h0 = st(H, a, b)
    Vf0, Vf_jp = at(Vf, a, b), at(Vf, a, Y.sh(b, 1))
    Uf_up = torch.where(last_x, zero, at(Uf, X.sh(a, 1), b))
    Vf_up = torch.where(last_y, zero, Vf_jp)
    divU = (Uf_up - at(Uf, a, b)) * rdx + (Vf_up - Vf0) * rdy
    Gh = -divU
    fx_up = torch.where(last_x, zero, at(Fx, X.sh(a, 1), b))
    fy_up = torch.where(last_y, zero, at(Fy, a, Y.sh(b, 1)))
    div_flux = (fx_up - at(Fx, a, b)) * rdx + (fy_up - at(Fy, a, b)) * rdy
    GA = (st(A, a, b) * divU - div_flux) / h0
    if p.gamma != 0:
        GA = GA - p.gamma * (0.5 * (Vf_jp + Vf0)) / h0
    if p.closure == LAPLACIAN:
        GA = GA + p.kappa * laplacian(state(A), a, b, False, False)
    elif p.closure == BIHARMONIC:
        GA = GA + (-p.kappa) * laplacian(of(LA), a, b, False, False)

    # phase 2: momentum
    a, b = region(-2, TX + 3, -2, TY + 3)
    u0, v0 = st(U, a, b), st(V, a, b)
    u_jm, v_im = st(U, a, Y.sh(b, -1)), st(V, X.sh(a, -1), b)
    zeta = new_box(a, b, (v0 - v_im) * rdx - (u0 - u_jm) * rdy)
    uff = new_box(a, b, 0.5 * (u0 + u_jm))
    vff = new_box(a, b, 0.5 * (v0 + v_im))
    # K + gh, ∂xA, ∂yA + γ, B (and ∇²u, ∇²v), one region
    a, b = region(-1, TX + 1, -1, TY + 1)
    u0, v0 = st(U, a, b), st(V, a, b)
    u_ip, v_jp = st(U, X.sh(a, 1), b), st(V, a, Y.sh(b, 1))
    K = 0.5 * (0.5 * (u_ip * u_ip + u0 * u0) + 0.5 * (v_jp * v_jp + v0 * v0))
    h0_, A0 = st(H, a, b), st(A, a, b)
    KB = new_box(a, b, K + p.g * h0_)
    dx0 = (A0 - st(A, X.sh(a, -1), b)) * rdx
    dy0 = (A0 - st(A, a, Y.sh(b, -1))) * rdy + p.gamma
    dAdx, dAdy = new_box(a, b, dx0), new_box(a, b, dy0)
    dy1 = torch.where((Y.g(b) == NY - 1) & WY, dy0,
                      (st(A, a, Y.sh(b, 1)) - A0) * rdy + p.gamma)
    Bx = new_box(a, b, -(0.5 * (dy1 + dy0)) / h0_)
    dx1 = torch.where((X.g(a) == NX - 1) & WX, dx0,
                      (st(A, X.sh(a, 1), b) - A0) * rdx)
    By = new_box(a, b, 0.5 * (dx1 + dx0) / h0_)
    if p.closure == BIHARMONIC:
        Lu = new_box(a, b, laplacian(state(U), a, b, True, False))
        Lv = new_box(a, b, laplacian(state(V), a, b, False, True))

    a, b = region(0, TX, 0, TY)
    am, ap, bm, bp = X.sh(a, -1), X.sh(a, 1), Y.sh(b, -1), Y.sh(b, 1)
    v_hat = 0.5 * (0.5 * (st(V, a, bp) + st(V, a, b))
                   + 0.5 * (st(V, am, bp) + st(V, am, b)))
    u_hat = 0.5 * (at(uff, ap, b) + at(uff, a, b))
    if p.momentum == CENTERED2:
        vort_u = 0.5 * (at(zeta, a, bp) * at(vff, a, bp)
                        + at(zeta, a, b) * at(vff, a, b))
        vort_v = -(0.5 * (at(zeta, ap, b) * at(uff, ap, b)
                          + at(zeta, a, b) * at(uff, a, b)))
    else:
        boxes = (zeta, uff, vff)
        zl, zr = _vorticity_recon(p, lambda t, q: at(boxes[t], a, q), Y, b,
                                  WY)
        vort_u = _upwind(v_hat, zl, zr)
        zl, zr = _vorticity_recon(p, lambda t, q: at(boxes[t], q, b), X, a,
                                  WX)
        vort_v = -_upwind(u_hat, zl, zr)
    KB0 = at(KB, a, b)
    Gu = vort_u - (KB0 - at(KB, am, b)) * rdx
    Gv = vort_v - (KB0 - at(KB, a, bm)) * rdy
    Gu = Gu + p.f * v_hat
    Gv = Gv + (-p.f) * u_hat
    if p.closure == LAPLACIAN:
        Gu = Gu + p.nu * laplacian(state(U), a, b, True, False)
        Gv = Gv + p.nu * laplacian(state(V), a, b, False, True)
    elif p.closure == BIHARMONIC:
        Gu = Gu + (-p.nu) * laplacian(of(Lu), a, b, True, False)
        Gv = Gv + (-p.nu) * laplacian(of(Lv), a, b, False, True)

    # jacobian Lorentz force; ∂yᶠBx at j+1 and ∂xᶠBy at i+1 clamped
    Bx0, Bx_im = at(Bx, a, b), at(Bx, am, b)
    dyBx = (Bx0 - at(Bx, a, bm)) * rdy
    dyBx_jp = torch.where(last_y, dyBx, (at(Bx, a, bp) - Bx0) * rdy)
    dyBx_c = 0.5 * (dyBx_jp + dyBx)
    dyBx_im = (Bx_im - at(Bx, am, bm)) * rdy
    dyBx_imjp = torch.where(last_y, dyBx_im, (at(Bx, am, bp) - Bx_im) * rdy)
    dyBx_m = 0.5 * (dyBx_imjp + dyBx_im)
    dAdy0 = at(dAdy, a, b)
    iDAdy = 0.5 * (0.5 * (at(dAdy, a, bp) + dAdy0)
                   + 0.5 * (at(dAdy, am, bp) + at(dAdy, am, b)))
    dAdx0 = at(dAdx, a, b)
    jac_x = (dAdx0 * (0.5 * (dyBx_c + dyBx_m))
             - iDAdy * ((Bx0 - Bx_im) * rdx))
    By0, By_jm = at(By, a, b), at(By, a, bm)
    dxBy_c = 0.5 * ((By0 - at(By, am, b)) * rdx
                    + (By_jm - at(By, am, bm)) * rdx)
    dxBy_p = torch.where(last_x, dxBy_c,
                         0.5 * ((at(By, ap, b) - By0) * rdx
                                + (at(By, ap, bm) - By_jm) * rdx))
    iDAdx = 0.5 * (0.5 * (at(dAdx, ap, b) + at(dAdx, ap, bm))
                   + 0.5 * (dAdx0 + at(dAdx, a, bm)))
    jac_y = iDAdx * ((By0 - By_jm) * rdy) - dAdy0 * (0.5 * (dxBy_p + dxBy_c))
    Gu = Gu + jac_x / (0.5 * (h0 + st(H, am, b)))
    Gv = Gv + jac_y / (0.5 * (h0 + st(H, a, bm)))
    if WX:
        Gu = torch.where(X.g(a) == 0, zero, Gu)
    if WY:
        Gv = torch.where(Y.g(b) == 0, zero, Gv)
    return torch.stack([x.expand(TX, TY) for x in (Gh, Gu, Gv, GA)])


def _vorticity_recon(p, load, m, q, wall):
    """(left, right) of ζ on the flux point along the axis of map ``m``
    at local indices ``q``; ``load(t, qq)`` reads box ``t`` (ζ, ℑu, ℑv)
    at local indices ``qq`` along that axis."""
    if p.momentum == WENO5:
        qq = [m.sh2(q, k - 3, 1) for k in range(6)]
        velocity = p.stencil == 0
        z = [load(0, x) for x in qq]
        uw = [load(1, x) for x in qq] if velocity else None
        vw = [load(2, x) for x in qq] if velocity else None
        last = (m.g(q) == m.n - 1) & wall
        return _vorticity_pair(z, uw, vw, velocity, last)
    z = [load(0, m.sh2(q, 1, k - 3)) for k in range(6)]
    return _upwind3_pair(z, m.g(m.sh(q, 1)), m.n, wall)


def tiles_reference(tile_of, model, s, dt, stage, g_prev, halo, tile):
    """Substage ``stage`` of ``model`` on stacked fields ``s`` (padded by
    ``halo`` on exchanged axes, as for
    :func:`~swmhd_tpu_torch.ops.substage.substage`), G computed tile by
    tile by ``tile_of(s, params, X, Y, TX, TY)`` on the ``(TX, TY)`` tiles
    of ``tile``: ``(s_new, G)``, unpadded."""
    p = kernel_params(model)
    hx, hy = halo
    NX, NY = s.shape[1:]
    mx, my = NX - 2 * hx, NY - 2 * hy
    modes = (EXCHANGED_AXIS if hx else p.wall_x,
             EXCHANGED_AXIS if hy else p.wall_y)
    TX, TY = tile
    G = s.new_empty((4, mx, my))
    for ti in range(math.ceil(mx / TX)):
        for tj in range(math.ceil(my / TY)):
            x0, y0 = ti * TX, tj * TY
            ex, ey = min(TX, mx - x0), min(TY, my - y0)
            g = tile_of(s, p, Map(modes[0], hx + x0, NX),
                        Map(modes[1], hy + y0, NY), TX, TY)
            G[:, x0:x0 + ex, y0:y0 + ey] = g[:, :ex, :ey]
    inc = RK3_GAMMA[stage] * G
    if g_prev is not None:
        inc = inc + RK3_ZETA[stage] * g_prev
    return _crop(s, halo) + dt * inc, G


def substage_tiles_reference(model, s, dt, stage, g_prev=None, halo=(0, 0),
                             tile=(TILE_X[0], TILE_Y)):
    """Substage ``stage`` of the vector-invariant model on stacked fields
    ``s`` (padded by ``halo`` on exchanged axes, as for
    :func:`~swmhd_tpu_torch.ops.substage.substage`) computed tile by tile
    as the kernel computes it: ``(s_new, G)``, unpadded. ``tile`` is the
    kernel's ``(TX, TY)``; the wrapper picks it by grid and card
    (:func:`~swmhd_tpu_torch.ops.substage.tile_shape`). The conservative
    formulation's is :func:`.cons_tile.substage_tiles_reference`."""
    substage_tiles_reference.calls += 1
    if model.formulation == CONSERVATIVE:
        raise ValueError("this emulates the vector-invariant tile kernel; "
                         "ops.cons_tile emulates the conservative one")
    return tiles_reference(_tile, model, s, dt, stage, g_prev, halo, tile)


substage_tiles_reference.calls = 0
