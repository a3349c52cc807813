"""The plain emulation of the conservative substage kernel's tiling
(``csrc/cons_tile.cuh``): :func:`substage_tiles_reference`.

As :mod:`.vi_tile` does for the vector-invariant kernel, this computes one
``(TX, TY)`` tile of the unpadded output at a time from its own state
windows (4 cells before the tile and 3 after it on each axis), with the
kernel's index maps, regions, phases and order of operations: the tracer
fluxes, then Gh and GA; u, v and the momentum fluxes, then Gu and Gv
without the Lorentz force; hBx, hBy, Bx, By and the Lorentz fluxes, then
the rest of Gu and Gv. Each intermediate exists only in the region the
kernel computes it over, with NaN elsewhere and past the walls, so a read
outside the regions would show in G; a read past a wall goes to the wall
point's slot.

Held to :func:`~swmhd_tpu_torch.ops.substage.substage_reference` and to
the JAX package by ``tests/test_torch_cons_tile.py``; the host build of
``csrc/cons_tile.cuh`` matches it bit for bit
(``tests/test_torch_cons_tile_host.py``).
"""

from __future__ import annotations

import torch

from ..models.shallow_water import CONSERVATIVE
from .substage import BOUNDED_AXIS, TILE_LAYOUTS, TILE_X, TILE_Y
from .vi_tile import (A, BIHARMONIC, CENTERED2, LAPLACIAN, H, U, V, Box,
                      _face_pair, _upwind, _upwind3_pair, region,
                      tiles_reference)

LO, HI = TILE_LAYOUTS[CONSERVATIVE][:2]


def _center_pair(scheme, c, c_i, q, n, wall):
    """substage.cuh center_pair: the face form at the next face ``q``, or
    Centered2's mean of the window's c[3] and the value ``c_i`` at the
    center itself."""
    if scheme == CENTERED2:
        v = 0.5 * (c[3] + c_i)
        return v, v
    return _face_pair(scheme, c, q, n, wall)


def _tile(s, p, X, Y, TX, TY):
    """(G of the tile's TX × TY points, as (4, TX, TY), masked)."""
    box = Box(s, p, X, Y, TX, TY, LO, HI)
    st, at, new, laplacian = box.st, box.at, box.new, box.laplacian
    state, of, rdx, rdy = box.state, box.of, box.rdx, box.rdy
    one = torch.ones((), dtype=s.dtype)
    raz = one / torch.tensor(p.dx * p.dy, dtype=s.dtype)
    WX, WY = X.mode == BOUNDED_AXIS, Y.mode == BOUNDED_AXIS
    NX, NY = X.n, Y.n
    zero = torch.zeros((), dtype=s.dtype)

    def last(a, b):
        return (X.g(a) == NX - 1) & WX, (Y.g(b) == NY - 1) & WY

    # phase 1: mass and tracer
    a, b = region(0, TX + 1, 0, TY + 1)
    l, r = _face_pair(p.tracer, [st(A, X.sh(a, k - 3), b) for k in range(6)],
                      X.g(a), NX, WX)
    Fx = new(a, b, _upwind(st(U, a, b), l, r))
    l, r = _face_pair(p.tracer, [st(A, a, Y.sh(b, k - 3)) for k in range(6)],
                      Y.g(b), NY, WY)
    Fy = new(a, b, _upwind(st(V, a, b), l, r))
    if p.closure == BIHARMONIC:
        a, b = region(-1, TX + 1, -1, TY + 1)
        LA = new(a, b, laplacian(state(A), a, b, False, False))

    a, b = region(0, TX, 0, TY)
    last_x, last_y = last(a, b)
    ap, bp = X.sh(a, 1), Y.sh(b, 1)
    h0, uh0, vh0 = st(H, a, b), st(U, a, b), st(V, a, b)
    vh_jp = st(V, a, bp)
    uh_up = torch.where(last_x, zero, st(U, ap, b))
    vh_up = torch.where(last_y, zero, vh_jp)
    divU = (uh_up - uh0) * rdx + (vh_up - vh0) * rdy
    Gh = -divU
    fx_up = torch.where(last_x, zero, at(Fx, ap, b))
    fy_up = torch.where(last_y, zero, at(Fy, a, bp))
    div_flux = (fx_up - at(Fx, a, b)) * rdx + (fy_up - at(Fy, a, b)) * rdy
    GA = (st(A, a, b) * divU - div_flux) / h0
    if p.gamma != 0:
        GA = GA - p.gamma * (0.5 * (vh_jp + vh0)) / h0
    if p.closure == LAPLACIAN:
        GA = GA + p.kappa * laplacian(state(A), a, b, False, False)
    elif p.closure == BIHARMONIC:
        GA = GA + (-p.kappa) * laplacian(of(LA), a, b, False, False)

    # phase 2: momentum
    a, b = region(-3, TX + 3, -3, TY + 3)
    h0_ = st(H, a, b)
    u = new(a, b, st(U, a, b) / (0.5 * (h0_ + st(H, X.sh(a, -1), b))))
    v = new(a, b, st(V, a, b) / (0.5 * (h0_ + st(H, a, Y.sh(b, -1)))))
    if p.closure == BIHARMONIC:
        a, b = region(-1, TX + 1, -1, TY + 1)
        Lu = new(a, b, laplacian(state(U), a, b, True, False))
        Lv = new(a, b, laplacian(state(V), a, b, False, True))
    # along x: Mxx at (c,c), Mxy at (f,f)
    a, b = region(-1, TX, 0, TY)
    ap = X.sh(a, 1)
    l, r = _center_pair(p.momentum, [at(u, X.sh2(a, 1, k - 3), b)
                                     for k in range(6)],
                        at(u, a, b), X.g(ap), NX, WX)
    Mxx = new(a, b, _upwind(0.5 * (st(U, ap, b) + st(U, a, b)), l, r))
    a, b = region(0, TX + 1, 0, TY)
    l, r = _face_pair(p.momentum, [at(v, X.sh(a, k - 3), b)
                                   for k in range(6)], X.g(a), NX, WX)
    Mxy = new(a, b, _upwind(0.5 * (st(U, a, b) + st(U, a, Y.sh(b, -1))),
                            l, r))
    # along y: Myx at (f,f), Myy at (c,c)
    a, b = region(0, TX, 0, TY + 1)
    l, r = _face_pair(p.momentum, [at(u, a, Y.sh(b, k - 3))
                                   for k in range(6)], Y.g(b), NY, WY)
    Myx = new(a, b, _upwind(0.5 * (st(V, a, b) + st(V, X.sh(a, -1), b)),
                            l, r))
    a, b = region(0, TX, -1, TY)
    bp = Y.sh(b, 1)
    l, r = _center_pair(p.momentum, [at(v, a, Y.sh2(b, 1, k - 3))
                                     for k in range(6)],
                        at(v, a, b), Y.g(bp), NY, WY)
    Myy = new(a, b, _upwind(0.5 * (st(V, a, bp) + st(V, a, b)), l, r))

    a, b = region(0, TX, 0, TY)
    last_x, last_y = last(a, b)
    am, ap, bm, bp = X.sh(a, -1), X.sh(a, 1), Y.sh(b, -1), Y.sh(b, 1)
    h_im, h_jm = st(H, am, b), st(H, a, bm)
    hfx, hfy = 0.5 * (h0 + h_im), 0.5 * (h0 + h_jm)
    myx_up = torch.where(last_y, zero, at(Myx, a, bp))
    mxy_up = torch.where(last_x, zero, at(Mxy, ap, b))
    Gu = -((at(Mxx, a, b) - at(Mxx, am, b)) * rdx
           + (myx_up - at(Myx, a, b)) * rdy)
    Gv = -((mxy_up - at(Mxy, a, b)) * rdx
           + (at(Myy, a, b) - at(Myy, a, bm)) * rdy)
    Gu = Gu - p.g * hfx * ((h0 - h_im) * rdx)
    Gv = Gv - p.g * hfy * ((h0 - h_jm) * rdy)
    vbar = 0.5 * (0.5 * (st(V, a, bp) + vh0)
                  + 0.5 * (st(V, am, bp) + st(V, am, b)))
    ubar = 0.5 * (0.5 * (st(U, ap, b) + st(U, ap, bm))
                  + 0.5 * (uh0 + st(U, a, bm)))
    Gu = Gu + p.f * vbar
    Gv = Gv + (-p.f) * ubar
    if p.closure == LAPLACIAN:
        Gu = Gu + p.nu * laplacian(state(U), a, b, True, False)
        Gv = Gv + p.nu * laplacian(state(V), a, b, False, True)
    elif p.closure == BIHARMONIC:
        Gu = Gu + (-p.nu) * laplacian(of(Lu), a, b, True, False)
        Gv = Gv + (-p.nu) * laplacian(of(Lv), a, b, False, True)

    # phase 3: the divergence-form Lorentz force
    a, b = region(-2, TX + 2, -2, TY + 2)
    am, ap, bm, bp = X.sh(a, -1), X.sh(a, 1), Y.sh(b, -1), Y.sh(b, 1)
    last_x, last_y = last(a, b)

    def iyc_dAdy(i):
        a0 = st(A, i, b)
        d = (a0 - st(A, i, bm)) * rdy + p.gamma
        d_jp = torch.where(last_y, d, (st(A, i, bp) - a0) * rdy + p.gamma)
        return 0.5 * (d_jp + d)

    def iyf_dAdx(i, im):
        return 0.5 * ((st(A, i, b) - st(A, im, b)) * rdx
                      + (st(A, i, bm) - st(A, im, bm)) * rdx)

    h0_ = st(H, a, b)
    hbx = -(0.5 * (iyc_dAdy(a) + iyc_dAdy(am)))
    P0 = iyf_dAdx(a, am)
    hby = 0.5 * (torch.where(last_x, P0, iyf_dAdx(ap, a)) + P0)
    hBx, hBy = new(a, b, hbx), new(a, b, hby)
    Bx = new(a, b, hbx / (0.5 * (h0_ + st(H, am, b))))
    By = new(a, b, hby / (0.5 * (h0_ + st(H, a, bm))))

    def window(box, idx):
        # UpwindBiased3 reads slots 1..4
        return [None] + [box(k) for k in idx] + [None]

    a, b = region(-1, TX, 0, TY)
    ap = X.sh(a, 1)
    l, r = _upwind3_pair(window(lambda k: at(Bx, X.sh2(a, 1, k - 3), b),
                                range(1, 5)), X.g(ap), NX, WX)
    Lxx = new(a, b, p.dy * _upwind(0.5 * (at(hBx, ap, b) + at(hBx, a, b)),
                                   l, r))
    a, b = region(0, TX + 1, 0, TY)
    l, r = _upwind3_pair(window(lambda k: at(By, X.sh(a, k - 3), b),
                                range(1, 5)), X.g(a), NX, WX)
    Lxy = new(a, b, p.dy * _upwind(0.5 * (at(hBx, a, b)
                                          + at(hBx, a, Y.sh(b, -1))), l, r))
    a, b = region(0, TX, 0, TY + 1)
    l, r = _upwind3_pair(window(lambda k: at(Bx, a, Y.sh(b, k - 3)),
                                range(1, 5)), Y.g(b), NY, WY)
    Lyx = new(a, b, p.dx * _upwind(0.5 * (at(hBy, a, b)
                                          + at(hBy, X.sh(a, -1), b)), l, r))
    a, b = region(0, TX, -1, TY)
    bp = Y.sh(b, 1)
    l, r = _upwind3_pair(window(lambda k: at(By, a, Y.sh2(b, 1, k - 3)),
                                range(1, 5)), Y.g(bp), NY, WY)
    Lyy = new(a, b, p.dx * _upwind(0.5 * (at(hBy, a, bp) + at(hBy, a, b)),
                                   l, r))

    a, b = region(0, TX, 0, TY)
    am, ap, bm, bp = X.sh(a, -1), X.sh(a, 1), Y.sh(b, -1), Y.sh(b, 1)
    Gu = Gu + ((at(Lxx, a, b) - at(Lxx, am, b))
               + (at(Lyx, a, bp) - at(Lyx, a, b))) * raz
    Gv = Gv + ((at(Lxy, ap, b) - at(Lxy, a, b))
               + (at(Lyy, a, b) - at(Lyy, a, bm))) * raz
    if WX:
        Gu = torch.where(X.g(a) == 0, zero, Gu)
    if WY:
        Gv = torch.where(Y.g(b) == 0, zero, Gv)
    return torch.stack([x.expand(TX, TY) for x in (Gh, Gu, Gv, GA)])


def substage_tiles_reference(model, s, dt, stage, g_prev=None, halo=(0, 0),
                             tile=(TILE_X[0], TILE_Y)):
    """Substage ``stage`` of the conservative model on stacked fields
    ``s`` (padded by ``halo`` on exchanged axes, as for
    :func:`~swmhd_tpu_torch.ops.substage.substage`) computed tile by tile
    as the kernel computes it: ``(s_new, G)``, unpadded. ``tile`` is the
    kernel's ``(TX, TY)``; the wrapper picks it by grid and card
    (:func:`~swmhd_tpu_torch.ops.substage.tile_shape`)."""
    substage_tiles_reference.calls += 1
    if model.formulation != CONSERVATIVE:
        raise ValueError("this emulates the conservative tile kernel; "
                         "ops.vi_tile emulates the vector-invariant one")
    return tiles_reference(_tile, model, s, dt, stage, g_prev, halo, tile)


substage_tiles_reference.calls = 0
