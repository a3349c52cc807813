"""Shallow-water MHD model in both formulations, port of
:mod:`swmhd_tpu.models.shallow_water`.

vector-invariant (prognostics u, v, h):

    ∂t u = +⟨ζ v⟩ᵘᵖ + f v̄ − ∂x(K + g h) + F_u
    ∂t v = −⟨ζ u⟩ᵘᵖ − f ū − ∂y(K + g h) + F_v
    ∂t h = −∇·(u h̃)                (h̃ reconstructed by mass_advection)

conservative (prognostics uh, vh, h, stored in ``state.u``/``state.v``):

    ∂t uh = −∇·(uh ⊗ ũ) + f v̄h − g h̄ ∂x h + F_uh
    ∂t vh = −∇·(vh ⊗ ṽ) − f ūh − g h̄ ∂y h + F_vh
    ∂t h  = −∇·(uh, vh)

tracer (both), with U the mass transport:

    ∂t A = ( A ∇·U − ∇·(U Ã) ) / h

plus, with a closure, ν∇²(u, v) (or of uh, vh) and κ∇²A, or −ν∇⁴ and
−κ∇⁴ (:mod:`~swmhd_tpu_torch.physics.diffusion`), added after Coriolis
and the tracer and before the forcing.

The vector-invariant vorticity flux follows the momentum scheme. WENO5
upwinds ζ at (f,f) reconstructed transverse to each momentum component
with WENO5 candidates; its nonlinear weights come from the averaged
smoothness of u and v interpolated to (f,f) (VelocityStencil, the
default) or from ζ itself (VorticityStencil). UpwindBiased3 upwinds its
third-order reconstructions of ζ; Centered2 is the centered form
ℑy[ζ ℑx v], −ℑx[ζ ℑy u]. The conservative momentum flux upwinds the
scheme's reconstructions of u = uh/ℑh and v = vh/ℑh on symmetric
transports. Time stepping is the Le–Moin low-storage RK3.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

from ..grid import Grid, BOUNDED
from .. import operators as op
from ..advection import (
    AdvectionScheme, WENO5, get_scheme, upwind_biased_product,
    weno_candidates_left, weno_candidates_right, weno_betas_left,
    shift_betas_left_to_right, _weno_combine,
)
from ..physics.coriolis import FPlane
from .state import Clock, State

VECTOR_INVARIANT = "vector_invariant"
CONSERVATIVE = "conservative"

# weights of the WENO5 vorticity flux: from the velocities or from ζ
VELOCITY_STENCIL = "velocity"
VORTICITY_STENCIL = "vorticity"
DEFAULT_STENCIL = VELOCITY_STENCIL

# Le & Moin (1991) low-storage RK3 (Oceananigans' :RungeKutta3).
RK3_GAMMA = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETA = (0.0, -17.0 / 60.0, -5.0 / 12.0)


@dataclasses.dataclass(frozen=True)
class ShallowWaterModel:
    grid: Grid
    formulation: str = VECTOR_INVARIANT
    gravitational_acceleration: float = 9.81
    coriolis: FPlane = FPlane(0.0)
    momentum_advection: AdvectionScheme = WENO5
    mass_advection: AdvectionScheme = WENO5
    tracer_advection: AdvectionScheme = WENO5
    vector_invariant_stencil: str = DEFAULT_STENCIL
    closure: object = None            # LaplacianDiffusion / BiharmonicDiffusion
    forcing: tuple = ()               # ((name, fn), ...) name in u,v,uh,vh,h,A
    # Static linear background γ·y of A: state.A is the perturbation and
    # the tracer tendency gains the discrete source −γ·ℑyᶜ(Vf)/h.
    A_background_gradient_y: float = 0.0

    def __post_init__(self):
        if self.formulation not in (VECTOR_INVARIANT, CONSERVATIVE):
            raise ValueError(f"unknown formulation {self.formulation!r}")
        if self.vector_invariant_stencil not in (VELOCITY_STENCIL,
                                                 VORTICITY_STENCIL):
            raise ValueError(f"unknown vector_invariant_stencil "
                             f"{self.vector_invariant_stencil!r}")
        for name in ("momentum_advection", "mass_advection",
                     "tracer_advection"):
            object.__setattr__(self, name, get_scheme(getattr(self, name)))
        if isinstance(self.forcing, Mapping):
            object.__setattr__(self, "forcing", tuple(self.forcing.items()))

    # -- halo widths ------------------------------------------------------------

    @property
    def halo(self) -> int:
        """Widest single-operator stencil half-width (WENO5: 3; 2 for the
        Lorentz chains; twice the closure's, whose operator composes two
        differences)."""
        h = max(self.momentum_advection.halo, self.mass_advection.halo,
                self.tracer_advection.halo, 2)
        if self.closure is not None:
            h = max(h, 2 * self.closure.halo)
        return h

    @property
    def exchange_halo(self) -> int:
        """Composed stencil radius of one tendency evaluation, the halo a
        tile of a domain decomposition exchanges per substage: a
        reconstruction (radius ``halo``) feeds a flux divergence (+1)
        whose transport is itself reconstructed (+1 shift of another
        reconstruction), and the Lorentz chains compose to at most 4."""
        return self.halo + 3

    # -- construction ---------------------------------------------------------

    def initial_state(self, u=None, v=None, h=None, A=None,
                      uh=None, vh=None) -> State:
        """Each entry is a callable ``fn(x, y)`` evaluated on its staggered
        mesh, a tensor, or a scalar (the ``set!`` analog). The
        conservative formulation takes its transports as ``uh``/``vh``
        (or, failing those, ``u``/``v``) and stores them in ``state.u``,
        ``state.v``."""
        g = self.grid

        def ev(val, loc, default=0.0):
            if val is None:
                val = default
            if callable(val):
                return g.evaluate(val, loc)
            arr = torch.as_tensor(val, dtype=g.dtype, device=g.device)
            if arr.ndim == 0:
                return torch.full(g.shape, float(arr), dtype=g.dtype,
                                  device=g.device)
            return arr

        if self.formulation == CONSERVATIVE:
            u = uh if uh is not None else u
            v = vh if vh is not None else v
        u_arr, v_arr = self._mask_walls(ev(u, "fc"), ev(v, "cf"))
        return State(h=ev(h, "cc", 1.0), u=u_arr, v=v_arr, A=ev(A, "cc"))

    def velocities(self, state: State):
        """(u, v) physical velocities in either formulation."""
        if self.formulation == VECTOR_INVARIANT:
            return state.u, state.v
        g = self.grid
        return state.u / op.ix_f(state.h, g), state.v / op.iy_f(state.h, g)

    def transports(self, state: State):
        """(uh, vh) mass transports at faces in either formulation."""
        if self.formulation == CONSERVATIVE:
            return state.u, state.v
        g = self.grid
        return state.u * op.ix_f(state.h, g), state.v * op.iy_f(state.h, g)

    # -- tendencies -------------------------------------------------------------

    def tendencies(self, state: State) -> State:
        """G = ∂t(state) as a State (clock untouched)."""
        if self.formulation == VECTOR_INVARIANT:
            Gu, Gv, Gh, GA = self._tendencies_vector_invariant(state)
        else:
            Gu, Gv, Gh, GA = self._tendencies_conservative(state)
        Gu, Gv, Gh, GA = self._apply_forcing(state, Gu, Gv, Gh, GA)
        Gu, Gv = self._mask_walls(Gu, Gv)
        return State(h=Gh, u=Gu, v=Gv, A=GA, clock=state.clock)

    def _mask_walls(self, u_like, v_like):
        """No penetration: the wall-normal velocity (or its tendency) is
        zero on face 0 of a BOUNDED axis (the global face 0, see
        :class:`~swmhd_tpu_torch.operators.IndexContext`); the far wall
        face is not stored and its zero flux is enforced by the flux
        differences."""
        g = self.grid
        if g.topology_x == BOUNDED:
            u_like = torch.where(op.global_index_x(u_like) == 0, 0.0, u_like)
        if g.topology_y == BOUNDED:
            v_like = torch.where(op.global_index_y(v_like) == 0, 0.0, v_like)
        return u_like, v_like

    def _apply_forcing(self, state, Gu, Gv, Gh, GA):
        """Forcing keys name the prognostics: u, v (vector-invariant) or
        uh, vh (conservative), h and A."""
        umom, vmom = (("u", "v") if self.formulation == VECTOR_INVARIANT
                      else ("uh", "vh"))
        fields = {"h": state.h, "A": state.A, umom: state.u, vmom: state.v}
        for name, fn in self.forcing:
            names = name if isinstance(name, tuple) else (name,)
            contribs = fn(self.grid, state.clock, fields)
            if len(names) == 1:
                contribs = (contribs,)
            for nm, c in zip(names, contribs):
                if nm == umom:
                    Gu = Gu + c
                elif nm == vmom:
                    Gv = Gv + c
                elif nm == "h":
                    Gh = Gh + c
                elif nm == "A":
                    GA = GA + c
                else:
                    raise ValueError(f"forcing on unknown prognostic {nm!r}")
        return Gu, Gv, Gh, GA

    def _tendencies_vector_invariant(self, state):
        g = self.grid
        u, v, h, A = state.u, state.v, state.h, state.A
        gacc = self.gravitational_acceleration

        # mass flux with WENO5-reconstructed h
        ms = self.mass_advection
        Uf = upwind_biased_product(u, *ms.both_x_f(h, g))
        Vf = upwind_biased_product(v, *ms.both_y_f(h, g))
        divU = op.ddx_c_flux(Uf, g) + op.ddy_c_flux(Vf, g)
        Gh = -divU

        # vorticity flux + Bernoulli gradient
        zeta = op.vorticity_ff(u, v, g)
        vort_u, vort_v = self._vorticity_flux(u, v, zeta, g)
        K = op.kinetic_energy_cc(u, v, g)
        Gu = vort_u - op.ddx_f(K + gacc * h, g)
        Gv = vort_v - op.ddy_f(K + gacc * h, g)

        Gu = Gu + self.coriolis.tendency_u(v, g)
        Gv = Gv + self.coriolis.tendency_v(u, g)

        GA = self._tracer_tendency(A, h, Uf, Vf, divU)
        Gu, Gv, GA = self._add_closure(Gu, Gv, GA, u, v, A)
        return Gu, Gv, Gh, GA

    def _add_closure(self, Gu, Gv, GA, u, v, A):
        """Plus the closure's tendencies of the momentum prognostics (u, v
        or uh, vh) and the tracer."""
        c, g = self.closure, self.grid
        if c is None:
            return Gu, Gv, GA
        return (Gu + c.tendency_u(u, g), Gv + c.tendency_v(v, g),
                GA + c.tendency_c(A, g))

    def _vorticity_flux(self, u, v, zeta, g):
        """⟨ζ v⟩ᵘᵖ at (f,c) and −⟨ζ u⟩ᵘᵖ at (c,f)."""
        scheme = self.momentum_advection
        if scheme.name == "centered2":
            # centered form: ℑy[ζ · ℑx(v)], −ℑx[ζ · ℑy(u)]
            vort_u = op.iy_c(zeta * op.ix_f(v, g), g)
            vort_v = -op.ix_c(zeta * op.iy_f(u, g), g)
            return vort_u, vort_v
        if scheme.name == "weno5":
            return self._weno_vorticity_flux(u, v, zeta, g)
        # another biased scheme: ζ reconstructed transverse, upwinded on
        # the interpolated transverse velocity
        vort_u = upwind_biased_product(op.ixy_fc(v, g),
                                       *scheme.both_y_c(zeta, g))
        vort_v = -upwind_biased_product(op.ixy_cf(u, g),
                                        *scheme.both_x_c(zeta, g))
        return vort_u, vort_v

    def _weno_vorticity_flux(self, u, v, zeta, g):
        """⟨ζ v⟩ᵘᵖ at (f,c) and −⟨ζ u⟩ᵘᵖ at (c,f) with WENO5 candidates
        of ζ; weights from the averaged betas of u and v at (f,f)
        (VelocityStencil) or from ζ's own (VorticityStencil)."""
        use_velocity = self.vector_invariant_stencil == VELOCITY_STENCIL
        shx = lambda a, n: op.shift_x(a, n, g)
        shy = lambda a, n: op.shift_y(a, n, g)
        u_ff = op.iy_f(u, g)   # u interpolated to (f,f)
        v_ff = op.ix_f(v, g)   # v interpolated to (f,f)

        def flux(sh, transverse):
            # the center-from-faces reconstruction at j is the face form
            # of the arrays shifted by one
            z = sh(zeta, 1)
            if use_velocity:
                bu = weno_betas_left(sh(u_ff, 1), sh)
                bv = weno_betas_left(sh(v_ff, 1), sh)
                bl = tuple(0.5 * (x + y) for x, y in zip(bu, bv))
            else:
                bl = weno_betas_left(z, sh)
            zl = _weno_combine(weno_candidates_left(z, sh), bl)
            zr = _weno_combine(weno_candidates_right(z, sh),
                               shift_betas_left_to_right(bl, sh))
            return upwind_biased_product(transverse, zl, zr)

        # u-equation along y onto (f,c); v-equation along x onto (c,f)
        return flux(shy, op.ixy_fc(v, g)), -flux(shx, op.ixy_cf(u, g))

    def _tendencies_conservative(self, state):
        g = self.grid
        uh, vh, h, A = state.u, state.v, state.h, state.A
        gacc = self.gravitational_acceleration
        scheme = self.momentum_advection

        h_fx = op.ix_f(h, g)   # h̄ at (f,c)
        h_fy = op.iy_f(h, g)   # h̄ at (c,f)
        u = uh / h_fx
        v = vh / h_fy

        # ∇·(U ⊗ ũ): symmetric transport, upwind-reconstructed velocity
        flux_xx = upwind_biased_product(op.ix_c(uh, g),
                                        *scheme.both_x_c(u, g))   # (c,c)
        flux_yx = upwind_biased_product(op.ix_f(vh, g),
                                        *scheme.both_y_f(u, g))   # (f,f)
        Gu = -(op.ddx_f(flux_xx, g) + op.ddy_c_flux(flux_yx, g))

        flux_xy = upwind_biased_product(op.iy_f(uh, g),
                                        *scheme.both_x_f(v, g))   # (f,f)
        flux_yy = upwind_biased_product(op.iy_c(vh, g),
                                        *scheme.both_y_c(v, g))   # (c,c)
        Gv = -(op.ddx_c_flux(flux_xy, g) + op.ddy_f(flux_yy, g))

        # gravity −g h̄ ∂h, Coriolis on the transports
        Gu = Gu - gacc * h_fx * op.ddx_f(h, g)
        Gv = Gv - gacc * h_fy * op.ddy_f(h, g)
        Gu = Gu + self.coriolis.tendency_u(vh, g)
        Gv = Gv + self.coriolis.tendency_v(uh, g)

        # mass: the transports are prognostic, no reconstruction
        divU = op.ddx_c_flux(uh, g) + op.ddy_c_flux(vh, g)
        Gh = -divU

        GA = self._tracer_tendency(A, h, uh, vh, divU)
        Gu, Gv, GA = self._add_closure(Gu, Gv, GA, uh, vh, A)
        return Gu, Gv, Gh, GA

    def _tracer_tendency(self, A, h, Uf, Vf, divU):
        """∂t A = (A ∇·U − ∇·(U Ã))/h, minus γ·ℑyᶜ(Vf)/h for a linear
        background γ·y."""
        g = self.grid
        ts = self.tracer_advection
        fx = upwind_biased_product(Uf, *ts.both_x_f(A, g))
        fy = upwind_biased_product(Vf, *ts.both_y_f(A, g))
        div_flux = op.ddx_c_flux(fx, g) + op.ddy_c_flux(fy, g)
        GA = (A * divU - div_flux) / h
        gamma = self.A_background_gradient_y
        if gamma:
            GA = GA - gamma * op.iy_c(Vf, g) / h
        return GA

    # -- time stepping ---------------------------------------------------------------

    def step(self, state: State, dt) -> State:
        """One Le–Moin RK3 step (three tendency evaluations)."""
        G_prev = None
        s = state
        for gamma, zeta_c in zip(RK3_GAMMA, RK3_ZETA):
            G = self.tendencies(s)
            if G_prev is None:
                incr = [dt * gamma * gn for gn in G.fields()]
            else:
                incr = [dt * (gamma * gn + zeta_c * gp)
                        for gn, gp in zip(G.fields(), G_prev.fields())]
            s = s.replace(h=s.h + incr[0], u=s.u + incr[1],
                          v=s.v + incr[2], A=s.A + incr[3])
            G_prev = G
        return s.replace(clock=state.clock.tick(dt))

    def step_fn(self, dt, n_steps: int = 1,
                diagnostics: Optional[Callable] = None):
        """``state -> state`` advancing ``n_steps`` RK3 steps; with
        ``diagnostics`` (``state -> {name: 0-d tensor}``) it returns
        ``(state, {name: (n_steps,) tensor})`` with the series left on the
        device. Time is reconstructed as ``t0 + (k+1)·dt``."""
        return run_steps(lambda s: self.step(s, dt), dt, n_steps,
                          diagnostics)


def run_steps(one_step, dt, n_steps, diagnostics):
    """The chunk loop shared by every stepper: ``one_step`` advances the
    fields by one RK3 step; the clock is set from the step index."""
    def fn(state: State):
        t0, it0 = state.clock.time, state.clock.iteration
        rows = []
        s = state
        for k in range(n_steps):
            s = one_step(s)
            s = s.replace(clock=Clock(t0 + (k + 1) * dt, it0 + k + 1))
            if diagnostics is not None:
                rows.append(diagnostics(s))
        if diagnostics is None:
            return s
        series = {name: torch.stack([r[name] for r in rows])
                  for name in rows[0]} if rows else {}
        return s, series
    return fn
