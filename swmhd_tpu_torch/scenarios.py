"""Named scenario registry, port of :mod:`swmhd_tpu.scenarios`.

The six recorded reference scenarios — {64², 128²} × {two_Gaussians_low_B,
two_Gaussians_high_B, low_B_low_U} — and the two driver scripts'
configurations, with the same initial conditions, step sizes and stop
times as the JAX registry (which documents how each was pinned).
``build`` returns ``(model, state, scenario)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .grid import Grid
from .models.shallow_water import (ShallowWaterModel, VECTOR_INVARIANT,
                                   CONSERVATIVE)
from .physics.coriolis import FPlane
from .forcing import jacobian_lorentz_forcing, divergence_lorentz_forcing


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    N: int
    L: float = 10.0
    g: float = 9.81
    f: float = 1.0
    dt: float = 0.01
    stop_time: float = 30.0
    A0: Optional[Callable] = None
    u0: Optional[Callable] = None
    v0: Optional[Callable] = None
    h0: float = 1.0
    topology: tuple = ("periodic", "periodic")
    A_bg_grad_y: float = 0.0
    description: str = ""


def _two_gaussians(amplitude):
    """Dipole of the divergence driver."""
    def A0(x, y):
        return (amplitude * torch.exp(-((x - 0.5) ** 2 + y ** 2))
                - amplitude * torch.exp(-((x + 0.5) ** 2 + y ** 2)))
    return A0


def _vortex(U=5.0):
    """Velocity of the jacobian driver."""
    u0 = lambda x, y: U * y * torch.exp(-(x ** 2 + y ** 2))
    v0 = lambda x, y: -U * x * torch.exp(-(x ** 2 + y ** 2))
    return u0, v0


def _abs_y_A(slope=0.5):
    return lambda x, y: slope * torch.abs(y)


_REGISTRY: Dict[str, Scenario] = {}


def register(s: Scenario):
    _REGISTRY[s.name] = s
    return s


for N in (64, 128):
    register(Scenario(
        name=f"{N}x{N}_two_Gaussians_low_B", N=N,
        A0=_two_gaussians(0.1), stop_time=70.0 if N == 64 else 60.0,
        description="rest start + weak Gaussian-dipole magnetic potential"))
    register(Scenario(
        name=f"{N}x{N}_two_Gaussians_high_B", N=N,
        A0=_two_gaussians(0.5), stop_time=35.0,
        description="rest start + strong Gaussian-dipole magnetic potential"))
    u0s, v0s = _vortex(1.0)
    register(Scenario(
        name=f"{N}x{N}_low_B_low_U", N=N,
        u0=u0s, v0=v0s, stop_time=15.0,
        topology=("periodic", "bounded"), A_bg_grad_y=-0.05,
        description="weak vortex + uniform field B = (0.05, 0), walls in y; "
                    "A = -0.05y carried as a static background"))

register(Scenario(
    name="adjustment_jacobian", N=64, A0=_abs_y_A(0.5),
    u0=_vortex(5.0)[0], v0=_vortex(5.0)[1], stop_time=30.0,
    description="SWMHD_example.jl canonical run (A = 0.5|y|)"))
register(Scenario(
    name="adjustment_divergence", N=64, A0=_two_gaussians(0.5),
    stop_time=45.0,
    description="divergence_sw_mhd.jl canonical run (dipole A, rest start)"))


def names():
    return sorted(_REGISTRY)


def get(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {', '.join(names())}"
        ) from None


def build(name: str, formulation: str = VECTOR_INVARIANT,
          dtype: torch.dtype = torch.float32, device="cuda", **model_kwargs):
    """(model, state, scenario) for a named scenario, on the card unless
    ``device="cpu"``."""
    sc = get(name)
    grid = Grid.regular(sc.N, sc.N, (-sc.L / 2, sc.L / 2),
                        (-sc.L / 2, sc.L / 2), topology=sc.topology,
                        dtype=dtype, device=device)
    if formulation == CONSERVATIVE:
        forcing = divergence_lorentz_forcing(sc.A_bg_grad_y)
    else:
        forcing = jacobian_lorentz_forcing(sc.A_bg_grad_y)
    model = ShallowWaterModel(
        grid=grid, formulation=formulation,
        gravitational_acceleration=sc.g, coriolis=FPlane(f=sc.f),
        forcing=forcing, A_background_gradient_y=sc.A_bg_grad_y,
        **model_kwargs)
    u0, v0 = sc.u0, sc.v0
    if formulation == CONSERVATIVE and u0 is not None:
        # transports uh = u·h0 over the uniform initial height
        u0 = lambda x, y: sc.u0(x, y) * sc.h0
        v0 = lambda x, y: sc.v0(x, y) * sc.h0
    state = model.initial_state(u=u0, v=v0, h=sc.h0, A=sc.A0)
    return model, state, sc
