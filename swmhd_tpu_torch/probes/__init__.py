"""The 2-D tile probes, counterparts of ``benchmarks/exp_dma.py``,
``exp_dma2.py`` and ``exp_fused2d.py``: each module runs its kernel of
:mod:`swmhd_tpu_torch.ops.tile` over a list of specs and prints one line
per spec (``python -m swmhd_tpu_torch.probes.exp_fused2d``; ``--device
cpu`` runs the plain versions). :func:`build` is the port's own copy of
``bench.build``, the model and state the tendency probe runs on.
"""

from __future__ import annotations

import time

import torch

from ..forcing import jacobian_lorentz_forcing
from ..grid import Grid
from ..models.shallow_water import VECTOR_INVARIANT, ShallowWaterModel
from ..physics.coriolis import FPlane


def build(N=2048, dtype=torch.float32, device="cuda"):
    """``bench.build(N)``: the vector-invariant model on the periodic
    [-5, 5]² grid of N² points with g = 9.81, FPlane(1) and the jacobian
    Lorentz forcing; a vortex (u, v), h = 1 and a Gaussian dipole A."""
    grid = Grid.regular(N, N, (-5.0, 5.0), (-5.0, 5.0), dtype=dtype,
                        device=device)
    model = ShallowWaterModel(
        grid=grid, formulation=VECTOR_INVARIANT,
        gravitational_acceleration=9.81, coriolis=FPlane(1.0),
        forcing=jacobian_lorentz_forcing())
    state = model.initial_state(
        u=lambda x, y: 5 * y * torch.exp(-(x**2 + y**2)),
        v=lambda x, y: -5 * x * torch.exp(-(x**2 + y**2)),
        h=1.0,
        A=lambda x, y: 0.5 * torch.exp(-((x - 0.5)**2 + y**2))
        - 0.5 * torch.exp(-((x + 0.5)**2 + y**2)))
    return model, state


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, reps, device):
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def spec_list(text):
    """``"a;b;c"`` -> ``["a", "b", "c"]``, empty entries dropped."""
    return [s for s in text.split(";") if s.strip()]
