"""Model state, PyTorch port of :mod:`swmhd_tpu.models.state`.

``u``/``v`` are velocities in the vector-invariant formulation. The clock
is a host-side pair of Python numbers: its time is a float64 (a Python
float) whatever the grid dtype, so it never drifts and reading it never
waits for the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Clock:
    time: float = 0.0
    iteration: int = 0

    @staticmethod
    def zero(dtype=None) -> "Clock":
        """``Clock(0.0, 0)``. ``dtype`` is accepted, as in the JAX
        package, and ignored: the host clock's time is always a Python
        float."""
        return Clock(0.0, 0)

    def tick(self, dt) -> "Clock":
        return Clock(self.time + dt, self.iteration + 1)


@dataclasses.dataclass(frozen=True)
class State:
    h: torch.Tensor   # layer thickness at (c,c)
    u: torch.Tensor   # u at (f,c)
    v: torch.Tensor   # v at (c,f)
    A: torch.Tensor   # magnetic potential tracer at (c,c)
    clock: Clock = Clock()

    FIELDS = ("h", "u", "v", "A")

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def shape(self):
        return self.h.shape

    def fields(self):
        return (self.h, self.u, self.v, self.A)
