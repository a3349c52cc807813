"""The CLI's energy series on the card: :func:`energy_series`, the wrapper
of ``csrc/energy_series.cu``, and its plain PyTorch version
:func:`energy_series_reference`.

The series is :data:`ENERGY_NAMES` of one state: kinetic, magnetic and
potential energy, their total and the cross-helicity, as
:func:`~swmhd_tpu_torch.diagnostics.energy_report` computes them (the JAX
CLI keeps the same five of it under ``jax.jit``).
:func:`~swmhd_tpu_torch.cli.energies` picks the route from its input
(:func:`takes_kernel`): the kernel for a float32 or float64 state on a
CUDA card outside :func:`~swmhd_tpu_torch.diagnostics.tile_reduction`, the
plain version for anything else (a CPU state, another dtype, the tile of a
decomposed run, whose integrals are reduced over ranks).

The kernel is one launch a state, deterministic: the same state gives the
same values bit for bit, eagerly and in a CUDA graph. It sums in double
(the plain version's ``torch.mean`` sums in the field type), so the two
differ by rounding. The wrapper counts its launches in
``energy_series.launches``, which graph replays count as they count the
stepper's (``ops.substage._COUNTERS``); the plain version counts its calls
in ``energy_series_reference.calls``.
"""

from __future__ import annotations

import functools
import math

import torch

from ..grid import BOUNDED
from ..models.shallow_water import CONSERVATIVE

ENERGY_NAMES = ("kinetic_energy", "magnetic_energy", "potential_energy",
                "total_energy", "cross_helicity")
# the most points of a block's band of rows: one a thread (at 128² a band
# of 2 rows, 64 blocks; on an H100 bands of 4 rows took 5.3 / 6.6 µs a
# launch against 4.4 / 5.0, VI / walled conservative: PERF.md §6)
BAND_POINTS = 256


def energy_series_reference(model, state, h0):
    """The plain version: the :data:`ENERGY_NAMES` of
    :func:`~swmhd_tpu_torch.diagnostics.energy_report`, computed alone from
    one evaluation of the velocities."""
    from .. import diagnostics
    energy_series_reference.calls += 1
    g = model.grid
    gamma = model.A_background_gradient_y
    u, v = model.velocities(state)
    ke = diagnostics.kinetic_energy(u, v, state.h, g)
    me = diagnostics.magnetic_energy(state.A, state.h, g, gamma)
    pe = diagnostics.potential_energy(state.h, h0,
                                      model.gravitational_acceleration, g)
    return {"kinetic_energy": ke, "magnetic_energy": me,
            "potential_energy": pe, "total_energy": ke + me + pe,
            "cross_helicity": diagnostics.cross_helicity(
                u, v, state.A, state.h, g, gamma)}


def takes_kernel(state) -> bool:
    """Whether :func:`~swmhd_tpu_torch.cli.energies` takes the kernel for
    ``state``: a float32 or float64 state on a CUDA card whose diagnostics
    do not run on a tile
    (:func:`~swmhd_tpu_torch.diagnostics.tile_reduction`)."""
    from .. import diagnostics
    h = state.h
    return (h.is_cuda and h.dtype in (torch.float32, torch.float64)
            and not diagnostics.on_tile())


def band_rows(nx, ny):
    """The rows of a block's band on an ``nx × ny`` grid: as many whole
    rows as :data:`BAND_POINTS` holds, at least one."""
    return max(1, min(nx, BAND_POINTS // ny))


@functools.lru_cache(maxsize=None)
def _scratch(device, stream, nx, ny):
    """The scratch of the launches on ``stream`` (a CUDA stream's handle)
    of ``device`` for an ``nx × ny`` grid: four sums a block and the
    ticket, zero; made once, so that a captured launch keeps its address
    (a graph's launches take the capture stream's). Launches that share a
    scratch must be ordered on one stream: with one a stream, a launch on
    the current stream never races a chunk's replays on a side stream
    (``Simulation.run``)."""
    blocks = math.ceil(nx / band_rows(nx, ny))
    return torch.zeros(4 * blocks + 1, dtype=torch.float64, device=device)


def energy_series(model, state, h0):
    """``{name: 0-d tensor}`` of :data:`ENERGY_NAMES` of ``state`` against
    the initial height ``h0``: on a CUDA state one launch of the kernel,
    the five values views of one new ``(5,)`` tensor of the state's dtype;
    on a CPU state the plain version. On CUDA, fields that are not
    contiguous ``(Nx, Ny)`` tensors of one float32 or float64 dtype on one
    card raise ``ValueError``, and a failed launch ``RuntimeError``."""
    h = state.h
    if h.device.type == "cpu":
        return energy_series_reference(model, state, h0)
    from .substage import _lib_fn, _ptr, _raise_on
    g = model.grid
    fields = (h, state.u, state.v, state.A, h0)
    if h.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA energy series takes float32 or float64, "
                         f"not {h.dtype}")
    for f in fields:
        if (tuple(f.shape) != (g.Nx, g.Ny) or f.dtype != h.dtype
                or f.device != h.device or not f.is_contiguous()):
            raise ValueError(f"the CUDA energy series takes contiguous "
                             f"({g.Nx}, {g.Ny}) {h.dtype} fields on "
                             f"{h.device}; got {tuple(f.shape)} {f.dtype} "
                             f"on {f.device}, contiguous {f.is_contiguous()}")
    out = torch.empty(len(ENERGY_NAMES), dtype=h.dtype, device=h.device)
    fn = _lib_fn("swmhd_energy_series", h.dtype)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(*(_ptr(f) for f in fields), _ptr(out),
             _ptr(_scratch(h.device, stream, g.Nx, g.Ny)), g.Nx, g.Ny,
             band_rows(g.Nx, g.Ny), int(model.formulation == CONSERVATIVE),
             int(g.topology_x == BOUNDED), int(g.topology_y == BOUNDED),
             g.dx, g.dy, g.Lx, g.Ly, float(model.gravitational_acceleration),
             float(model.A_background_gradient_y), stream)
    energy_series.launches += 1
    _raise_on(err, "swmhd_energy_series")
    return dict(zip(ENERGY_NAMES, out.unbind(0)))


energy_series.launches = 0
energy_series_reference.calls = 0
