"""The RK3 substage on the card: wrappers of ``csrc/substage.cu``, their
plain PyTorch versions, and the :class:`KernelStepper` that drives a
:class:`~swmhd_tpu_torch.simulation.Simulation` through them.

Counterparts of the Pallas kernels of ``swmhd_tpu/ops/fused_step.py``:
:func:`substage` of the windowed substage (``fused_step_fn``) and
:func:`multistep` of the resident multi-step kernel
(``resident_step_fn``), one cooperative launch for 3·n substages. :func:`substage` with a ``halo`` is also the
counterpart of the sharded substage of
``swmhd_tpu/parallel/decomposition.py`` (``fused_step_fn``): the same
substage on a tile padded with a halo exchanged from its neighbours, its
launches counted under the branches with an exchanged axis; with
``out=`` and ``at=``, on a region of a tile in place (the interior and
edge bands of the decomposition's overlap split). The
prognostics travel stacked as one ``(4, Nx, Ny)`` tensor in the order h,
u, v, A.

Each formulation's substage is one kernel over 2-D tiles of ``(TX,
TILE_Y)`` points with its intermediates in shared memory and the
Le–Moin update fused in; the wrapper picks TX (:func:`tile_shape`) and
allocates nothing but the outputs. Their plain emulations tile by tile
are :func:`swmhd_tpu_torch.ops.vi_tile.substage_tiles_reference` and
:func:`swmhd_tpu_torch.ops.cons_tile.substage_tiles_reference`.

The kernels cover both formulations (vector-invariant with the jacobian
Lorentz forcing, conservative with the divergence-form one) on any pair of
periodic and bounded axes, with any of the three advection schemes for
momentum, mass and tracer, either vorticity stencil, and no closure, a
Laplacian or a biharmonic one. Dispatch: on a CPU tensor a wrapper runs
its plain version; on a CUDA tensor it launches the kernel or raises. A
configuration the kernel does not cover (a forcing other than the
formulation's Lorentz forcing, a grid under 8 points) raises
``ValueError`` on CUDA. Each wrapper counts its launches in
``<wrapper>.launches`` and, by :class:`Branch` (the templated axis modes
:data:`PERIODIC_AXIS`, :data:`BOUNDED_AXIS` and :data:`EXCHANGED_AXIS`
and the runtime switches; :func:`branch_label` names it), in
``<wrapper>.launches_by_branch``; :func:`substage` also by what it
computes (:func:`region_part`) in ``substage.launches_by_part``;
:func:`multistep` also counts the
substages its launches hold in ``multistep.substages`` and
``multistep.substages_by_branch``; each plain version counts its calls in
``<function>.calls``, so a run can show which path it took. A launch
captured into a CUDA graph counts once each time the graph is replayed
(:class:`GraphChunk`), the energy series' launches
(:func:`~swmhd_tpu_torch.ops.energies.energy_series`) among them.

:class:`KernelStepper` picks the route as the JAX CLI does: the resident
kernel where its working set fits on chip (here the card's L2,
:func:`takes_resident`), else 3·n one-substage launches
(:func:`windowed_steps`). It drives a chunk without a series as one call
of that route and, on the card, a chunk with a per-step series as
replays of CUDA graphs, each holding up to :data:`GRAPH_STEPS` steps of
the route's launches and the series (:class:`GraphChunk`), the
counterpart of the JAX package's chunk compiled once by ``jax.jit``.
"""

from __future__ import annotations

import collections
import copy
import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from .. import tracing
from ..grid import BOUNDED, PERIODIC
from ..models.shallow_water import (RK3_GAMMA, RK3_ZETA, CONSERVATIVE,
                                    VECTOR_INVARIANT, VELOCITY_STENCIL,
                                    VORTICITY_STENCIL, run_steps)
from ..models.state import Clock, State
from ..physics.diffusion import BiharmonicDiffusion, LaplacianDiffusion
from .energies import energy_series, energy_series_reference


class TileLayout(NamedTuple):
    """The shared memory of one formulation's tile kernel: the state
    windows and the box arrays span the tile and ``lo`` cells before it,
    ``hi`` after it on each axis (the composed read radius); the box holds
    ``arrays`` intermediates at its peak, ``biharmonic`` more with a
    biharmonic closure (csrc/vi_tile.cuh vi_smem_bytes,
    csrc/cons_tile.cuh cons_smem_bytes)."""
    lo: int
    hi: int
    arrays: int
    biharmonic: int


# the substage kernels' tiles: (TX, TILE_Y) points, TX one of TILE_X
TILE_Y, TILE_X = 32, (32, 16, 8)
TILE_LAYOUTS = {VECTOR_INVARIANT: TileLayout(3, 3, 8, 2),
                CONSERVATIVE: TileLayout(4, 3, 8, 0)}
MIN_POINTS = 8      # per axis: the kernel wraps indices at most once
# how the kernel reads past the end of an axis (the AxisMode of
# csrc/substage.cuh): wrap, clamp at a wall, or read the exchanged halo
PERIODIC_AXIS, BOUNDED_AXIS, EXCHANGED_AXIS = 0, 1, 2
# the runtime switches of csrc/substage.cuh (Scheme, Closure, Stencil)
SCHEMES = ("weno5", "upwind3", "centered2")
CLOSURES = (type(None), LaplacianDiffusion, BiharmonicDiffusion)
CLOSURE_NAMES = ("none", "laplacian", "biharmonic")
STENCILS = (VELOCITY_STENCIL, VORTICITY_STENCIL)
# the Lorentz forcing each formulation's kernel computes in-kernel:
# (forcing key, tag set by the forcing factory, factory name)
LORENTZ = {
    VECTOR_INVARIANT: (("u", "v"), "jacobian_lorentz_A_bg_grad_y",
                       "jacobian_lorentz_forcing"),
    CONSERVATIVE: (("uh", "vh"), "divergence_lorentz_A_bg_grad_y",
                   "divergence_lorentz_forcing"),
}


# -- plain versions ------------------------------------------------------------

def _crop(a, halo):
    hx, hy = halo
    return a[:, hx:a.shape[1] - hx, hy:a.shape[2] - hy]


def substage_reference(model, s, dt, stage, g_prev=None, halo=(0, 0)):
    """Substage ``stage`` (0, 1, 2) of the Le–Moin step on stacked fields:
    ``(s + dt (γ G + ζ G_prev), G)`` with G = ``model.tendencies(s)``.

    On a tile padded by ``halo = (hx, hy)`` the tendencies run on the
    padded tile's own grid, where a padded (exchanged) axis is periodic,
    so its wrap puts garbage only into a ring narrower than the composed
    radius, which the crop removes; ``g_prev`` and the results are
    unpadded."""
    substage_reference.calls += 1
    if halo != (0, 0):
        g = model.grid
        NX, NY = s.shape[1:]
        model = dataclasses.replace(model, grid=dataclasses.replace(
            g, Nx=NX, Ny=NY, Lx=g.dx * NX, Ly=g.dy * NY,
            topology_x=PERIODIC if halo[0] else g.topology_x,
            topology_y=PERIODIC if halo[1] else g.topology_y))
    G = _crop(torch.stack(model.tendencies(State(*s)).fields()), halo)
    inc = RK3_GAMMA[stage] * G
    if g_prev is not None:
        inc = inc + RK3_ZETA[stage] * g_prev
    return _crop(s, halo) + dt * inc, G


def multistep_reference(model, s, dt, n_steps):
    """``n_steps`` RK3 steps on stacked fields through
    :func:`substage_reference`."""
    multistep_reference.calls += 1
    for _ in range(n_steps):
        g = None
        for stage in range(3):
            s, g = substage_reference(model, s, dt, stage, g)
    return s


# -- kernel wrappers -------------------------------------------------------------

class Branch(NamedTuple):
    """What a launch ran: the templated branch (formulation, axis modes)
    and the runtime switches (closure, scheme of each advection, vorticity
    stencil), as indices of :data:`CLOSURES`, :data:`SCHEMES` and
    :data:`STENCILS`; the switches default to the default model's."""
    conservative: int
    mode_x: int
    mode_y: int
    closure: int = 0
    momentum: int = 0
    mass: int = 0
    tracer: int = 0
    stencil: int = 0


class KernelParams(NamedTuple):
    """The kernel's arguments for a model, in the entry points' order."""
    conservative: int
    wall_x: int
    wall_y: int
    closure: int
    momentum: int
    mass: int
    tracer: int
    stencil: int
    dx: float
    dy: float
    g: float
    f: float
    gamma: float
    nu: float
    kappa: float

    @property
    def branch(self) -> Branch:
        return Branch(*self[:8])


def kernel_params(model) -> KernelParams:
    """The kernel's arguments for a model it covers; ``ValueError`` naming
    what it does not cover otherwise."""
    g = model.grid
    if g.Nx < MIN_POINTS or g.Ny < MIN_POINTS:
        raise ValueError(f"the CUDA substage needs Nx, Ny >= {MIN_POINTS}; "
                         f"got {g.Nx}x{g.Ny}")
    schemes = []
    for name in ("momentum_advection", "mass_advection", "tracer_advection"):
        scheme = getattr(model, name).name
        if scheme not in SCHEMES:
            raise ValueError(f"the CUDA substage has no {name} {scheme!r}; "
                             f"it has {', '.join(SCHEMES)}")
        schemes.append(SCHEMES.index(scheme))
    closure = model.closure
    if type(closure) not in CLOSURES:
        raise ValueError(f"the CUDA substage has no closure "
                         f"{type(closure).__name__}; it has "
                         f"LaplacianDiffusion and BiharmonicDiffusion")
    gamma = model.A_background_gradient_y
    key, tag, factory = LORENTZ[model.formulation]
    forcing = dict(model.forcing)
    fn = forcing.get(key)
    if (len(forcing) != 1 or fn is None
            or getattr(fn, tag, None) != gamma):
        raise ValueError(f"the CUDA substage of the {model.formulation} "
                         f"formulation computes exactly its Lorentz forcing "
                         f"({factory} with the model's "
                         f"A_background_gradient_y)")
    conservative = model.formulation == CONSERVATIVE
    stencil = STENCILS.index(model.vector_invariant_stencil)
    if conservative:
        # it reconstructs no mass and has no vorticity flux: these options
        # change nothing it computes, so they keep the default's branch
        schemes[1] = stencil = 0
    return KernelParams(
        int(conservative),
        int(g.topology_x == BOUNDED), int(g.topology_y == BOUNDED),
        CLOSURES.index(type(closure)), *schemes, stencil,
        g.dx, g.dy, float(model.gravitational_acceleration),
        float(model.coriolis.f), float(gamma),
        float(getattr(closure, "nu", 0.0)),
        float(getattr(closure, "kappa", 0.0)))


def branch_label(branch) -> str:
    """A :class:`Branch` (or its first fields) as ``"<formulation>,
    <periodic | bounded x | bounded y | bounded xy>[, exchanged x | y |
    xy]"``, then what differs from the default model: ``laplacian`` or
    ``biharmonic``, ``<scheme> momentum | mass | tracer``, ``vorticity
    stencil``."""
    b = Branch(*branch)
    parts = []
    for mode, word in ((BOUNDED_AXIS, "bounded"),
                       (EXCHANGED_AXIS, "exchanged")):
        axes = "x" * (b.mode_x == mode) + "y" * (b.mode_y == mode)
        if axes:
            parts.append(f"{word} {axes}")
    parts = [CONSERVATIVE if b.conservative else VECTOR_INVARIANT,
             *(parts or ["periodic"])]
    if b.closure:
        parts.append(CLOSURE_NAMES[b.closure])
    for name in ("momentum", "mass", "tracer"):
        if getattr(b, name):
            parts.append(f"{SCHEMES[getattr(b, name)]} {name}")
    if b.stencil:
        parts.append(f"{STENCILS[b.stencil]} stencil")
    return ", ".join(parts)


def _check_fields(s):
    if s.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA substage takes float32 or float64, "
                         f"not {s.dtype}")
    if not s.is_contiguous():
        raise ValueError("stacked fields must be contiguous")


def smem_bytes(formulation, dtype, tile_x, biharmonic=False) -> int:
    """Shared memory a block of ``formulation``'s tile kernel takes: the
    four state windows and the box's intermediates at their peak, each
    (tile_x + lo + hi) × (TILE_Y + lo + hi) values (:data:`TILE_LAYOUTS`)."""
    lay = TILE_LAYOUTS[formulation]
    box = (tile_x + lay.lo + lay.hi) * (TILE_Y + lay.lo + lay.hi)
    return dtype.itemsize * box * (4 + lay.arrays
                                   + lay.biharmonic * bool(biharmonic))


@functools.lru_cache(maxsize=None)
def tile_shape(formulation, nx, ny, dtype, biharmonic, smem_limit, sms):
    """``(TX, TILE_Y)`` of ``formulation``'s tile kernel on an unpadded
    ``nx × ny`` output, on a card of ``sms`` SMs whose opt-in shared
    memory a block is ``smem_limit`` bytes (:func:`card_limits`): among
    the TX of TILE_X whose block leaves room for two in that limit, the
    largest that still makes two blocks an SM, else the smallest. Cached:
    every substage call asks."""
    fits = [t for t in TILE_X
            if 2 * smem_bytes(formulation, dtype, t, biharmonic)
            <= smem_limit]
    for t in fits:
        if math.ceil(nx / t) * math.ceil(ny / TILE_Y) >= 2 * sms:
            return t, TILE_Y
    return fits[-1], TILE_Y


@functools.lru_cache(maxsize=None)
def _lib_fn(name, dtype):
    # once per process: _build.load() hashes the sources on every call
    from . import _build
    with tracing.span("kernel_ready", setup=True):
        return _build.load().fn(name,
                                "f32" if dtype == torch.float32 else "f64")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def card_limits(index):
    """``(opt-in shared memory bytes a block, SMs)`` of CUDA card
    ``index``: the limit the kernels refuse a tile over
    (``swmhd_smem_limit``) and the runtime's SM count."""
    from . import _build
    with tracing.span("kernel_ready", setup=True):
        with torch.cuda.device(index):
            limit = _build.load().fn("swmhd_smem_limit")()
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    return limit, sms


# words a point the resident kernel keeps live between substages: the two
# ping-pong states and the two G buffers, four fields each
RESIDENT_WORDS = 16


@functools.lru_cache(maxsize=None)
def l2_bytes(index):
    """The L2 cache of CUDA card ``index`` in bytes."""
    return torch.cuda.get_device_properties(index).L2_cache_size


def takes_resident(model, s):
    """Whether :class:`KernelStepper` steps the stacked CUDA fields ``s``
    through the resident kernel: where its working set
    (:data:`RESIDENT_WORDS` a point) fits the card's L2, as the JAX CLI
    takes ``resident_step_fn`` where the state fits VMEM. Above it a grid
    barrier buys nothing over a kernel boundary, and the one-substage
    kernel, with fewer registers, is faster (PERF.md §6)."""
    g = model.grid
    return (RESIDENT_WORDS * s.element_size() * g.Nx * g.Ny
            <= l2_bytes(s.device.index))


def _tile_x(model, nx, ny, s):
    """The rows of the kernel's tiles on an unpadded ``nx × ny`` output of
    the stacked fields ``s`` (a CUDA tensor), by :func:`tile_shape` on its
    card."""
    return tile_shape(model.formulation, nx, ny, s.dtype,
                      isinstance(model.closure, BiharmonicDiffusion),
                      *card_limits(s.device.index))[0]


def tile_info(dtype, branch, tile_x):
    """``(shared memory bytes a block, registers a thread, resident blocks
    an SM)`` of the tile kernel that a launch of :class:`Branch` ``branch``
    with tiles of ``tile_x`` rows takes, from the CUDA runtime
    (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    b = Branch(*branch)
    opt = any(b[3:])        # a switch off the default model's
    biharmonic = CLOSURES[b.closure] is BiharmonicDiffusion
    out = (ctypes.c_int * 3)()
    with tracing.span("kernel_ready", setup=True):
        err = _lib_fn("swmhd_tile_info", dtype)(
            b.conservative, b.mode_x, b.mode_y, int(opt), int(tile_x),
            int(biharmonic), ctypes.addressof(out))
    _raise_on(err, "swmhd_tile_info")
    return tuple(out)


def resident_info(dtype, branch, tile_x, tiles, sms):
    """``(shared memory bytes a block, registers a thread, resident blocks
    an SM, grid)`` of the resident kernel that a :func:`multistep` launch
    of :class:`Branch` ``branch`` with tiles of ``tile_x`` rows over
    ``tiles`` tiles on a card of ``sms`` SMs takes, from the CUDA runtime;
    the call also readies the kernel (its shared memory limit and blocks
    an SM), so that a later launch makes no runtime query."""
    b = Branch(*branch)
    biharmonic = CLOSURES[b.closure] is BiharmonicDiffusion
    out = (ctypes.c_int * 4)()
    err = _lib_fn("swmhd_resident_info", dtype)(
        b.conservative, b.mode_x, b.mode_y, int(any(b[3:])), int(tile_x),
        int(biharmonic), int(tiles), int(sms), ctypes.addressof(out))
    _raise_on(err, "swmhd_resident_info")
    return tuple(out)


def resident_tiles(nx, ny, tile_x):
    """The tiles of a :func:`multistep` launch on an ``nx × ny`` grid."""
    return math.ceil(nx / tile_x) * math.ceil(ny / TILE_Y)


def ready(model, s):
    """Ready :func:`multistep`'s launch on the stacked CUDA fields ``s``:
    the library, the card's limits and the resident kernel (its shared
    memory limit and blocks an SM), so that a launch inside a stream
    capture runs no lookup and no runtime query; returns
    :func:`resident_info` of that launch."""
    g = model.grid
    with tracing.span("kernel_ready", setup=True):
        tile_x = _tile_x(model, g.Nx, g.Ny, s)
        _lib_fn("swmhd_multistep", s.dtype)
        return resident_info(s.dtype, kernel_params(model).branch, tile_x,
                             resident_tiles(g.Nx, g.Ny, tile_x),
                             card_limits(s.device.index)[1])


def region_part(halo, shape, at, extent):
    """What a :func:`substage` launch computes, for
    ``substage.launches_by_part``: ``"whole"`` (a whole domain) or
    ``"tile"`` (a padded tile) where it writes all of its ``shape``
    output buffers, else the part of a split tile (``parallel``'s overlap
    split) that its ``extent`` at ``at`` covers: ``"interior"`` where it
    stays clear of each edge of an exchanged axis, ``"band"`` where it
    reaches one."""
    if tuple(at) == (0, 0) and tuple(extent) == tuple(shape):
        return "tile" if any(halo) else "whole"
    inside = all(a > 0 and a + m < n for h, a, m, n
                 in zip(halo, at, extent, shape) if h)
    return "interior" if inside else "band"


def substage(model, s, dt, stage, g_prev=None, write_G=True, *,
             halo=(0, 0), out=None, at=(0, 0)):
    """One Le–Moin substage on stacked fields ``s``; returns ``(s_new,
    G)`` with ``G`` None unless ``write_G``.

    With ``halo = (hx, hy)``, ``s`` is a tile of ``model``'s domain padded
    by cells the caller has exchanged from the neighbouring tiles, ``(4,
    nx + 2hx, ny + 2hy)``; ``g_prev`` and the results are ``(4, nx, ny)``.
    A padded axis must be periodic in ``model`` and is read from the halo
    (the exchanged axis mode); an axis with no pad is the whole domain's
    and wraps or walls. The kernel's tiles are :func:`tile_shape`'s.

    With ``out = (s_out, g_out)`` (``g_out`` None unless ``write_G``) the
    launch computes a region of a larger tile in place: ``s`` is a slab
    of it (a view with any strides whose rows are contiguous, such as a
    band of the padded tile, or the unpadded tile, whose own outer ring
    then serves as its halo), its ``(nx, ny)`` unpadded points are
    written into ``s_out`` and ``g_out`` at ``at = (x, y)``, and
    ``g_prev``, shaped like them, is read there; returns ``out``. Every
    point's arithmetic is the one-launch tile's. Each launch counts in
    ``substage.launches_by_part`` by :func:`region_part`."""
    hx, hy = halo
    g = model.grid
    for h, topo, name in ((hx, g.topology_x, "x"), (hy, g.topology_y, "y")):
        if h < 0 or (h and topo != PERIODIC):
            raise ValueError(f"a tile pads only a periodic axis: {name} is "
                             f"{topo}, halo {h}")
    nx, ny = ((s.shape[1] - 2 * hx, s.shape[2] - 2 * hy) if s.dim() == 3
              else (0, 0))
    if out is not None:
        return _substage_region(model, s, dt, stage, g_prev, write_G,
                                halo, (nx, ny), out, at)
    if s.device.type == "cpu":
        s_new, G = substage_reference(model, s, dt, stage, g_prev, halo)
        return s_new, (G if write_G else None)
    params = _check_launch(model, s, stage, g_prev, halo, (nx, ny))
    if not s.is_contiguous():
        raise ValueError("stacked fields must be contiguous")
    shape = (4, nx, ny)
    if g_prev is not None and (tuple(g_prev.shape) != shape
                               or g_prev.dtype != s.dtype
                               or g_prev.device != s.device
                               or not g_prev.is_contiguous()):
        raise ValueError(f"G_prev must be a contiguous {shape} tensor like "
                         f"the stacked fields")
    s_out = torch.empty(shape, dtype=s.dtype, device=s.device)
    g_out = torch.empty_like(s_out) if write_G else None
    _launch(params, model, s, g_prev, s_out, g_out, halo, (nx, ny), dt,
            stage, region_part(halo, (nx, ny), (0, 0), (nx, ny)))
    return s_out, g_out


def _check_launch(model, s, stage, g_prev, halo, extent):
    """The checks of a launch on the CUDA fields ``s`` whose unpadded
    output is ``extent``; the model's :class:`KernelParams`."""
    params = kernel_params(model)
    g = model.grid
    (hx, hy), (nx, ny) = halo, extent
    if (s.shape[0] != 4 or nx < 1 or ny < 1
            or (not hx and nx != g.Nx) or (not hy and ny != g.Ny)):
        raise ValueError(f"stacked fields must be (4, {g.Nx}, {g.Ny}), or "
                         f"a tile (4, nx + 2*{hx}, ny + 2*{hy}) with the "
                         f"whole domain on an unpadded axis; got "
                         f"{tuple(s.shape)}")
    if s.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA substage takes float32 or float64, "
                         f"not {s.dtype}")
    if (stage > 0) != (g_prev is not None):
        raise ValueError("substages 1 and 2 take G_prev; substage 0 does not")
    return params


def _substage_region(model, s, dt, stage, g_prev, write_G, halo, extent,
                     out, at):
    """:func:`substage` with ``out``: the region ``extent`` at ``at`` of
    the output buffers."""
    s_out, g_out = out
    (nx, ny), (x, y) = extent, at
    if write_G != (g_out is not None):
        raise ValueError("out holds g_out exactly when write_G")
    if (s_out.dim() != 3 or s_out.shape[0] != 4 or x < 0 or y < 0
            or x + nx > s_out.shape[1] or y + ny > s_out.shape[2]):
        raise ValueError(f"a region of {nx}x{ny} at {tuple(at)} does not "
                         f"lie in an output of {tuple(s_out.shape)}")
    for t in (g_out, g_prev):
        # the kernel takes one set of strides for the three
        if t is not None and (t.shape != s_out.shape or t.dtype != s.dtype
                              or t.device != s.device
                              or (s.is_cuda and t.stride() != s_out.stride())):
            raise ValueError(f"G_prev and g_out must be laid out like "
                             f"s_out, {tuple(s_out.shape)} "
                             f"{tuple(s_out.stride())}")

    def region(t):
        return None if t is None else t[:, x:x + nx, y:y + ny]
    if s.device.type == "cpu":
        s_new, G = substage_reference(model, s, dt, stage, region(g_prev),
                                      halo)
        region(s_out).copy_(s_new)
        if g_out is not None:
            region(g_out).copy_(G)
        return out
    params = _check_launch(model, s, stage, g_prev, halo, extent)
    if s.stride(2) != 1 or s_out.stride(2) != 1 or s_out.dtype != s.dtype:
        raise ValueError("the stacked fields and the outputs need "
                         "contiguous rows of one dtype")
    _launch(params, model, s, region(g_prev), region(s_out), region(g_out),
            halo, extent, dt, stage,
            region_part(halo, s_out.shape[1:], at, extent))
    return out


def _launch(params, model, s, g_prev, s_out, g_out, halo, extent, dt,
            stage, part):
    """One ``swmhd_substage`` launch on the current stream, each array
    passed with its strides (``g_prev``, ``s_out`` and ``g_out`` the
    output region's views), counted."""
    hx, hy = halo
    branch = params.branch._replace(
        mode_x=EXCHANGED_AXIS if hx else params.wall_x,
        mode_y=EXCHANGED_AXIS if hy else params.wall_y)
    fn = _lib_fn("swmhd_substage", s.dtype)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    err = fn(_ptr(s), _ptr(g_prev), _ptr(s_out), _ptr(g_out), *extent, hx,
             hy, s.stride(1), s.stride(0), s_out.stride(1), s_out.stride(0),
             *branch, _tile_x(model, *extent, s), *params[8:], float(dt),
             RK3_GAMMA[stage], RK3_ZETA[stage], stream)
    substage.launches += 1
    substage.launches_by_branch[branch] += 1
    substage.launches_by_part[part] += 1
    _raise_on(err, "swmhd_substage")


def multistep(model, s, dt, n_steps):
    """``n_steps`` RK3 steps on stacked fields ``s`` (left unchanged): on
    a CUDA tensor one launch of the resident kernel, holding 3·n_steps
    substages; a grid the card refuses raises ``RuntimeError``."""
    if s.device.type == "cpu":
        return multistep_reference(model, s, dt, n_steps)
    params = kernel_params(model)
    g = model.grid
    if s.shape != (4, g.Nx, g.Ny):
        raise ValueError(f"stacked fields must be (4, {g.Nx}, {g.Ny}); "
                         f"got {tuple(s.shape)}")
    _check_fields(s)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    out = torch.empty_like(s)
    work = torch.empty_like(s)
    gbuf = torch.empty((2,) + tuple(s.shape), dtype=s.dtype, device=s.device)
    fn = _lib_fn("swmhd_multistep", s.dtype)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    err = fn(_ptr(s), _ptr(out), _ptr(work), _ptr(gbuf), g.Nx, g.Ny,
             *params[:8], _tile_x(model, g.Nx, g.Ny, s), *params[8:],
             float(dt), int(n_steps), card_limits(s.device.index)[1],
             stream)
    multistep.launches += 1
    multistep.launches_by_branch[params.branch] += 1
    multistep.substages += 3 * n_steps
    multistep.substages_by_branch[params.branch] += 3 * n_steps
    _raise_on(err, "swmhd_multistep")
    return out


def windowed_steps(model, s, dt, n_steps):
    """``n_steps`` RK3 steps on stacked fields ``s`` as 3·n_steps
    :func:`substage` calls, G passed on as the resident kernel keeps it
    (the counterpart of ``fused_step_fn``'s chunk)."""
    for _ in range(n_steps):
        g = None
        for stage in range(3):
            s, g = substage(model, s, dt, stage, g, write_G=stage < 2)
    return s


# each wrapper's counters, the energy series' too (ops/energies.py)
_COUNTERS = {substage: ("launches", "launches_by_branch",
                        "launches_by_part"),
             multistep: ("launches", "launches_by_branch", "substages",
                         "substages_by_branch"),
             energy_series: ("launches",)}


def reset_counters():
    for f, attrs in _COUNTERS.items():
        for attr in attrs:
            setattr(f, attr, collections.Counter()
                    if "_by_" in attr else 0)
    for f in (substage_reference, multistep_reference,
              energy_series_reference):
        f.calls = 0


reset_counters()


def _counts():
    """A copy of every wrapper counter."""
    return {(f, attr): copy.copy(getattr(f, attr))
            for f, attrs in _COUNTERS.items() for attr in attrs}


def _take_counts(before):
    """What the wrappers counted since ``before`` (:func:`_counts`); the
    counters go back to ``before``."""
    delta = {}
    for (f, attr), was in before.items():
        delta[(f, attr)] = getattr(f, attr) - was
        setattr(f, attr, was)
    return delta


def _add_counts(delta):
    for (f, attr), d in delta.items():
        setattr(f, attr, getattr(f, attr) + d)


# -- the stepper -------------------------------------------------------------------

def stack(state: State) -> torch.Tensor:
    return torch.stack(state.fields())


def unstack(s: torch.Tensor, clock: Clock) -> State:
    h, u, v, A = s.unbind(0)
    return State(h=h, u=u, v=v, A=A, clock=clock)


class ClockRead(RuntimeError):
    """A series function read the clock of a chunk captured as a CUDA
    graph."""


class _NoClock:
    """The clock a series function sees in a :class:`GraphChunk`: a
    captured graph replays no Python value, so reading the time or the
    iteration raises :class:`ClockRead` (under ``jax.jit`` they would be
    traced values)."""

    def __getattr__(self, name):
        raise ClockRead(
            f"a series function read state.clock.{name} in a chunk captured "
            f"as a CUDA graph, where the clock is no device value")


_NO_CLOCK = _NoClock()
GRAPH_STEPS = 100   # the most steps one captured graph holds


def chunk_plan(n_steps, k):
    """``[(offset, steps)]`` of a chunk of ``n_steps``: ⌊n/k⌋ replays of
    the ``k``-step graph, then one of the remainder's."""
    reps, rem = divmod(n_steps, k)
    return [(i * k, k) for i in range(reps)] + ([(reps * k, rem)] if rem
                                                  else [])


class GraphChunk:
    """``state -> (state, {name: (n_steps,) tensor})``: ``n_steps`` RK3
    steps of :class:`KernelStepper` ``stepper`` on the card with the series
    ``diagnostics`` after each, as
    :func:`~swmhd_tpu_torch.models.shallow_water.run_steps` gives them,
    run as replays of CUDA graphs (:meth:`KernelStepper.step_fn` on the
    card).

    A graph of j steps holds, for each step, the stepper's launches of one
    step (:meth:`KernelStepper.advance`: one resident launch, or three
    one-substage launches) and the series, whose values go to row j of a
    static buffer. A chunk replays the k-step graph ⌊n/k⌋ times and a graph
    of the remainder (:func:`chunk_plan`, k = min(n, ``k``)), copying each
    replay's rows into the chunk's series on the device: no host copy and
    no host sync; the caller's one device→host copy of the series is the
    chunk's only one. The graphs are captured at the first call, after one
    eager call of the series and the readying of the stepper's kernel
    (:func:`ready`, :func:`tile_info`), and live as long as this object
    (``Simulation`` keeps one a chunk length until Δt changes). The state
    enters through a static buffer; the state returned is a clone, which a
    later replay leaves alone. Tensors the series closes over must keep
    their addresses. A series that syncs with the host (``.item()``, a
    Python branch on a tensor) or reads the clock raises ``RuntimeError``
    at capture, naming it. Each replay counts the launches its graph
    holds. CUDA tensors only: a CPU state raises ``ValueError``. The
    warm-up and each capture are set-up spans (``swmhd.graph_warm``,
    ``swmhd.graph_capture``), each replay a ``swmhd.graph_replay`` span
    (:mod:`swmhd_tpu_torch.tracing`)."""

    def __init__(self, stepper, dt, n_steps, diagnostics, k=GRAPH_STEPS):
        self.stepper, self.dt, self.n_steps = stepper, dt, n_steps
        self.diagnostics = diagnostics
        self.plan = chunk_plan(n_steps, min(n_steps, k))
        self.graphs = {}        # steps -> (replay, rows)
        self.s = self.names = self.pool = None
        self.failed = None

    def _steps(self, j, rows):
        """j steps from ``self.s``: column i of ``rows`` takes the series
        after step i, ``self.s`` the state after the last."""
        s = self.s
        for i in range(j):
            s = self.stepper.advance(s, self.dt, 1)
            try:
                vals = self.diagnostics(unstack(s, _NO_CLOCK))
            except Exception as e:
                self.failed = e
                raise
            if self.names:
                rows[:, i].copy_(torch.stack([vals[n] for n in self.names]))
        self.s.copy_(s)

    def _warm(self, state):
        with tracing.span("graph_warm", setup=True):
            s = stack(state)
            if not s.is_cuda:
                raise ValueError("a GraphChunk captures CUDA graphs: the "
                                 "state must lie on a CUDA card")
            model = self.stepper.model
            if takes_resident(model, s):
                ready(model, s)
            else:
                tile_info(s.dtype, kernel_params(model).branch,
                          _tile_x(model, model.grid.Nx, model.grid.Ny, s))
            self.pool = torch.cuda.graph_pool_handle()
            try:
                vals = self.diagnostics(unstack(s, _NO_CLOCK))
            except ClockRead as e:
                raise self._refusal(e) from e
            self.names = list(vals)
            self.row_dtype = (
                torch.stack([vals[n] for n in self.names]).dtype
                if self.names else s.dtype)
            self.s = torch.empty_like(s)

    def _refusal(self, err):
        """The error of a series that cannot be captured, naming it."""
        name = getattr(self.diagnostics, "__qualname__",
                       repr(self.diagnostics))
        return RuntimeError(
            f"the series function {name} cannot run in a chunk captured as "
            f"a CUDA graph (it syncs with the host, e.g. .item() or a "
            f"Python branch on a tensor, or reads the clock): {err}")

    def _record(self, j):
        """``(replay, rows)`` of the j-step graph."""
        rows = torch.empty((len(self.names), j), dtype=self.row_dtype,
                           device=self.s.device)
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        try:
            with tracing.span("graph_capture", setup=True), \
                    torch.cuda.graph(graph, pool=self.pool):
                self._steps(j, rows)
        except Exception as e:
            if self.failed is None:
                raise
            raise self._refusal(self.failed) from e
        finally:
            counted = _take_counts(before)

        def replay():
            graph.replay()
            _add_counts(counted)
        return replay, rows

    def __call__(self, state: State):
        c = state.clock
        if self.s is None:
            self._warm(state)
        self.s.copy_(stack(state))
        series = torch.empty((len(self.names), self.n_steps),
                             dtype=self.row_dtype, device=self.s.device)
        for offset, j in self.plan:
            if j not in self.graphs:
                self.graphs[j] = self._record(j)
            replay, rows = self.graphs[j]
            with tracing.span("graph_replay"):
                replay()
            series[:, offset:offset + j].copy_(rows)
        out = unstack(self.s.clone(), Clock(c.time + self.n_steps * self.dt,
                                            c.iteration + self.n_steps))
        return out, dict(zip(self.names, series.unbind(0)))


class KernelStepper:
    """``Simulation(model, ..., stepper=KernelStepper(model))`` drives a
    run through the CUDA kernels (the ``step_fn(dt, n_steps,
    diagnostics)`` contract of the model's own step).

    :meth:`advance` takes the resident kernel (:func:`multistep`) where
    :func:`takes_resident`, else one-substage launches
    (:func:`windowed_steps`). A chunk without per-step diagnostics is one
    :meth:`advance` call. With them the state has to surface after every
    step: on the card the chunk is a :class:`GraphChunk`, the launches of
    each step and the series captured in CUDA graphs; on the CPU it is
    :meth:`one_step` through ``run_steps``, eagerly."""

    def __init__(self, model):
        kernel_params(model)
        self.model = model

    def advance(self, s, dt, n_steps):
        """``n_steps`` RK3 steps on stacked fields ``s`` through the route
        :func:`takes_resident` picks on the card (the plain version on a
        CPU tensor)."""
        if s.is_cuda and not takes_resident(self.model, s):
            return windowed_steps(self.model, s, dt, n_steps)
        return multistep(self.model, s, dt, n_steps)

    def one_step(self, dt):
        """``state -> state``: one RK3 step, one :meth:`advance` call (the
        clock is the caller's to set)."""
        def fn(state: State) -> State:
            return unstack(self.advance(stack(state), dt, 1), state.clock)
        return fn

    def step_fn(self, dt, n_steps: int = 1, diagnostics=None):
        if diagnostics is None:
            def fn(state: State) -> State:
                c = state.clock
                s = self.advance(stack(state), dt, n_steps)
                return unstack(s, Clock(c.time + n_steps * dt,
                                        c.iteration + n_steps))
            return fn
        if torch.device(self.model.grid.device).type == "cuda":
            return GraphChunk(self, dt, n_steps, diagnostics)
        return run_steps(self.one_step(dt), dt, n_steps, diagnostics)
