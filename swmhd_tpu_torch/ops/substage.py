"""The RK3 substage on the card: wrappers of ``csrc/substage.cu``, their
plain PyTorch versions, and the :class:`KernelStepper` that drives a
:class:`~swmhd_tpu_torch.simulation.Simulation` through them.

Counterparts of the Pallas kernels of ``swmhd_tpu/ops/fused_step.py``:
:func:`substage` of the windowed substage (``fused_step_fn``) and
:func:`multistep` of the resident multi-step kernel
(``resident_step_fn``). :func:`substage` with a ``halo`` is also the
counterpart of the sharded substage of
``swmhd_tpu/parallel/decomposition.py`` (``fused_step_fn``): the same
substage on a tile padded with a halo exchanged from its neighbours, its
launches counted under the branches with an exchanged axis. The
prognostics travel stacked as one ``(4, Nx, Ny)`` tensor in the order h,
u, v, A.

The vector-invariant substage is one kernel over 2-D tiles of ``(TX,
VI_TILE_Y)`` points with its intermediates in shared memory; the wrapper
picks TX (:func:`vi_tile_shape`) and allocates no intermediates for it.
Its plain emulation tile by tile is
:func:`swmhd_tpu_torch.ops.vi_tile.substage_tiles_reference`. The
conservative substage is three kernels passing intermediates through
device memory.

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
``<wrapper>.launches_by_branch``; each plain version counts its calls in
``<function>.calls``, so a run can show which path it took.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from ..grid import BOUNDED, PERIODIC
from ..models.shallow_water import (RK3_GAMMA, RK3_ZETA, CONSERVATIVE,
                                    VECTOR_INVARIANT, VELOCITY_STENCIL,
                                    VORTICITY_STENCIL, run_steps)
from ..models.state import Clock, State
from ..physics.diffusion import BiharmonicDiffusion, LaplacianDiffusion

# intermediates between the kernels of one conservative substage; a
# biharmonic closure adds its three inner Laplacians. The
# vector-invariant substage is one kernel over 2-D tiles whose
# intermediates stay in shared memory (csrc/vi_tile.cuh).
N_TMP = {CONSERVATIVE: 16}
BIHARMONIC_TMP = 3
# the vector-invariant tile kernel: tiles of (TX, VI_TILE_Y) points, TX
# one of VI_TILE_X; the state windows and the intermediates span the
# tile and VI_RADIUS cells around it (the composed read radius); the box
# holds VI_BOX_ARRAYS intermediates at a time, VI_BIHARMONIC_ARRAYS more
# with a biharmonic closure (csrc/vi_tile.cuh vi_smem_bytes)
VI_TILE_Y, VI_TILE_X, VI_RADIUS = 32, (32, 16, 8), 3
VI_MAX_TILE_X = 64          # the most rows a tile may have (kViMaxTileX)
VI_BOX_ARRAYS, VI_BIHARMONIC_ARRAYS = 8, 2
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


def n_tmp(model) -> int:
    """The intermediates of one substage of ``model`` in device memory:
    none for the vector-invariant tile kernel."""
    if model.formulation != CONSERVATIVE:
        return 0
    return (N_TMP[CONSERVATIVE]
            + BIHARMONIC_TMP * isinstance(model.closure, BiharmonicDiffusion))


def _intermediates(model, s):
    n = n_tmp(model)
    return (torch.empty((n,) + tuple(s.shape[1:]), dtype=s.dtype,
                        device=s.device) if n else None)


def vi_smem_bytes(dtype, tile_x, biharmonic=False) -> int:
    """Shared memory a block of the vector-invariant tile kernel takes:
    the four state windows and the box's intermediates, each (tile_x +
    2·VI_RADIUS) × (VI_TILE_Y + 2·VI_RADIUS) values."""
    box = (tile_x + 2 * VI_RADIUS) * (VI_TILE_Y + 2 * VI_RADIUS)
    arrays = 4 + VI_BOX_ARRAYS + VI_BIHARMONIC_ARRAYS * bool(biharmonic)
    return dtype.itemsize * box * arrays


@functools.lru_cache(maxsize=None)
def vi_tile_shape(nx, ny, dtype, biharmonic, smem_limit, sms):
    """``(TX, VI_TILE_Y)`` of the vector-invariant tile kernel on an
    unpadded ``nx × ny`` output, on a card of ``sms`` SMs whose opt-in
    shared memory a block is ``smem_limit`` bytes (:func:`card_limits`):
    among the TX of VI_TILE_X whose block leaves room for two in that
    limit, the largest that still makes two blocks an SM, else the
    smallest. Cached: every substage call asks."""
    fits = [t for t in VI_TILE_X
            if 2 * vi_smem_bytes(dtype, t, biharmonic) <= smem_limit]
    for t in fits:
        if math.ceil(nx / t) * math.ceil(ny / VI_TILE_Y) >= 2 * sms:
            return t, VI_TILE_Y
    return fits[-1], VI_TILE_Y


@functools.lru_cache(maxsize=None)
def _lib_fn(name, dtype):
    # once per process: _build.load() hashes the sources on every call
    from . import _build
    return _build.load().fn(name, "f32" if dtype == torch.float32 else "f64")


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
    with torch.cuda.device(index):
        limit = _build.load().fn("swmhd_smem_limit")()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return limit, sms


def _tile_x(model, nx, ny, s):
    """The rows of the vector-invariant kernel's tiles on an unpadded ``nx
    × ny`` output of the stacked fields ``s`` (a CUDA tensor), by
    :func:`vi_tile_shape` on its card; 0 for the conservative kernels,
    which take none."""
    if model.formulation == CONSERVATIVE:
        return 0
    return vi_tile_shape(nx, ny, s.dtype,
                         isinstance(model.closure, BiharmonicDiffusion),
                         *card_limits(s.device.index))[0]


def vi_tile_info(dtype, branch, tile_x):
    """``(shared memory bytes a block, registers a thread, resident blocks
    an SM)`` of the vector-invariant tile kernel that a launch of
    :class:`Branch` ``branch`` with tiles of ``tile_x`` rows takes, from
    the CUDA runtime (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    b = Branch(*branch)
    opt = any(b[3:])        # a switch off the default model's
    biharmonic = CLOSURES[b.closure] is BiharmonicDiffusion
    out = (ctypes.c_int * 3)()
    err = _lib_fn("swmhd_vi_tile_info", dtype)(
        b.mode_x, b.mode_y, int(opt), int(tile_x), int(biharmonic),
        ctypes.addressof(out))
    _raise_on(err, "swmhd_vi_tile_info")
    return tuple(out)


def substage(model, s, dt, stage, g_prev=None, write_G=True, *,
             halo=(0, 0)):
    """One Le–Moin substage on stacked fields ``s``; returns ``(s_new,
    G)`` with ``G`` None unless ``write_G``.

    With ``halo = (hx, hy)``, ``s`` is a tile of ``model``'s domain padded
    by cells the caller has exchanged from the neighbouring tiles, ``(4,
    nx + 2hx, ny + 2hy)``; ``g_prev`` and the results are ``(4, nx, ny)``.
    A padded axis must be periodic in ``model`` and is read from the halo
    (the exchanged axis mode); an axis with no pad is the whole domain's
    and wraps or walls. The vector-invariant kernel's tiles are
    :func:`vi_tile_shape`'s."""
    hx, hy = halo
    g = model.grid
    for h, topo, name in ((hx, g.topology_x, "x"), (hy, g.topology_y, "y")):
        if h < 0 or (h and topo != PERIODIC):
            raise ValueError(f"a tile pads only a periodic axis: {name} is "
                             f"{topo}, halo {h}")
    if s.device.type == "cpu":
        s_new, G = substage_reference(model, s, dt, stage, g_prev, halo)
        return s_new, (G if write_G else None)
    params = kernel_params(model)
    branch = params.branch._replace(
        mode_x=EXCHANGED_AXIS if hx else params.wall_x,
        mode_y=EXCHANGED_AXIS if hy else params.wall_y)
    nx, ny = ((s.shape[1] - 2 * hx, s.shape[2] - 2 * hy) if s.dim() == 3
              else (0, 0))
    if (s.shape[0] != 4 or nx < 1 or ny < 1
            or (not hx and nx != g.Nx) or (not hy and ny != g.Ny)):
        raise ValueError(f"stacked fields must be (4, {g.Nx}, {g.Ny}), or "
                         f"a tile (4, nx + 2*{hx}, ny + 2*{hy}) with the "
                         f"whole domain on an unpadded axis; got "
                         f"{tuple(s.shape)}")
    _check_fields(s)
    if (stage > 0) != (g_prev is not None):
        raise ValueError("substages 1 and 2 take G_prev; substage 0 does not")
    shape = (4, nx, ny)
    if g_prev is not None and (tuple(g_prev.shape) != shape
                               or g_prev.dtype != s.dtype
                               or g_prev.device != s.device
                               or not g_prev.is_contiguous()):
        raise ValueError(f"G_prev must be a contiguous {shape} tensor like "
                         f"the stacked fields")
    tile_x = _tile_x(model, nx, ny, s)
    s_out = torch.empty(shape, dtype=s.dtype, device=s.device)
    g_out = torch.empty_like(s_out) if write_G else None
    tmp = _intermediates(model, s)
    fn = _lib_fn("swmhd_substage", s.dtype)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    err = fn(_ptr(s), _ptr(g_prev), _ptr(s_out), _ptr(g_out), _ptr(tmp),
             nx, ny, hx, hy, *branch, tile_x, *params[8:], float(dt),
             RK3_GAMMA[stage], RK3_ZETA[stage], stream)
    substage.launches += 1
    substage.launches_by_branch[branch] += 1
    _raise_on(err, "swmhd_substage")
    return s_out, g_out


def multistep(model, s, dt, n_steps):
    """``n_steps`` RK3 steps on stacked fields ``s`` (left unchanged)."""
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
    tmp = _intermediates(model, s)
    fn = _lib_fn("swmhd_multistep", s.dtype)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    err = fn(_ptr(s), _ptr(out), _ptr(work), _ptr(gbuf), _ptr(tmp),
             g.Nx, g.Ny, *params[:8], _tile_x(model, g.Nx, g.Ny, s),
             *params[8:], float(dt), int(n_steps), stream)
    multistep.launches += 1
    multistep.launches_by_branch[params.branch] += 1
    _raise_on(err, "swmhd_multistep")
    return out


def reset_counters():
    for f in (substage, multistep):
        f.launches = 0
        f.launches_by_branch = collections.Counter()
    for f in (substage_reference, multistep_reference):
        f.calls = 0


reset_counters()


# -- the stepper -------------------------------------------------------------------

def stack(state: State) -> torch.Tensor:
    return torch.stack(state.fields())


def unstack(s: torch.Tensor, clock: Clock) -> State:
    h, u, v, A = s.unbind(0)
    return State(h=h, u=u, v=v, A=A, clock=clock)


class KernelStepper:
    """``Simulation(model, ..., stepper=KernelStepper(model))`` drives a
    run through the CUDA substage (the ``step_fn(dt, n_steps,
    diagnostics)`` contract of the model's own step).

    A chunk without per-step diagnostics is one :func:`multistep` call.
    With them the state has to surface after every step, so each step is
    three :func:`substage` calls and the series stays on the device."""

    def __init__(self, model):
        kernel_params(model)
        self.model = model

    def step_fn(self, dt, n_steps: int = 1, diagnostics=None):
        model = self.model
        if diagnostics is None:
            def fn(state: State) -> State:
                c = state.clock
                s = multistep(model, stack(state), dt, n_steps)
                return unstack(s, Clock(c.time + n_steps * dt,
                                        c.iteration + n_steps))
            return fn

        def one_step(state: State) -> State:
            s, g = stack(state), None
            for stage in range(3):
                s, g = substage(model, s, dt, stage, g, write_G=stage < 2)
            return unstack(s, state.clock)
        return run_steps(one_step, dt, n_steps, diagnostics)
