"""2-D domain decomposition over processes, port of
:mod:`swmhd_tpu.parallel.decomposition` onto ``torch.distributed``.

Each rank owns one ``(Nx/px, Ny/py)`` tile of every field, on its own
device. Per RK3 substage a tile is padded with a ring of ``halo`` cells
from its four neighbours (:func:`post_halo_axis`: x first, then y on the
x-padded tile, so the corners come from the diagonal neighbours), the
substage runs on the padded tile, and the result is cropped back.

Two steppers, one contract (``step_fn(dt, n_steps, diagnostics)``):

- :meth:`DomainDecomposition.step_fn`, the plain step: the model's own
  tendency code on the padded tile, with an
  :class:`~swmhd_tpu_torch.operators.IndexContext` that puts every wall
  at the domain's global walls. Every topology and mesh.
- :meth:`DomainDecomposition.fused_step_fn` (the counterpart of the TPU
  kernel ``DomainDecomposition.fused_step_fn``): per substage one halo
  exchange along the sharded axes, then one
  :func:`~swmhd_tpu_torch.ops.substage.substage` call, the hand-written
  CUDA substage run on the exchanged tile. Needs periodic x; bounded y
  needs py == 1, so each tile holds whole rows.

With ``overlap=True`` both split each substage as JAX's
``_local_tendencies_overlap`` does, where ``3 * halo <= min(nx, ny)``
(:attr:`DomainDecomposition.split`; else the ordinary step): the
exchange is posted, the interior is computed from the unpadded tile
meanwhile, and the edge bands from slabs of the padded tile afterwards
(:meth:`~DomainDecomposition.post_pad`, :func:`band_slabs`); the kernel
step launches the tile kernel on each region in place
(:meth:`~DomainDecomposition.split_substage`).

The TPU version's alignment rules (an 8-row halo, a y pad rounded up to
128 lanes) do not carry over: a halo of ``model.exchange_halo`` suffices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import diagnostics as diag
from .. import operators as op
from ..grid import PERIODIC
from ..models.shallow_water import RK3_GAMMA, RK3_ZETA, run_steps
from ..models.state import State
from ..ops import substage as K
from . import multihost

# Halo of the diagnostics and field outputs: the integrands read at most
# one neighbour on each side of each axis (ℑᶜ, ∂ᶠ, ζ, B at centers).
DIAG_HALO = 2


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``px × py`` grid of processes; rank ``r`` holds tile
    ``(r // py, r % py)`` (row-major)."""
    px: int
    py: int

    @property
    def size(self) -> int:
        return self.px * self.py

    def coords(self, rank: int) -> Tuple[int, int]:
        return divmod(rank, self.py)

    def rank(self, ix: int, iy: int) -> int:
        return (ix % self.px) * self.py + (iy % self.py)


def make_mesh(n: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A mesh of ``n`` processes (default: the world size) in the squarest
    factorisation, or of ``shape``."""
    if n is None:
        n = shape[0] * shape[1] if shape is not None \
            else multihost.world_size()
    if shape is None:
        px = int(math.sqrt(n))
        while n % px:
            px -= 1
        shape = (px, n // px)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} processes")
    return Mesh(*shape)


def post_halo_axis(a: torch.Tensor, H: int, axis: int, n_shards: int,
                   index: int, low_rank: int, high_rank: int,
                   periodic: bool):
    """Start padding ``a`` along ``axis`` with ``H`` cells from the ring
    neighbours ``low_rank`` and ``high_rank`` (tile ``index`` of
    ``n_shards``): the exchange is posted (``multihost.Exchange``),
    and the function returned waits for it and returns the padded tensor.
    One shard wraps locally. On a bounded axis the edge tiles replicate
    their own edge cells and exchange nothing across the wall."""
    if H == 0:
        return lambda: a
    n = a.shape[axis]
    low, high = a.narrow(axis, 0, H), a.narrow(axis, n - H, H)
    has_low = periodic or index > 0
    has_high = periodic or index < n_shards - 1
    if n_shards == 1:
        halos = (high, low) if periodic else (None, None)
        received = lambda: halos                         # noqa: E731
    else:
        received = multihost.Exchange(
            low if has_low else None, high if has_high else None,
            low_rank, high_rank).wait

    def finish():
        lo_halo, hi_halo = received()
        if lo_halo is None:
            lo_halo = a.narrow(axis, 0, 1).expand_as(low)
        if hi_halo is None:
            hi_halo = a.narrow(axis, n - 1, 1).expand_as(high)
        return torch.cat([lo_halo, a, hi_halo], axis)
    return finish


def band_slabs(nx: int, ny: int, hx: int, hy: int):
    """The edge bands of the overlap split of an ``nx × ny`` tile padded
    by ``(hx, hy)``, in JAX's order (bottom, top, left, right; an axis
    with no halo has none): ``[(rows, cols, at)]``, the slab of the padded
    tile a band reads (3h wide across its edge) and the origin of the h
    rows or columns it writes in the unpadded tile."""
    X, Y = slice(0, nx + 2 * hx), slice(0, ny + 2 * hy)
    bands = []
    if hx:
        bands += [(slice(0, 3 * hx), Y, (0, 0)),
                  (slice(nx - hx, nx + 2 * hx), Y, (nx - hx, 0))]
    if hy:
        bands += [(X, slice(0, 3 * hy), (0, 0)),
                  (X, slice(ny - hy, ny + 2 * hy), (0, ny - hy))]
    return bands


class DomainDecomposition:
    """Shards a :class:`~swmhd_tpu_torch.models.ShallowWaterModel`'s step
    over a :class:`Mesh` of processes, one tile per rank.

    ``model`` is the global model (its grid the whole domain, its device
    this rank's). ``halo`` defaults to ``model.exchange_halo``.
    ``overlap`` asks for the interior/edge-band split of each substage
    (the module's docstring)."""

    def __init__(self, model, mesh: Optional[Mesh] = None,
                 halo: Optional[int] = None, overlap: bool = False):
        self.model = model
        self.overlap = overlap
        self.mesh = mesh if mesh is not None else make_mesh()
        if self.mesh.size != multihost.world_size():
            raise ValueError(f"mesh {self.mesh.px}x{self.mesh.py} needs "
                             f"{self.mesh.size} processes, the group has "
                             f"{multihost.world_size()}")
        g = model.grid
        self.px, self.py = self.mesh.px, self.mesh.py
        if g.Nx % self.px or g.Ny % self.py:
            raise ValueError(f"grid {g.Nx}x{g.Ny} not divisible by mesh "
                             f"{self.px}x{self.py}")
        self.nx, self.ny = g.Nx // self.px, g.Ny // self.py
        self.halo = model.exchange_halo if halo is None else halo
        if self.halo > min(self.nx, self.ny):
            raise ValueError("halo wider than local tile")
        self.rank = multihost.rank()
        self.ix, self.iy = self.mesh.coords(self.rank)
        self.ox, self.oy = self.ix * self.nx, self.iy * self.ny
        H = self.halo
        # the padded tile's grid: same spacings, the global topology (the
        # IndexContext keeps the walls global)
        self.local_grid = dataclasses.replace(
            g, Nx=self.nx + 2 * H, Ny=self.ny + 2 * H,
            Lx=g.dx * (self.nx + 2 * H), Ly=g.dy * (self.ny + 2 * H))
        self.local_model = dataclasses.replace(model, grid=self.local_grid)
        self._streams = {}

    @property
    def split(self) -> bool:
        """Whether a substage takes the overlap split: ``overlap`` and
        ``3 * halo <= min(nx, ny)`` (JAX's rule; a band reads 3·halo
        rows), else it is the ordinary step."""
        return self.overlap and 3 * self.halo <= min(self.nx, self.ny)

    # -- tiles ----------------------------------------------------------------

    @property
    def bounds(self) -> Tuple[int, int, int, int]:
        """``(x0, x1, y0, y1)``: this rank's tile in global indices."""
        return self.ox, self.ox + self.nx, self.oy, self.oy + self.ny

    def shard_state(self, state: State) -> State:
        """This rank's tile of a global state, on the model's device."""
        x0, x1, y0, y1 = self.bounds
        dev = self.model.grid.device
        return state.replace(**{
            k: getattr(state, k)[x0:x1, y0:y1].to(dev).contiguous()
            for k in State.FIELDS})

    def gather_state(self, tile: State) -> State:
        """The global state on every rank, from each rank's tile
        (collective)."""
        parts = multihost.all_gather(K.stack(tile))
        rows = [torch.cat(parts[ix * self.py:(ix + 1) * self.py], 2)
                for ix in range(self.px)]
        return K.unstack(torch.cat(rows, 1), tile.clock)

    # -- halo machinery ---------------------------------------------------------

    def _post_axis(self, s, H, axis):
        g = self.model.grid
        if axis == 1:
            return post_halo_axis(s, H, 1, self.px, self.ix,
                                  self.mesh.rank(self.ix - 1, self.iy),
                                  self.mesh.rank(self.ix + 1, self.iy),
                                  g.topology_x == PERIODIC)
        return post_halo_axis(s, H, 2, self.py, self.iy,
                              self.mesh.rank(self.ix, self.iy - 1),
                              self.mesh.rank(self.ix, self.iy + 1),
                              g.topology_y == PERIODIC)

    def _pad_axis(self, s, H, axis):
        return self._post_axis(s, H, axis)()

    def _comm_stream(self, s):
        """The side stream of the split's exchange on ``s``'s card (high
        priority, so its few small kernels pass the interior's blocks);
        None on the CPU."""
        if not s.is_cuda:
            return None
        if s.device not in self._streams:
            self._streams[s.device] = torch.cuda.Stream(s.device,
                                                        priority=-1)
        return self._streams[s.device]

    def post_pad(self, s: torch.Tensor, hx: int, hy: int):
        """Start padding stacked tile fields by ``(hx, hy)`` (collective),
        as :meth:`pad` does, and return a function that finishes it and
        returns the padded tile. The first round that crosses ranks is
        posted at once: x, or y on the x-padded tile where the x pad is
        local (one tile along x); the function waits for it and runs the
        rest, so the corners still come from the diagonal neighbours.
        Work launched between the two, such as the interior of the split,
        runs beside the exchange: on a CUDA tensor the exchange's copies
        and concatenations run on a side stream (:meth:`_comm_stream`)
        that waits for the current stream's work so far, and the current
        stream waits for them in the function."""
        comm = self._comm_stream(s)
        ctx = torch.cuda.stream(comm) if comm else contextlib.nullcontext()
        if comm:
            main = torch.cuda.current_stream(s.device)
            comm.wait_stream(main)
            s.record_stream(comm)
        with ctx:
            if self.px == 1:
                rest = self._post_axis(self._pad_axis(s, hx, 1), hy, 2)
            else:
                posted = self._post_axis(s, hx, 1)
                rest = lambda: self._pad_axis(posted(), hy, 2)  # noqa: E731

        def finish():
            with ctx:
                p = rest()
            if comm:
                main.wait_stream(comm)
                p.record_stream(main)
            return p
        return finish

    def pad(self, s: torch.Tensor, H: Optional[int] = None) -> torch.Tensor:
        """Stacked tile fields ``(4, nx, ny)`` padded by ``H`` (default
        ``halo``) on both axes: one exchange along x, then one along y of
        the x-padded tile."""
        H = self.halo if H is None else H
        return self._pad_axis(self._pad_axis(s, H, 1), H, 2)

    def crop(self, a: torch.Tensor, H: Optional[int] = None) -> torch.Tensor:
        H = self.halo if H is None else H
        return a[..., H:H + self.nx, H:H + self.ny]

    @contextlib.contextmanager
    def index_context(self, H: int, dx: int = 0, dy: int = 0):
        """Global indices for a tile padded by ``H`` on both axes, or for
        the slab of it that starts ``(dx, dy)`` into it."""
        g = self.model.grid
        prev = op.set_index_ctx(op.IndexContext(
            ox=self.ox - H + dx, oy=self.oy - H + dy, gNx=g.Nx, gNy=g.Ny))
        try:
            yield
        finally:
            op.set_index_ctx(prev)

    def _tendencies(self, s, H, dx=0, dy=0):
        """The model's tendencies on stacked fields ``s`` (the tile padded
        by ``H``, or its slab from ``(dx, dy)``) under global indices."""
        with self.index_context(H, dx, dy):
            return K.stack(self.local_model.tendencies(State(*s.unbind(0))))

    # -- the plain step -------------------------------------------------------

    def _local_tendencies(self, s):
        if self.split:
            return self._local_tendencies_overlap(s)
        return self.crop(self._tendencies(self.pad(s), self.halo))

    def _local_tendencies_overlap(self, s):
        """JAX's split (``_local_tendencies_overlap``): the interior from
        the unpadded tile, which needs no halo, while the exchange is in
        flight (:meth:`post_pad`), then the four edge bands of width
        ``halo`` from 3·halo-wide slabs of the padded tile, each under its
        own global index origin, written bottom, top, left, right."""
        H, nx, ny = self.halo, self.nx, self.ny
        finish = self.post_pad(s, H, H)
        # valid at distance >= H from the tile's edge; the ring is
        # overwritten by the bands
        G = self._tendencies(s, 0)
        p = finish()
        for rows, cols, (x, y) in band_slabs(nx, ny, H, H):
            # a slab of 3H yields its middle H (radius-H stencils)
            Gb = self._tendencies(p[:, rows, cols], H, rows.start,
                                  cols.start)[:, H:-H, H:-H]
            G[:, x:x + Gb.shape[1], y:y + Gb.shape[2]] = Gb
        return G

    def _local_step(self, s, dt):
        G_prev = None
        for gamma, zeta in zip(RK3_GAMMA, RK3_ZETA):
            G = self._local_tendencies(s)
            if G_prev is None:
                s = s + dt * gamma * G
            else:
                s = s + dt * (gamma * G + zeta * G_prev)
            G_prev = G
        return s

    def step_fn(self, dt, n_steps: int = 1, diagnostics=None):
        """``tile -> tile`` (or ``(tile, series)`` with ``diagnostics``)
        advancing ``n_steps`` RK3 steps of the plain tendency code on the
        exchanged tiles. ``diagnostics`` is written for a global state
        (``state -> {name: 0-d tensor}``) and returns global values on
        every rank (:meth:`tile_diagnostics`)."""
        need = self.model.exchange_halo
        if self.halo < need:
            raise ValueError(
                f"halo {self.halo} < composed tendency radius {need} "
                f"(model.exchange_halo); the exchanged ring would be too "
                f"thin and tiles would silently diverge")

        def one_step(state):
            return K.unstack(self._local_step(K.stack(state), dt),
                             state.clock)
        return run_steps(one_step, dt, n_steps,
                         self.tile_diagnostics(diagnostics))

    # -- the kernel step (K3) ---------------------------------------------------

    def kernel_halo(self) -> Tuple[int, int]:
        """``(hx, hy)`` of the kernel step: ``halo`` along a sharded axis,
        0 along an unsharded one, whose whole extent the tile holds and
        the kernel wraps or walls in place. ``ValueError`` for a layout
        the kernel step does not take (JAX's rules)."""
        g = self.model.grid
        if g.topology_x != PERIODIC:
            raise ValueError("fused sharded step: periodic x required")
        if self.py > 1 and g.topology_y != PERIODIC:
            raise ValueError(
                "fused sharded step: BOUNDED y needs the y mesh axis "
                "unsharded (py == 1) so each tile holds complete rows; "
                f"got py={self.py}")
        if self.halo < self.model.exchange_halo:
            raise ValueError(f"fused sharded step needs a halo >= "
                             f"{self.model.exchange_halo}; got {self.halo}")
        return (self.halo if self.px > 1 else 0,
                self.halo if self.py > 1 else 0)

    def pad_for_kernel(self, s: torch.Tensor) -> torch.Tensor:
        """Stacked tile fields padded as the kernel step pads them per
        substage (collective): :meth:`kernel_halo` cells, x first."""
        hx, hy = self.kernel_halo()
        return self._pad_axis(self._pad_axis(s, hx, 1), hy, 2)

    def fused_step_fn(self, dt, n_steps: int = 1, diagnostics=None):
        """Like :meth:`step_fn`, with each substage one halo exchange
        (:meth:`pad_for_kernel`) and one
        :func:`~swmhd_tpu_torch.ops.substage.substage` call on the padded
        tile, or with :attr:`split` :meth:`split_substage`. G_prev stays on
        the unpadded tile and is never exchanged. On CPU tensors the
        substage takes its plain version."""
        halo = self.kernel_halo()
        model = self.model

        def one_step(state):
            s, g = K.stack(state), None
            for stage in range(3):
                if self.split:
                    s, g = self.split_substage(s, dt, stage, g)
                else:
                    s, g = K.substage(model, self.pad_for_kernel(s), dt,
                                      stage, g, write_G=stage < 2, halo=halo)
            return K.unstack(s, state.clock)
        return run_steps(one_step, dt, n_steps,
                         self.tile_diagnostics(diagnostics))

    def split_substage(self, s, dt, stage, g_prev=None):
        """Substage ``stage`` of the kernel step as the overlap split, on
        stacked tile fields ``s``: ``(s_new, G)``, G None in substage 2.

        The exchange is posted (:meth:`post_pad`), the interior is one
        launch on the unpadded tile with the kernel's halo (its own outer
        ring read as the halo: the points that need nothing from a
        neighbour), then each band of :func:`band_slabs` is one launch on
        its slab of the padded tile; every launch reads its region of
        G_prev and writes its region of the new state and G in place
        (``substage(..., out=, at=)``). JAX's kernel step has no split:
        the port carries it to the tile kernel because its sweep times
        this step where JAX's timed the plain one, so the sweep's overlap
        rows measure the split on the route they time."""
        hx, hy = halo = self.kernel_halo()
        write_G = stage < 2
        finish = self.post_pad(s, hx, hy)
        out = (torch.empty_like(s), torch.empty_like(s) if write_G else None)
        K.substage(self.model, s, dt, stage, g_prev, write_G, halo=halo,
                   out=out, at=halo)
        p = finish()
        for rows, cols, at in band_slabs(self.nx, self.ny, hx, hy):
            K.substage(self.model, p[:, rows, cols], dt, stage, g_prev,
                       write_G, halo=halo, out=out, at=at)
        return out

    def fused_stepper(self):
        """A ``Simulation`` stepper driving :meth:`fused_step_fn`:
        ``Simulation(model, ..., stepper=dd.fused_stepper())``."""
        self.kernel_halo()
        return _FusedStepper(self)

    # -- diagnostics and outputs on tiles -----------------------------------------

    def diagnostic_view(self, tile: State) -> State:
        """The tile padded by :data:`DIAG_HALO`, as diagnostics and field
        outputs see it (collective: one exchange)."""
        return K.unstack(self.pad(K.stack(tile), DIAG_HALO), tile.clock)

    def tile_diagnostics(self, fn):
        """``fn`` (``state -> {name: 0-d tensor}``, written for a global
        state) as a function of this rank's tile with global values on
        every rank: ``fn`` runs on :meth:`diagnostic_view` with global
        indices; the integrals and extrema of
        :mod:`~swmhd_tpu_torch.diagnostics` crop the halo, and their
        values are reduced over ranks, the sums in one ``all_reduce`` and
        the extrema in one more. A field that ``fn`` closes over (the
        initial height of the potential energy) is a
        :meth:`diagnostic_view` too."""
        if fn is None:
            return None

        def tile_fn(tile: State):
            view = self.diagnostic_view(tile)
            with self.index_context(DIAG_HALO), \
                    diag.tile_reduction(DIAG_HALO) as red:
                out = fn(view)
            return red.reduce(out)
        return tile_fn

    def tile_fields(self, fn):
        """``fn`` (``state -> {name: field}``, written for a global state)
        as a function of this rank's tile returning tile fields: run on
        :meth:`diagnostic_view`, cropped."""
        def tile_fn(tile: State):
            view = self.diagnostic_view(tile)
            with self.index_context(DIAG_HALO):
                out = fn(view)
            return {k: self.crop(v, DIAG_HALO) for k, v in out.items()}
        return tile_fn


class _FusedStepper:
    """``Simulation``-compatible stepper of
    :meth:`DomainDecomposition.fused_step_fn`."""

    def __init__(self, dd: DomainDecomposition):
        self.dd = dd
        self.model = dd.model
        self.tile_diagnostics = dd.tile_diagnostics

    def step_fn(self, dt, n_steps: int = 1, diagnostics=None):
        return self.dd.fused_step_fn(dt, n_steps, diagnostics)
