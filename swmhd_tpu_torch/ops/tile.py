"""The 2-D tile probes on the card: wrappers of ``csrc/tile.cu``, with
their plain PyTorch versions beside them.

Counterparts of the three Pallas probes of ``benchmarks/``:

- :func:`window_probe` of ``exp_dma.py:21`` ``probe``: stage the ``(TX +
  2HX, TY + 2HY)`` window of each tile of a wrap-padded array, write its
  interior + 1;
- :func:`wrap_probe` of ``exp_dma2.py:22`` ``probe(case)``: stage a
  48-row window of whole rows by one of four copy patterns
  (:data:`WRAP_CASES`), write its 32 interior rows + 1;
- :func:`tendency_tiles` of ``exp_fused2d.py:72`` ``make_probe``: the
  tendency G of the ``bench.py`` model (vector-invariant, periodic, WENO5
  with the VelocityStencil, no closure, no background gradient) evaluated
  per 2-D tile from a window ``halo`` points wide, all of G or the part a
  split names (:data:`SPLITS`), by the vector-invariant substage kernel's
  own phases (``csrc/tendency_tile.cuh``).

Dispatch: on a CPU tensor a wrapper runs its plain version; on a CUDA
tensor it launches the kernel or raises. The load probes launch the
:class:`LoadPlan` that :func:`load_plan` makes from the input's shape:
branch ``"tma"`` (boxes of at most 256 × 256 dealt among P blocks a tile)
where TMA can describe the input, else ``"cp.async"`` (one block a tile).
A window over the card's opt-in shared memory per block raises
``ValueError`` naming both sizes (the counterpart of the Mosaic refusals
the JAX probes printed as FAILED), whatever the plan's P; a
model other than the probe's configuration, tiles that do not divide the
grid, a halo under :data:`TILE_RADIUS` and, for :func:`tendency_tiles`,
tile columns outside :data:`TILE_COLUMNS` or rows over
:data:`TILE_MAX_ROWS` raise ``ValueError`` on either device. Each
wrapper counts its launches in ``<wrapper>.launches`` and by shape in
``<wrapper>.launches_by_shape``, the load probes also by branch in
``<wrapper>.launches_by_branch``; each plain version counts its calls in
``<function>.calls``.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from ..models.state import State
from .substage import Branch, branch_label, kernel_params

# composed read radius of the vector-invariant tendency: the least halo
TILE_RADIUS = 3
# the splits of exp_fused2d.py's tendency_parts and the fields of G each
# writes, in the order h, u, v, A
SPLITS = ("full", "mom", "mt")
SPLIT_FIELDS = {"full": (0, 1, 2, 3), "mom": (1, 2), "mt": (0, 3)}
# the box arrays each split holds in shared memory at its peak: full and
# mom the momentum phase's 8, mt the mass and tracer phase's 4
N_TILE_TMP = {"full": 8, "mom": 8, "mt": 4}
# the tile columns the tendency kernel is built for, and its most rows
TILE_COLUMNS = (8, 16, 32, 64)
TILE_MAX_ROWS = 64
# exp_dma.py's fifth spec field: 1 asynchronous copies, 0 loads through
# registers
LOADS = {0: "plain", 1: "async"}
# exp_dma2.py's cases and sizes: row tiles of WRAP_TX, halo WRAP_H
WRAP_CASES = ("window", "dst3d", "src8", "when")
WRAP_TX, WRAP_H = 32, 8
SMEM_REFUSED = -2           # tile.cu kSmemRefused
# the load probes' branches (tile.cu LoadBranch): "tma", boxes dealt among
# P blocks a tile, loaded by TMA (load 1) or through registers (load 0);
# "cp.async", one block a tile staging its whole window, for inputs TMA
# cannot describe (a base off 16 bytes, a row pitch off 16 bytes)
BRANCHES = ("tma", "cp.async")
BOX_MAX = 256               # a TMA box's largest extent along a dimension
LOAD_P = (1, 2, 4)          # the blocks a tile's window may be dealt among
# the P each load probe takes by default and the wrap probe's box width:
# the fastest on an H100 (PERF.md §6, chip_smoke.py phase 9)
WINDOW_P, WRAP_P, WRAP_BOX_COLS = 4, 4, 64


def window_smem_bytes(TX, TY, HX, HY) -> int:
    return 4 * (TX + 2 * HX) * (TY + 2 * HY)


def wrap_smem_bytes(m, tx=WRAP_TX, h=WRAP_H) -> int:
    return 4 * (tx + 2 * h) * m


def tile_smem_bytes(dtype, tile, halo, split) -> int:
    """The four state windows and the split's box arrays over the
    ``(TX + 6, TY + 6)`` box (tendency_tile.cuh
    ``tendency_smem_bytes``)."""
    TX, TY = tile
    word = torch.empty((), dtype=dtype).element_size()
    box = (TX + 2 * TILE_RADIUS) * (TY + 2 * TILE_RADIUS)
    return word * (4 * (TX + 2 * halo) * (TY + 2 * halo)
                   + N_TILE_TMP[split] * box)


def wrap_pad(a, hx, hy):
    """``a`` padded periodically by ``hx`` rows and ``hy`` columns on its
    last two axes, as the probes' ``concatenate`` pads."""
    if hx:
        a = torch.cat([a[..., -hx:, :], a, a[..., :hx, :]], dim=-2)
    if hy:
        a = torch.cat([a[..., -hy:], a, a[..., :hy]], dim=-1)
    return a


# -- launch plans of the load probes ------------------------------------------

@dataclasses.dataclass(frozen=True)
class LoadPlan:
    """How one launch of a load probe stages its windows (tile.cu
    ``BoxPlan``). The input is ``shape`` (padded rows × ``pitch``), the
    output ``n × m``; tile ``(i, j)``'s window is padded rows ``i·tx`` …
    ``i·tx + tx + 2hx``, columns ``j·ty`` … ``j·ty + ty + 2hy`` (the wrap
    probe: ``ty = m``, ``hy = 0``). Block ``(bx, by) = (j·pc + qc, i·pr +
    qr)`` takes row band ``qr`` of ``pr`` of the tile (``tx / pr``
    interior rows and ``hx`` halo rows on each side) and run ``qc`` of
    ``pc`` of its column boxes: ``nr × kc`` boxes of ``box = (rows,
    cols)``, each in ``128``-byte aligned shared memory after one 8-byte
    barrier a box. ``halo`` (the wrap probe's src8 and when) first loads
    ``hx`` rows into the top of each column's box. A "tma" block of the
    window probe writes its interior by 16-byte stores from its threads;
    one of the wrap probe, whose boxes' interior rows are dense, adds 1 in
    place and writes each box's by a TMA store."""
    shape: tuple
    spec: object            # (TX, TY, HX, HY) or a case of WRAP_CASES
    branch: str
    p: int
    box: tuple
    grid: tuple             # blocks along x (columns) and y (rows)
    smem_bytes: int
    n: int
    m: int
    tx: int
    ty: int
    hx: int
    hy: int
    pr: int
    pc: int
    nr: int
    kc: int
    halo: str               # "", "src8" or "when"

    def block(self, bx, by):
        """``(boxes, halo_boxes, interior)`` of block ``(bx, by)``:
        boxes and halo boxes as ``(row0, col0, rows, cols)`` of the padded
        input (halo box ``k`` lands in the top rows of box ``k·nr``), the
        interior it writes as ``(row0, col0, rows, cols)`` of the
        output."""
        i, qr = divmod(by, self.pr)
        j, qc = divmod(bx, self.pc)
        br, bc = self.box
        band = self.tx // self.pr
        row0 = i * self.tx + qr * band
        col0 = j * self.ty + qc * self.kc * bc
        boxes = [(row0 + a * br, col0 + k * bc, br, bc)
                 for k in range(self.kc) for a in range(self.nr)]
        hrow = self.n - self.hx if self.halo == "when" and i == 0 \
            else i * self.tx
        halo = ([(hrow, col0 + k * bc, self.hx, bc) for k in range(self.kc)]
                if self.halo else [])
        lo = max(col0, j * self.ty + self.hy)
        hi = min(col0 + self.kc * bc, (j + 1) * self.ty + self.hy)
        return boxes, halo, (row0, lo - self.hy, band, hi - lo)


def _round_up(v, m):
    return -(-v // m) * m


def _count(total, least, ok, step=1):
    """The smallest multiple of ``step`` at least ``least`` that divides
    ``total`` into parts for which ``ok(part)``; None if there is none."""
    for c in range(_round_up(max(least, 1), step), total + 1, step):
        if total % c == 0 and ok(total // c):
            return c
    return None


def load_plan(shape, spec, P=None, *, branch=None, aligned=True):
    """The :class:`LoadPlan` of a load probe on a padded input of
    ``shape``: the window probe for ``spec = (TX, TY, HX, HY[, load])``,
    the wrap probe for a case of :data:`WRAP_CASES`.

    ``branch`` defaults to ``"tma"`` where TMA can describe the input (an
    ``aligned`` base, a row pitch and a tile width of a multiple of 16
    bytes), else ``"cp.async"``; ``"cp.async"`` may be asked for any
    input. ``P`` (of :data:`LOAD_P`; ``"tma"`` only) deals a tile's window
    among P blocks: the window probe's by row band, the wrap probe's by
    runs of column boxes. It defaults to
    :data:`WINDOW_P` or :data:`WRAP_P`, or the largest P below that the
    shape allows. Boxes are the fewest that cut a block's part into equal
    ones of at most :data:`BOX_MAX` rows and columns, columns a multiple
    of 4 (the wrap probe's :data:`WRAP_BOX_COLS` wide where they fit).
    Raises ``ValueError`` for a shape or P that does not fit."""
    wrap = isinstance(spec, str)
    if wrap:
        n, m = _wrap_dims(shape, spec)
        tx, ty, hx, hy = WRAP_TX, m, WRAP_H, 0
        halo = spec if spec in ("src8", "when") else ""
    else:
        spec = tuple(spec[:4])
        tx, ty, hx, hy = spec
        n, m = _window_dims(shape, tx, ty, hx, hy)
        halo = ""
    pitch, py = shape[1], ty + 2 * hy
    # (a tile width of a multiple of 4 makes an even hy follow from pitch)
    describable = aligned and pitch % 4 == 0 and ty % 4 == 0
    branch = branch or ("tma" if describable else "cp.async")
    if branch not in BRANCHES:
        raise ValueError(f"unknown branch {branch!r}; the branches are "
                         f"{', '.join(BRANCHES)}")
    common = dict(shape=tuple(shape), spec=spec, branch=branch, n=n, m=m,
                  tx=tx, ty=ty, hx=hx, hy=hy, halo=halo)
    if branch == "cp.async":
        if P not in (None, 1):
            raise ValueError("the cp.async branch takes one block a tile "
                             "and its whole window: P 1")
        px = tx + 2 * hx
        return LoadPlan(**common, p=1, box=(px, py),
                        grid=(m // ty, n // tx), smem_bytes=4 * px * py,
                        pr=1, pc=1, nr=1, kc=1)
    if not describable:
        raise ValueError(f"TMA cannot describe the input {tuple(shape)} "
                         f"(aligned base {aligned}, tile width {ty}, column "
                         f"halo {hy}): its rows and boxes must start on 16 "
                         f"bytes")

    def boxes(P):
        """(br, bc, nr, kc) at P, or None."""
        if P not in LOAD_P or (not wrap and tx % P):
            return None
        rows = (tx if wrap else tx // P) + 2 * hx
        nr = _count(rows, -(-rows // BOX_MAX), lambda r: True)
        step = P if wrap else 1
        if wrap and py % WRAP_BOX_COLS == 0 \
                and (py // WRAP_BOX_COLS) % step == 0:
            nc = py // WRAP_BOX_COLS
        else:
            nc = _count(py, -(-py // BOX_MAX),
                        lambda c: c % 4 == 0 and c <= BOX_MAX, step)
        if nc is None or (halo and nr != 1):
            return None
        return rows // nr, py // nc, nr, nc // step

    if P is None:
        P = WRAP_P if wrap else WINDOW_P
        P = next((q for q in sorted(LOAD_P, reverse=True)
                  if q <= P and boxes(q) is not None), P)
    found = boxes(P)
    if found is None:
        raise ValueError(f"P = {P} (of {LOAD_P}) does not deal the "
                         f"{tx + 2 * hx}x{py} windows of {tuple(shape)} "
                         f"into boxes of at most {BOX_MAX}")
    br, bc, nr, kc = found
    nbox = nr * kc
    pr, pc = (1, P) if wrap else (P, 1)
    return LoadPlan(**common, p=P, box=(br, bc),
                    grid=(m // ty * pc, n // tx * pr),
                    smem_bytes=_round_up(8 * nbox, 128)
                    + nbox * _round_up(4 * br * bc, 128),
                    pr=pr, pc=pc, nr=nr, kc=kc)


# -- plain versions -----------------------------------------------------------

def window_probe_reference(x_padded, TX, TY, HX, HY, load=1):
    """Each tile's ``(TX + 2HX, TY + 2HY)`` window of ``x_padded`` copied
    out, its interior + 1 written; both loads compute this."""
    window_probe_reference.calls += 1
    N, M = _window_shape(x_padded, TX, TY, HX, HY, load)
    out = torch.empty((N, M), dtype=x_padded.dtype, device=x_padded.device)
    for i in range(N // TX):
        for j in range(M // TY):
            buf = x_padded[i * TX:i * TX + TX + 2 * HX,
                           j * TY:j * TY + TY + 2 * HY].clone()
            out[i * TX:(i + 1) * TX, j * TY:(j + 1) * TY] = \
                buf[HX:HX + TX, HY:HY + TY] + 1.0
    return out


def wrap_probe_reference(x_padded, case):
    """Each row tile's window of ``x_padded`` staged as ``case`` stages it,
    its interior rows + 1 written."""
    wrap_probe_reference.calls += 1
    N, M = _wrap_dims(tuple(x_padded.shape), case)
    tx, h = WRAP_TX, WRAP_H
    out = torch.empty((N, M), dtype=x_padded.dtype, device=x_padded.device)
    buf = torch.empty((tx + 2 * h, M), dtype=x_padded.dtype,
                      device=x_padded.device)
    for i in range(N // tx):
        window = x_padded[i * tx:i * tx + tx + 2 * h]
        if case == "src8":
            buf[:h] = window[:h]
        elif case == "when":
            row0 = i * tx if i > 0 else N - h
            buf[:h] = x_padded[row0:row0 + h]
        buf[:] = window
        out[i * tx:(i + 1) * tx] = buf[h:h + tx] + 1.0
    return out


def tendency_tiles_reference(model, s, tile=(32, 32), halo=TILE_RADIUS,
                             split="full"):
    """G of the split on stacked fields ``s``, each tile's from its window
    of the wrap-padded state, as exp_fused2d.py's probe evaluates it: the
    windows' own periodic model (``dataclasses.replace`` of the grid), its
    ``tendencies``, each window's interior cropped. The windows are laid
    side by side into one array and evaluated as one periodic grid: each
    interior point reads only within the composed radius
    :data:`TILE_RADIUS` <= ``halo``, so it takes the values a window-sized
    model would give it."""
    tendency_tiles_reference.calls += 1
    _check_tiles(model, s, tile, halo, split)
    TX, TY = tile
    NX, NY = s.shape[1:]
    PX, PY = TX + 2 * halo, TY + 2 * halo
    windows = wrap_pad(s, halo, halo).unfold(1, PX, TX).unfold(2, PY, TY)
    bx, by = windows.shape[1:3]
    mosaic = windows.permute(0, 1, 3, 2, 4).reshape(4, bx * PX, by * PY)
    g = model.grid
    local = dataclasses.replace(model, grid=dataclasses.replace(
        g, Nx=bx * PX, Ny=by * PY, Lx=g.dx * bx * PX, Ly=g.dy * by * PY))
    G = torch.stack(local.tendencies(State(*mosaic)).fields())
    G = G[list(SPLIT_FIELDS[split])].reshape(-1, bx, PX, by, PY)
    return G[:, :, halo:halo + TX, :, halo:halo + TY].reshape(-1, NX, NY)


# -- checks -------------------------------------------------------------------

def _window_dims(shape, TX, TY, HX, HY):
    if len(shape) != 2 or min(TX, TY) < 1 or min(HX, HY) < 0:
        raise ValueError(f"a 2-D padded array and positive tiles; got "
                         f"{tuple(shape)}, tile ({TX}, {TY}), halo "
                         f"({HX}, {HY})")
    N, M = shape[0] - 2 * HX, shape[1] - 2 * HY
    if N < 1 or M < 1 or N % TX or M % TY:
        raise ValueError(f"tiles ({TX}, {TY}) do not divide the {N}x{M} "
                         f"array inside the padded {tuple(shape)}")
    return N, M


def _window_shape(x_padded, TX, TY, HX, HY, load):
    if load not in LOADS:
        raise ValueError(f"load is 1 (async) or 0 (plain), not {load!r}")
    return _window_dims(tuple(x_padded.shape), TX, TY, HX, HY)


def _wrap_dims(shape, case):
    if case not in WRAP_CASES:
        raise ValueError(f"unknown case {case!r}; the cases are "
                         f"{', '.join(WRAP_CASES)}")
    N = shape[0] - 2 * WRAP_H if len(shape) == 2 else 0
    if N < WRAP_H or N % WRAP_TX:
        raise ValueError(f"rows of {WRAP_TX} do not divide the array inside "
                         f"the row-padded {tuple(shape)}")
    return N, shape[1]


def _check_tiles(model, s, tile, halo, split):
    """The kernel's parameters for the probe's model; ``ValueError``
    naming what is out of its reach otherwise."""
    if split not in SPLITS:
        raise ValueError(f"unknown split {split!r}; the splits are "
                         f"{', '.join(SPLITS)}")
    params = kernel_params(model)
    if params.branch != Branch(0, 0, 0) or params.gamma:
        raise ValueError(
            f"the tile tendency covers the bench.py model only "
            f"(vector_invariant, periodic, WENO5 with the velocity stencil, "
            f"no closure, no A background gradient), not "
            f"[{branch_label(params.branch)}], gamma {params.gamma:g}, "
            f"as the JAX probe runs bench.py's model only")
    g = model.grid
    TX, TY = tile
    if tuple(s.shape) != (4, g.Nx, g.Ny):
        raise ValueError(f"stacked fields must be (4, {g.Nx}, {g.Ny}); got "
                         f"{tuple(s.shape)}")
    if TX < 1 or TY < 1 or g.Nx % TX or g.Ny % TY:
        raise ValueError(f"tiles ({TX}, {TY}) do not divide the "
                         f"{g.Nx}x{g.Ny} grid")
    if not TILE_RADIUS <= halo <= min(g.Nx, g.Ny):
        raise ValueError(f"the halo must be at least the tendency's "
                         f"composed radius {TILE_RADIUS} and at most the "
                         f"grid; got {halo}")
    return params


# -- kernel wrappers ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    # once per process: _build.load() hashes the sources on every call
    from . import _build
    return _build.load()


def smem_limit() -> int:
    """The card's opt-in shared memory per block, in bytes, as the
    kernels read it."""
    return _lib().fn("swmhd_smem_limit")()


def _raise_on(err, name, smem_bytes):
    if err == SMEM_REFUSED:
        raise ValueError(f"{name}: the window needs {smem_bytes} B of shared "
                         f"memory, over the card's opt-in limit of "
                         f"{smem_limit()} B per block")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_input(t, dtypes=(torch.float32,)):
    if t.dtype not in dtypes:
        raise ValueError(f"the kernel takes {', '.join(map(str, dtypes))}, "
                         f"not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("the input must be contiguous")


def _plan_for(x_padded, spec, plan):
    """``plan``, checked against the input, or the default plan."""
    if plan is None:
        return load_plan(tuple(x_padded.shape), spec,
                         aligned=x_padded.data_ptr() % 16 == 0)
    if plan.shape != tuple(x_padded.shape) or plan.spec != spec:
        raise ValueError(f"the plan is for {plan.spec} on {plan.shape}, not "
                         f"{spec} on {tuple(x_padded.shape)}")
    return plan


def window_probe(x_padded, TX, TY, HX, HY, load=1, plan=None):
    """The interior of each ``(TX, TY)`` tile of the ``(N + 2HX, M +
    2HY)`` wrap-padded float32 array, + 1, from a window staged in shared
    memory by asynchronous copies (``load`` 1) or through registers (0),
    as ``plan`` (a :func:`load_plan` of this input; by default the
    shape's) stages it."""
    N, M = _window_shape(x_padded, TX, TY, HX, HY, load)
    if x_padded.device.type == "cpu":
        return window_probe_reference(x_padded, TX, TY, HX, HY, load)
    _check_input(x_padded)
    plan = _plan_for(x_padded, (TX, TY, HX, HY), plan)
    out = torch.empty((N, M), dtype=x_padded.dtype, device=x_padded.device)
    err = _lib().fn("swmhd_window_probe", "f32")(
        x_padded.data_ptr(), out.data_ptr(), N, M, TX, TY, HX, HY, load,
        BRANCHES.index(plan.branch), plan.p, *plan.box, _stream(x_padded))
    _raise_on(err, "swmhd_window_probe", window_smem_bytes(TX, TY, HX, HY))
    window_probe.launches += 1
    window_probe.launches_by_shape[(TX, TY, HX, HY, load)] += 1
    window_probe.launches_by_branch[plan.branch] += 1
    return out


def wrap_probe(x_padded, case, plan=None):
    """Rows of :data:`WRAP_TX` of the ``(N + 2·WRAP_H, M)`` row-padded
    float32 array, + 1, from a 48-row window staged in shared memory as
    ``case`` (one of :data:`WRAP_CASES`) copies it, dealt among blocks as
    ``plan`` (a :func:`load_plan` of this input; by default the shape's)
    says."""
    N, M = _wrap_dims(tuple(x_padded.shape), case)
    if x_padded.device.type == "cpu":
        return wrap_probe_reference(x_padded, case)
    _check_input(x_padded)
    plan = _plan_for(x_padded, case, plan)
    out = torch.empty((N, M), dtype=x_padded.dtype, device=x_padded.device)
    err = _lib().fn("swmhd_wrap_probe", "f32")(
        x_padded.data_ptr(), out.data_ptr(), N, M, WRAP_TX, WRAP_H,
        WRAP_CASES.index(case), BRANCHES.index(plan.branch), plan.p,
        *plan.box, _stream(x_padded))
    _raise_on(err, "swmhd_wrap_probe", wrap_smem_bytes(M))
    wrap_probe.launches += 1
    wrap_probe.launches_by_shape[case] += 1
    wrap_probe.launches_by_branch[plan.branch] += 1
    return out


def _check_kernel_tile(tile):
    """``ValueError`` for a tile the kernel is not built for: columns
    outside :data:`TILE_COLUMNS` (compile-time), rows over
    :data:`TILE_MAX_ROWS`."""
    TX, TY = tile
    if TY not in TILE_COLUMNS or TX > TILE_MAX_ROWS:
        raise ValueError(f"the tile tendency kernel takes tiles of at most "
                         f"{TILE_MAX_ROWS} rows and "
                         f"{', '.join(map(str, TILE_COLUMNS))} columns; got "
                         f"({TX}, {TY})")


def tendency_tile_info(dtype, tile, halo, split):
    """``(shared memory bytes a block, registers a thread, resident blocks
    an SM)`` of the tile tendency kernel for ``tile``, ``halo`` and
    ``split``, from the CUDA runtime."""
    _check_kernel_tile(tile)
    out = (ctypes.c_int * 3)()
    suffix = "f32" if dtype == torch.float32 else "f64"
    err = _lib().fn("swmhd_tendency_tile_info", suffix)(
        *tile, halo, SPLITS.index(split), ctypes.addressof(out))
    _raise_on(err, "swmhd_tendency_tile_info",
              tile_smem_bytes(dtype, tile, halo, split))
    return tuple(out)


def tendency_tiles(model, s, tile=(32, 32), halo=TILE_RADIUS, split="full"):
    """G of ``split`` (the fields of :data:`SPLIT_FIELDS`, stacked) of the
    ``bench.py`` model on stacked fields ``s``, one block per ``tile``,
    each reading the state's window ``halo`` points wide, wrapped at load
    time."""
    params = _check_tiles(model, s, tile, halo, split)
    _check_kernel_tile(tile)
    if s.device.type == "cpu":
        return tendency_tiles_reference(model, s, tile, halo, split)
    _check_input(s, (torch.float32, torch.float64))
    NX, NY = s.shape[1:]
    out = torch.empty((len(SPLIT_FIELDS[split]), NX, NY), dtype=s.dtype,
                      device=s.device)
    suffix = "f32" if s.dtype == torch.float32 else "f64"
    err = _lib().fn("swmhd_tendency_tile", suffix)(
        s.data_ptr(), out.data_ptr(), NX, NY, *tile, halo,
        SPLITS.index(split), params.dx, params.dy, params.g, params.f,
        _stream(s))
    _raise_on(err, "swmhd_tendency_tile",
              tile_smem_bytes(s.dtype, tile, halo, split))
    tendency_tiles.launches += 1
    tendency_tiles.launches_by_shape[(*tile, halo, split)] += 1
    return out


def reset_counters():
    for f in (window_probe, wrap_probe, tendency_tiles):
        f.launches = 0
        f.launches_by_shape = collections.Counter()
    for f in (window_probe, wrap_probe):
        f.launches_by_branch = collections.Counter()
    for f in (window_probe_reference, wrap_probe_reference,
              tendency_tiles_reference):
        f.calls = 0


reset_counters()
