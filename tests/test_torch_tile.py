"""The 2-D tile probes (swmhd_tpu_torch.ops.tile, swmhd_tpu_torch.probes).

On the CPU, float64: the plain tile tendency against the JAX package's
``model.tendencies`` of the ``bench.py`` model (what
``benchmarks/exp_fused2d.py`` checks its kernel against; that script runs
its probes at import, so it is not imported here) over tiles, halos and
splits, to 1e-12 of each field's scale; the side-by-side windows of the
plain version against a loop over window-sized models; ``probes.build``
against ``bench.build``; the plain window and wrap loads against the JAX
probes' own arithmetic (wrap-pad ``concatenate``, crop, + 1) for every
default spec and case; the refusals; the CPU dispatch; the probe entry
points' lines; the load probes' launch plans (``load_plan``: box limits,
exact cover of windows and output, shared memory, branch by shape) and a
box-by-box emulation of them against the JAX probes' arithmetic.

Tests marked ``cuda`` run the kernels of ``csrc/tile.cu`` and skip without
a card: ``python -m pytest tests/test_torch_tile.py -m cuda`` on the GPU.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from swmhd_tpu_torch import (BiharmonicDiffusion,
                             divergence_lorentz_forcing,
                             jacobian_lorentz_forcing)
from swmhd_tpu_torch.convert import state_from_numpy
from swmhd_tpu_torch.models.state import State
from swmhd_tpu_torch.ops import tile as T
from swmhd_tpu_torch.probes import build, exp_dma, exp_dma2, exp_fused2d

torch.set_num_threads(1)

FIELDS = ("h", "u", "v", "A")


@functools.lru_cache(maxsize=None)
def jax_case(N):
    """``bench.build(N)`` in float64 and its tendencies, as numpy."""
    jm, js = bench.build(N, dtype=jnp.float64)
    G = jm.tendencies(js)
    return ({k: np.asarray(getattr(js, k)) for k in FIELDS},
            np.stack([np.asarray(getattr(G, k)) for k in FIELDS]))


def torch_case(N, dtype=torch.float64):
    """The port's model and the JAX state, stacked."""
    fields, _ = jax_case(N)
    model, _ = build(N, dtype, "cpu")
    st = state_from_numpy(fields, device="cpu", dtype=dtype)
    return model, torch.stack(st.fields())


def assert_fields_close(got, want, tol):
    """got, want: stacked fields; each within tol of want's scale."""
    for n in range(want.shape[0]):
        w = np.asarray(want[n], dtype=np.float64)
        err = np.max(np.abs(np.asarray(got[n], dtype=np.float64) - w))
        assert err <= tol * np.max(np.abs(w)), f"field {n}: {err:.3e}"


TILE_CASES = [(32, tile, halo, split)
              for tile in ((16, 16), (8, 32), (32, 16)) for halo in (3, 8)
              for split in T.SPLITS]
TILE_CASES += [(48, (16, 16), 3, "full"), (48, (24, 48), 8, "full")]


@pytest.mark.parametrize("N,tile,halo,split", TILE_CASES)
def test_tile_reference_matches_jax_tendencies(N, tile, halo, split):
    model, s = torch_case(N)
    got = T.tendency_tiles_reference(model, s, tile, halo, split)
    _, G = jax_case(N)
    assert got.shape == (len(T.SPLIT_FIELDS[split]), N, N)
    assert_fields_close(got.numpy(), G[list(T.SPLIT_FIELDS[split])], 1e-12)


def window_by_window(model, s, tile, halo):
    """What exp_fused2d.py's probe evaluates: each tile's window padded
    with wrap, the tendencies of a window-sized periodic model, the
    interior cropped; one window at a time."""
    TX, TY = tile
    g = model.grid
    PX, PY = TX + 2 * halo, TY + 2 * halo
    local = dataclasses.replace(model, grid=dataclasses.replace(
        g, Nx=PX, Ny=PY, Lx=g.dx * PX, Ly=g.dy * PY))
    p = T.wrap_pad(s, halo, halo)
    out = torch.empty_like(s)
    for i in range(g.Nx // TX):
        for j in range(g.Ny // TY):
            w = p[:, i * TX:i * TX + PX, j * TY:j * TY + PY]
            G = torch.stack(local.tendencies(State(*w)).fields())
            out[:, i * TX:(i + 1) * TX, j * TY:(j + 1) * TY] = \
                G[:, halo:halo + TX, halo:halo + TY]
    return out


@pytest.mark.parametrize("tile,halo", [((16, 8), 3), ((8, 32), 8)])
def test_side_by_side_windows_match_window_sized_models(tile, halo):
    model, s = torch_case(32)
    got = T.tendency_tiles_reference(model, s, tile, halo)
    assert_fields_close(got, window_by_window(model, s, tile, halo), 1e-13)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float64, jnp.float64, 1e-14), (torch.float32, jnp.float32, 1e-6)])
def test_build_matches_bench_build(dtype, jdtype, tol):
    """The same fields, within a few ulps of each field's scale (the two
    frameworks' exp differ in the last bits)."""
    model, st = build(48, dtype, "cpu")
    jm, js = bench.build(48, dtype=jdtype)
    want = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                            device="cpu", dtype=dtype)
    assert all(a.dtype == dtype for a in st.fields())
    assert_fields_close(torch.stack(st.fields()), torch.stack(want.fields()),
                        tol)
    g, jg = model.grid, jm.grid
    assert (g.Nx, g.Ny, g.dx, g.dy) == (jg.Nx, jg.Ny, jg.dx, jg.dy)
    assert (model.formulation, model.gravitational_acceleration,
            model.coriolis.f) == (jm.formulation,
                                  jm.gravitational_acceleration,
                                  jm.coriolis.f)
    assert T.kernel_params(model).branch == (0, 0, 0, 0, 0, 0, 0, 0)


def jax_window_probe(N, TX, TY, HX, HY):
    """exp_dma.py's ``fn`` arithmetic: wrap-pad by concatenate, then what
    the kernel writes (the window's interior + 1), tile by tile."""
    a = jnp.arange(N * N, dtype=jnp.float32).reshape(N, N) * 1e-6
    a = jnp.concatenate([a[-HX:], a, a[:HX]], axis=0)
    a = jnp.concatenate([a[:, -HY:], a, a[:, :HY]], axis=1)
    rows = []
    for i in range(N // TX):
        rows.append(jnp.concatenate(
            [a[i * TX:i * TX + TX + 2 * HX, j * TY:j * TY + TY + 2 * HY]
             [HX:HX + TX, HY:HY + TY] + 1.0 for j in range(N // TY)],
            axis=1))
    return np.asarray(jnp.concatenate(rows, axis=0))


@pytest.mark.parametrize("spec", exp_dma.DEFAULT_SPECS.split(";"))
def test_window_probe_reference_matches_jax_probe(spec):
    TX, TY, HX, HY, load = (int(v) for v in spec.split(","))
    N = 1024
    x = exp_dma.ramp(N, "cpu")
    got = T.window_probe_reference(T.wrap_pad(x, HX, HY), TX, TY, HX, HY,
                                   load)
    want = jax_window_probe(N, TX, TY, HX, HY)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, x + 1.0)


def jax_wrap_probe(N, case):
    """exp_dma2.py's ``fn`` arithmetic: wrap-pad rows by concatenate, then
    each row tile's window staged as ``case`` stages it, rows H:H+TX + 1."""
    TX, H = T.WRAP_TX, T.WRAP_H
    a = jnp.arange(N * N, dtype=jnp.float32).reshape(N, N) * 1e-6
    a = jnp.concatenate([a[-H:], a, a[:H]], axis=0)
    tiles = []
    for i in range(N // TX):
        buf = jnp.zeros((TX + 2 * H, N), jnp.float32)
        if case == "src8":
            buf = buf.at[:H].set(a[i * TX:i * TX + H])
        elif case == "when":
            r0 = i * TX if i > 0 else N - H
            buf = buf.at[:H].set(a[r0:r0 + H])
        buf = buf.at[:].set(a[i * TX:i * TX + TX + 2 * H])
        tiles.append(buf[H:H + TX] + 1.0)
    return np.asarray(jnp.concatenate(tiles, axis=0))


@pytest.mark.parametrize("case", T.WRAP_CASES)
def test_wrap_probe_reference_matches_jax_probe(case):
    N = 1024
    x = exp_dma.ramp(N, "cpu")
    got = T.wrap_probe_reference(T.wrap_pad(x, T.WRAP_H, 0), case)
    np.testing.assert_array_equal(got.numpy(), jax_wrap_probe(N, case))
    assert torch.equal(got, x + 1.0)


# -- the load probes' launch plans (ops.tile.load_plan) ----------------------

SMEM_OPTIN = 232448            # an H100's opt-in shared memory per block
UNALIGNED = (32, 32, 8, 1)     # N = 64, HY = 1: 66-float rows, 264 B
PLAN_CASES = ([(s, P) for s in exp_dma.DEFAULT_SPECS.split(";")
               for P in T.LOAD_P]
              + [(c, P) for c in T.WRAP_CASES for P in T.LOAD_P]
              + [("32,32,8,1,1", None)])


def plan_input(spec):
    """(N, padded shape, spec or case, TX, TY, HX, HY) of a plan case."""
    if spec in T.WRAP_CASES:
        return 1024, (1024 + 2 * T.WRAP_H, 1024), spec, T.WRAP_TX, 1024, \
            T.WRAP_H, 0
    TX, TY, HX, HY, _ = (int(v) for v in spec.split(","))
    N = 64 if (TX, TY, HX, HY) == UNALIGNED else 1024
    return N, (N + 2 * HX, N + 2 * HY), (TX, TY, HX, HY), TX, TY, HX, HY


@pytest.mark.parametrize("spec,P", PLAN_CASES)
def test_load_plan_tiles_windows_and_output(spec, P):
    """Boxes within TMA's limits; each block's boxes cover its part of a
    tile's window exactly once and the parts make up the window; the
    interiors cover the output exactly once; the branch follows the
    shape; shared memory within an H100's per block."""
    N, shape, key, TX, TY, HX, HY = plan_input(spec)
    plan = T.load_plan(shape, key, P)
    assert plan.branch == ("cp.async" if key == UNALIGNED else "tma")
    assert plan.p == (P or 1)
    cover = torch.zeros(N, N, dtype=torch.int32)
    windows = {}
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            boxes, halo, (r0, c0, rows, cols) = plan.block(bx, by)
            cover[r0:r0 + rows, c0:c0 + cols] += 1
            for br, bc in {b[2:] for b in boxes}:
                assert (br, bc) == plan.box
                if plan.branch == "tma":
                    assert br <= T.BOX_MAX and bc <= T.BOX_MAX
                    assert (4 * bc) % 16 == 0
            # the block's boxes: a rectangle of the padded input, once
            lo_r, lo_c = min(b[0] for b in boxes), min(b[1] for b in boxes)
            hi_r = max(b[0] + b[2] for b in boxes)
            hi_c = max(b[1] + b[3] for b in boxes)
            part = torch.zeros(hi_r - lo_r, hi_c - lo_c, dtype=torch.int32)
            for br0, bc0, br, bc in boxes:
                part[br0 - lo_r:br0 - lo_r + br, bc0 - lo_c:bc0 - lo_c + bc] \
                    += 1
            assert bool((part == 1).all())
            # it holds the block's interior with its halo rows around it
            assert (lo_r, hi_r) == (r0, r0 + rows + 2 * HX)
            assert lo_c <= c0 + HY and c0 + HY + cols <= hi_c
            for hr0, hc0, hr, hc in halo:
                assert hr == HX and hc == plan.box[1]
                assert hr0 == (N - HX if key == "when" and r0 == 0 else r0)
            # the parts of tile (i, j) make up its window
            i, j = r0 // TX, c0 // TY
            w = windows.setdefault((i, j), torch.zeros(
                TX + 2 * HX, TY + 2 * HY, dtype=torch.int32))
            assert lo_r >= i * TX and lo_c >= j * TY
            assert hi_r <= i * TX + w.shape[0] and hi_c <= j * TY + w.shape[1]
            w[lo_r - i * TX:hi_r - i * TX, lo_c - j * TY:hi_c - j * TY] = 1
    assert bool((cover == 1).all())
    assert len(windows) == (N // TX) * (N // TY)
    assert all(bool((w == 1).all()) for w in windows.values())
    nbox = plan.nr * plan.kc
    if plan.branch == "tma":
        assert plan.smem_bytes == (-(-8 * nbox // 128) * 128
                                   + nbox * -(-4 * plan.box[0] * plan.box[1]
                                              // 128) * 128)
    else:
        assert plan.smem_bytes == T.window_smem_bytes(TX, TY, HX, HY)
    if T.window_smem_bytes(TX, TY, HX, HY) <= SMEM_OPTIN:
        assert plan.smem_bytes <= SMEM_OPTIN


def emulate_plan(plan, x_padded):
    """What the kernels do with ``plan``, box by box, by slicing: each
    block's boxes copied out of the input (the halo boxes first, into the
    top of their box), then the interior each box holds written + 1."""
    out = torch.full((plan.n, plan.m), float("nan"))
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            boxes, halo, (r0, c0, rows, cols) = plan.block(bx, by)
            bufs = [torch.full(plan.box, float("nan")) for _ in boxes]
            for k, (hr0, hc0, hr, hc) in enumerate(halo):
                bufs[k * plan.nr][:hr] = x_padded[hr0:hr0 + hr, hc0:hc0 + hc]
            for buf, (br0, bc0, br, bc) in zip(bufs, boxes):
                buf[:] = x_padded[br0:br0 + br, bc0:bc0 + bc]
                # the box's part of the interior, in padded coordinates
                ir0, ir1 = max(br0, r0 + plan.hx), min(br0 + br,
                                                        r0 + plan.hx + rows)
                ic0 = max(bc0, c0 + plan.hy)
                ic1 = min(bc0 + bc, c0 + plan.hy + cols)
                if ir0 < ir1 and ic0 < ic1:
                    out[ir0 - plan.hx:ir1 - plan.hx,
                        ic0 - plan.hy:ic1 - plan.hy] = \
                        buf[ir0 - br0:ir1 - br0, ic0 - bc0:ic1 - bc0] + 1.0
    return out


@functools.lru_cache(maxsize=None)
def jax_probe(key, N):
    """The JAX probe's arithmetic for a spec or case, as numpy."""
    if key in T.WRAP_CASES:
        return jax_wrap_probe(N, key)
    return jax_window_probe(N, *key)


@pytest.mark.parametrize("spec,P", PLAN_CASES)
def test_load_plan_emulation_matches_jax_probe(spec, P):
    """The plan applied box by box gives the ramp + 1 bit for bit, what
    the JAX probe computes (for the unaligned spec the ramp + 1 alone:
    the JAX probe's N is 1024)."""
    N, shape, key, TX, TY, HX, HY = plan_input(spec)
    x = exp_dma.ramp(N, "cpu")
    got = emulate_plan(T.load_plan(shape, key, P), T.wrap_pad(x, HX, HY))
    assert torch.equal(got, x + 1.0)
    if N == 1024:
        np.testing.assert_array_equal(got.numpy(), jax_probe(key, N))


@pytest.mark.parametrize("spec", [s for s in exp_dma.DEFAULT_SPECS.split(";")
                                  if s.split(",")[4] == "1"])
def test_load_plan_cp_async_branch_on_request(spec):
    """The cp.async branch, asked for on a shape TMA describes: one
    block a tile, its whole window one box, and the same output."""
    N, shape, key, TX, TY, HX, HY = plan_input(spec)
    plan = T.load_plan(shape, key, branch="cp.async")
    assert (plan.branch, plan.p, plan.grid) == ("cp.async", 1,
                                                (N // TY, N // TX))
    assert plan.box == (TX + 2 * HX, TY + 2 * HY)
    assert plan.smem_bytes == T.window_smem_bytes(TX, TY, HX, HY)
    x = exp_dma.ramp(N, "cpu")
    assert torch.equal(emulate_plan(plan, T.wrap_pad(x, HX, HY)), x + 1.0)


WINDOW_INPUT = ((1040, 1040), (128, 128, 8, 8))
PLAN_REFUSALS = {
    "P 3": (*WINDOW_INPUT, dict(P=3)),
    "P 4 on tiles of 2 rows": ((66, 64), (2, 64, 1, 0), dict(P=4)),
    "tma on a 66-float row": ((80, 66), (32, 32, 8, 1), dict(branch="tma")),
    "tma on an unaligned base": (*WINDOW_INPUT,
                                 dict(branch="tma", aligned=False)),
    "unknown branch": (*WINDOW_INPUT, dict(branch="bulk")),
    "P 2 on the cp.async branch": (*WINDOW_INPUT,
                                   dict(P=2, branch="cp.async")),
    "P 2 on the wrap probe's cp.async branch": (
        (1040, 1024), "src8", dict(P=2, branch="cp.async")),
}


@pytest.mark.parametrize("case", sorted(PLAN_REFUSALS))
def test_load_plan_refusals(case):
    shape, spec, kwargs = PLAN_REFUSALS[case]
    with pytest.raises(ValueError):
        T.load_plan(shape, spec, **kwargs)


def test_load_plan_default_p_and_misaligned_base():
    """The wrappers' default P, reduced where the shape allows no more;
    a base off 16 bytes takes the cp.async branch."""
    plan = T.load_plan(*WINDOW_INPUT)
    assert (plan.p, plan.box) == (T.WINDOW_P, (48, 144))
    plan = T.load_plan((1040, 1024), "src8")
    assert (plan.p, plan.box) == (T.WRAP_P, (48, T.WRAP_BOX_COLS))
    assert plan.kc == 1024 // T.WRAP_BOX_COLS // T.WRAP_P
    assert T.load_plan((66, 64), (2, 64, 1, 0)).p == min(T.WINDOW_P, 2)
    plan = T.load_plan((1040, 1024), "when", aligned=False)
    assert (plan.branch, plan.p, plan.grid) == ("cp.async", 1, (1, 32))


REFUSED = {
    "halo below 3": dict(halo=2),
    "tiles that do not divide the grid": dict(tile=(12, 16)),
    "unknown split": dict(split="all"),
    "conservative": dict(model=dict(formulation="conservative",
                                    forcing=divergence_lorentz_forcing())),
    "bounded y": dict(topology_y="bounded"),
    "closure": dict(model=dict(closure=BiharmonicDiffusion(nu=1e-6,
                                                           kappa=1e-6))),
    "background gradient": dict(model=dict(
        A_background_gradient_y=-0.05,
        forcing=jacobian_lorentz_forcing(-0.05))),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_tile_tendency_refusals(case):
    kw = dict(REFUSED[case])
    model, st = build(32, torch.float64, "cpu")
    if "topology_y" in kw:
        model = dataclasses.replace(model, grid=dataclasses.replace(
            model.grid, topology_y=kw.pop("topology_y")))
    model = dataclasses.replace(model, **kw.pop("model", {}))
    args = dict(dict(tile=(16, 16), halo=3, split="full"), **kw)
    s = torch.stack(st.fields())
    T.reset_counters()
    with pytest.raises(ValueError):
        T.tendency_tiles(model, s, **args)
    assert T.tendency_tiles.launches == 0


def test_cpu_tensors_take_the_plain_versions():
    T.reset_counters()
    model, st = build(32, torch.float64, "cpu")
    s = torch.stack(st.fields())
    assert torch.equal(T.tendency_tiles(model, s, (16, 8), 3, "mom"),
                       T.tendency_tiles_reference(model, s, (16, 8), 3,
                                                  "mom"))
    x = T.wrap_pad(exp_dma.ramp(64, "cpu"), 8, 8)
    assert torch.equal(T.window_probe(x, 32, 16, 8, 8, 0),
                       T.window_probe_reference(x, 32, 16, 8, 8, 0))
    x = T.wrap_pad(exp_dma.ramp(64, "cpu"), 8, 0)
    assert torch.equal(T.wrap_probe(x, "when"),
                       T.wrap_probe_reference(x, "when"))
    assert (T.tendency_tiles.launches, T.window_probe.launches,
            T.wrap_probe.launches) == (0, 0, 0)
    assert (T.tendency_tiles_reference.calls, T.window_probe_reference.calls,
            T.wrap_probe_reference.calls) == (2, 2, 2)


def test_smem_bytes_of_the_default_specs():
    """Of exp_dma.py's specs only 128,1024,8,0 exceeds an H100's 232,448 B
    of opt-in shared memory per block; the tile tendency's default specs
    fit in f32 and, at 256², in f64."""
    limit = 232448
    sizes = {s: T.window_smem_bytes(*map(int, s.split(",")[:4]))
             for s in exp_dma.DEFAULT_SPECS.split(";")}
    assert sizes["128,1024,8,0,1"] == 589824
    assert sizes["128,128,8,128,1"] == 221184
    assert [s for s, b in sizes.items() if b > limit] == ["128,1024,8,0,1"]
    assert T.wrap_smem_bytes(1024) == 196608
    for spec in exp_fused2d.DEFAULT_SPECS.split(";"):
        TX, TY, H, split = spec.split(",")
        for dtype in (torch.float32, torch.float64):
            assert T.tile_smem_bytes(dtype, (int(TX), int(TY)), int(H),
                                     split) <= limit
    assert T.tile_smem_bytes(torch.float32, (32, 32), 3, "full") == 92416


def test_exp_dma_main_on_cpu(capsys):
    res = exp_dma.main(["--device", "cpu", "--n", "32", "--spec",
                        "16,16,4,4,1;16,32,4,0,0;20,16,4,4,1"])
    lines = capsys.readouterr().out.splitlines()
    assert [r["ok"] for r in res] == [True, True, False]
    assert all(r["bitwise"] for r in res[:2])
    assert lines[0].startswith("[TX=16 TY=16 HX=4 HY=4 load=async] OK")
    assert lines[1].startswith("[TX=16 TY=32 HX=4 HY=0 load=plain] OK")
    assert lines[2].startswith("[TX=20 TY=16 HX=4 HY=4 load=async] FAILED: "
                               "ValueError")


def test_exp_dma2_main_on_cpu(capsys):
    res = exp_dma2.main(["--device", "cpu", "--n", "32"])
    lines = capsys.readouterr().out.splitlines()
    assert [r["spec"] for r in res] == list(T.WRAP_CASES)
    assert all(r["ok"] and r["bitwise"] for r in res)
    assert [ln.split("]")[0] for ln in lines] == [f"[{c}" for c in
                                                  T.WRAP_CASES]
    assert all(" OK first call " in ln and ln.endswith("err 0.0e+00")
               for ln in lines)


def test_exp_fused2d_main_on_cpu(capsys):
    res = exp_fused2d.main(["--device", "cpu", "--n", "32", "--reps", "1",
                            "--spec", "16,16,3,full;8,32,3,mom;16,16,8,mt;"
                            "16,16,2,full"])
    lines = capsys.readouterr().out.splitlines()
    assert [r["ok"] for r in res] == [True, True, True, False]
    assert list(res[1]["rel_err"]) == ["u", "v"]
    assert list(res[2]["rel_err"]) == ["h", "A"]
    # float32 side-by-side windows against the float32 whole grid
    assert all(e <= 1e-6 for r in res[:3] for e in r["rel_err"].values())
    assert lines[0].startswith("[TX=16 TY=16 H=3 full] OK no build "
                               "(plain version), ")
    assert "pts/s), G rel err h " in lines[0]
    assert lines[3].startswith("[TX=16 TY=16 H=2 full] FAILED: ValueError")


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,halo,split", [
    ((16, 16), 3, "full"), ((8, 32), 8, "mom"), ((32, 16), 3, "mt"),
    ((64, 16), 3, "full"), ((16, 64), 8, "full")])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 2e-5)])
def test_tile_kernel_matches_plain_on_card(cuda, tile, halo, split, dtype,
                                           tol):
    model, st = build(64, dtype, cuda)
    s = torch.stack(st.fields())
    T.reset_counters()
    got = T.tendency_tiles(model, s, tile, halo, split)
    want = T.tendency_tiles_reference(model, s, tile, halo, split)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        assert_fields_close(got.cpu(), want.cpu(), tol)
    else:
        # float32 relative to the scale of the compared fields: G_h of the
        # near-balanced vortex is ~1e-4 of G_u, so its own float32 G has
        # ~1e-3 of its scale in rounding, kernel and plain version alike
        assert float((got - want).abs().max()) \
            <= tol * float(want.abs().max())
    assert T.tendency_tiles.launches_by_shape == {(*tile, halo, split): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("spec", exp_dma.DEFAULT_SPECS.split(";"))
def test_window_kernel_on_card(cuda, spec):
    TX, TY, HX, HY, load = (int(v) for v in spec.split(","))
    x = exp_dma.ramp(1024, cuda)
    xp = T.wrap_pad(x, HX, HY).contiguous()
    if T.window_smem_bytes(TX, TY, HX, HY) > 232448:
        with pytest.raises(ValueError, match="shared memory"):
            T.window_probe(xp, TX, TY, HX, HY, load)
        return
    assert torch.equal(T.window_probe(xp, TX, TY, HX, HY, load), x + 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", T.WRAP_CASES)
def test_wrap_kernel_on_card(cuda, case):
    x = exp_dma.ramp(1024, cuda)
    assert torch.equal(T.wrap_probe(T.wrap_pad(x, 8, 0).contiguous(), case),
                       x + 1.0)


@pytest.mark.cuda
def test_tile_kernel_refuses_a_window_over_the_limit(cuda):
    model, st = build(128, torch.float64, cuda)
    s = torch.stack(st.fields())
    with pytest.raises(ValueError, match="opt-in limit"):
        T.tendency_tiles(model, s, (64, 64), 8, "full")


@pytest.mark.cuda
@pytest.mark.parametrize("P", T.LOAD_P)
@pytest.mark.parametrize("spec", exp_dma.DEFAULT_SPECS.split(";"))
def test_window_kernel_tma_on_card(cuda, spec, P):
    TX, TY, HX, HY, load = (int(v) for v in spec.split(","))
    x = exp_dma.ramp(1024, cuda)
    xp = T.wrap_pad(x, HX, HY).contiguous()
    plan = T.load_plan(tuple(xp.shape), (TX, TY, HX, HY), P)
    T.reset_counters()
    if T.window_smem_bytes(TX, TY, HX, HY) > SMEM_OPTIN:
        # refused whatever P: the question is whether one block holds
        # the window
        with pytest.raises(ValueError, match="shared memory"):
            T.window_probe(xp, TX, TY, HX, HY, load, plan)
        assert T.window_probe.launches == 0
        return
    got = T.window_probe(xp, TX, TY, HX, HY, load, plan)
    assert torch.equal(got, x + 1.0)
    assert T.window_probe.launches_by_branch == {"tma": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("P", T.LOAD_P)
@pytest.mark.parametrize("case", T.WRAP_CASES)
def test_wrap_kernel_tma_on_card(cuda, case, P):
    x = exp_dma.ramp(1024, cuda)
    xp = T.wrap_pad(x, T.WRAP_H, 0).contiguous()
    T.reset_counters()
    got = T.wrap_probe(xp, case, T.load_plan(tuple(xp.shape), case, P))
    assert torch.equal(got, x + 1.0)
    assert T.wrap_probe.launches_by_branch == {"tma": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("load", (1, 0))
def test_unaligned_window_takes_cp_async_on_card(cuda, load):
    TX, TY, HX, HY = UNALIGNED
    x = exp_dma.ramp(64, cuda)
    T.reset_counters()
    got = T.window_probe(T.wrap_pad(x, HX, HY).contiguous(), TX, TY, HX, HY,
                         load)
    assert torch.equal(got, x + 1.0)
    assert T.window_probe.launches_by_branch == {"cp.async": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", T.WRAP_CASES)
def test_misaligned_base_wrap_takes_cp_async_on_card(cuda, case):
    """A contiguous input 4 bytes off a 16-byte boundary."""
    x = exp_dma.ramp(1024, cuda)
    xp = T.wrap_pad(x, T.WRAP_H, 0)
    flat = torch.empty(xp.numel() + 1, device=cuda)
    off = flat[1:].view(xp.shape)
    off.copy_(xp)
    T.reset_counters()
    assert torch.equal(T.wrap_probe(off, case), x + 1.0)
    assert T.wrap_probe.launches_by_branch == {"cp.async": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [s for s in exp_dma.DEFAULT_SPECS.split(";")
                                  if s != "128,1024,8,0,1"])
def test_window_kernel_cp_async_branch_on_card(cuda, spec):
    TX, TY, HX, HY, load = (int(v) for v in spec.split(","))
    x = exp_dma.ramp(1024, cuda)
    xp = T.wrap_pad(x, HX, HY).contiguous()
    plan = T.load_plan(tuple(xp.shape), (TX, TY, HX, HY), branch="cp.async")
    T.reset_counters()
    assert torch.equal(T.window_probe(xp, TX, TY, HX, HY, load, plan),
                       x + 1.0)
    assert T.window_probe.launches_by_branch == {"cp.async": 1}
