"""The domain decomposition of swmhd_tpu_torch (``parallel/``), on the CPU
at 64² float64, held against the JAX package on the same inputs.

Four ranks of one gloo group (``tests/torch_dist_worker.py``, started
once for the module) run the decomposed plain step, the kernel stepper
(its plain tile version here), a Simulation with an energy series, sharded
checkpoints and FieldWriter slabs; the tests below compare what they wrote
with JAX's single-device step (``model.step``, the body of
``model.step_fn``, run eagerly: a jitted scan costs a compile per
configuration), JAX's ``restore_sharded`` and JAX's ``FieldTimeSeries``.
Two more groups of four run the decomposed CLI. States agree to 1e-12 and
series to 1e-10 (the global sums reduce in another order). In-process
tests cover the global index origin, the tile substage's plain version,
the meshes and the readers; the tile kernel itself runs only on a card
(tests marked ``cuda``).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
import swmhd_tpu
import swmhd_tpu_torch
from port_cases import (OPTIONS, bench_model, cut_tile, initial_fields,
                        option_kwargs, split_against_tile, tile_layout)
from swmhd_tpu import (Grid as JGrid, ShallowWaterModel as JModel,
                       FPlane as JFPlane, jacobian_lorentz_forcing as jforce,
                       divergence_lorentz_forcing as jdivforce)
from swmhd_tpu import checkpoint as jckpt
from swmhd_tpu import diagnostics as jdiag
from swmhd_tpu import scenarios as jscen
from swmhd_tpu.io.readers import FieldTimeSeries as JFieldTimeSeries
from swmhd_tpu.models.state import Clock as JClock
from swmhd_tpu.parallel import (DomainDecomposition as JDomainDecomposition,
                                make_mesh as jmake_mesh)
from swmhd_tpu_torch import cli, operators as op
from swmhd_tpu_torch.convert import state_from_numpy
from swmhd_tpu_torch.io import FieldTimeSeries, ScalarTimeSeries
from swmhd_tpu_torch.models.state import State
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.parallel.decomposition import (
    DomainDecomposition, Mesh, make_mesh)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
FIELDS = ("h", "u", "v", "A")
WORLD = 4
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_case(formulation, topo, options=None):
    """The JAX twin of ``torch_dist_worker``'s ``case``, with ``options``
    (an entry of port_cases.OPTIONS) as the worker runs them."""
    g = JGrid.regular(W.N, W.N, (-5.0, 5.0), (-5.0, 5.0),
                      topology=W.TOPOLOGIES[topo], dtype=jnp.float64)
    gam = W.gamma(topo)
    model = JModel(grid=g, formulation=formulation, coriolis=JFPlane(1.0),
                   forcing=(jdivforce(gam) if formulation == "conservative"
                            else jforce(gam)),
                   A_background_gradient_y=gam,
                   **option_kwargs(options, swmhd_tpu, W.BIHARMONIC_NU))
    return model, model.initial_state(
        **initial_fields(jnp, h_bump=0.05, walls="B" in topo))


def jax_steps(model, state, dt, n):
    for _ in range(n):
        state = model.step(state, dt)
    return state


def assert_state_close(path, want, tol=1e-12, exact=False):
    with np.load(path) as got:
        for k in FIELDS:
            w = np.asarray(getattr(want, k))
            if exact:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                           err_msg=k)
        return float(got["time"]), int(got["iteration"])


def start(argv_of_rank, env_of_rank=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen(argv_of_rank(r), cwd=REPO,
                             env=dict(env, **(env_of_rank(r)
                                              if env_of_rank else {})),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def finish(procs):
    """Outputs of the processes; kills all of them if one hangs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the inputs, runs the worker group, and meanwhile computes
    the JAX references: ``(workdir, refs, worker outputs)``."""
    work = tmp_path_factory.mktemp("dist")
    arrays, cases = {}, {}
    for formulation in W.FORMULATIONS:
        for topo in W.TOPOLOGIES:
            m, s = cases[(formulation, topo)] = jax_case(formulation, topo)
            for f in FIELDS:
                arrays[f"{W.key(formulation, topo)}_{f}"] = np.asarray(
                    getattr(s, f))
    np.savez(work / "inputs.npz", **arrays)
    m, s = cases[("vector_invariant", "PP")]
    jmesh = jmake_mesh(shape=(2, 4))
    jckpt.save_sharded(str(work / "ck_jax"), JDomainDecomposition(
        m, jmesh).shard_state(s.replace(clock=JClock(
            time=jnp.asarray(0.75, jnp.float64),
            iteration=jnp.asarray(150, jnp.int32)))), m.grid, jmesh)

    port = str(_free_port())
    procs = start(lambda r: [sys.executable, WORKER, str(r), str(WORLD),
                             port, str(work)])
    refs = {}
    try:
        for formulation, topo, _ in W.PLAIN + W.FUSED:
            if (formulation, topo) not in refs:
                m, s = cases[(formulation, topo)]
                refs[(formulation, topo)] = jax_steps(m, s, W.DT, W.STEPS)
        for formulation, topo, _ in W.BIHARMONIC:
            m = jax_case(formulation, topo, "biharmonic")[0]
            refs[("biharmonic", formulation, topo)] = jax_steps(
                m, cases[(formulation, topo)][1], W.DT, W.STEPS)
        for _, formulation, topo, options in W.OVERLAP:
            key = ("overlap", formulation, topo, options)
            if key not in refs:
                jdd = JDomainDecomposition(
                    jax_case(formulation, topo, options)[0],
                    jmake_mesh(shape=(2, 2)), overlap=True)
                refs[key] = jax.device_get(jdd.step_fn(W.DT, W.STEPS)(
                    jdd.shard_state(cases[(formulation, topo)][1])))
        m, s = cases[("vector_invariant", "PP")]
        refs["6 steps"] = jax_steps(m, refs[("vector_invariant", "PP")],
                                    W.DT, W.STEPS)
        sm, ss, sc = jscen.build(W.SCENARIO, dtype=jnp.float64)
        refs["scenario"] = jax_steps(sm, ss, sc.dt, W.STEPS)
        series, st = [jdiag.energy_report(m, s, s.h)], s
        for _ in range(W.SERIES_STEPS):
            st = m.step(st, W.DT)
            series.append(jdiag.energy_report(m, st, s.h))
        refs["series"] = (st, series)
        refs["initial"] = s
    finally:
        outs = finish(procs)
    return work, refs, outs


def test_worker_checks_pass(run):
    """Every rank ran to its end: the padded tiles equal the global wrap
    or clamp slices (corners included), the restored checkpoints equal
    what was saved, the kernel stepper took its plain tile version, and
    bounded y on a sharded y axis raised."""
    _, _, outs = run
    assert all("TORCH-DIST-OK" in out for out in outs), outs


@pytest.mark.parametrize("formulation,topo,mesh", W.PLAIN,
                         ids=[W.name("plain", *c) for c in W.PLAIN])
def test_plain_step_matches_jax(run, formulation, topo, mesh):
    work, refs, _ = run
    t, it = assert_state_close(
        work / (W.name("plain", formulation, topo, mesh) + ".npz"),
        refs[(formulation, topo)])
    assert it == W.STEPS and t == pytest.approx(W.STEPS * W.DT, abs=1e-15)


@pytest.mark.parametrize("label", [W.name("fused", *c) for c in W.FUSED]
                         + ["fused_scenario_4x1"])
def test_fused_step_matches_jax(run, label):
    work, refs, _ = run
    if label == "fused_scenario_4x1":
        want = refs["scenario"]
    else:
        want = refs[(label.split("_PP")[0][len("fused_"):], "PP")]
    assert_state_close(work / (label + ".npz"), want)


@pytest.mark.parametrize("kind", ["plain", "fused"])
@pytest.mark.parametrize("formulation,topo,mesh", W.BIHARMONIC,
                         ids=[W.name("biharmonic", *c) for c in W.BIHARMONIC])
def test_biharmonic_decomposed_step_matches_jax(run, kind, formulation,
                                                topo, mesh):
    """Four ranks, a halo of 7, a biharmonic closure: both decomposed
    steppers give JAX's single-device step."""
    work, refs, _ = run
    t, it = assert_state_close(
        work / (W.name(f"biharmonic_{kind}", formulation, topo, mesh)
                + ".npz"), refs[("biharmonic", formulation, topo)])
    assert it == W.STEPS


@pytest.mark.parametrize("kind,formulation,topo,options", W.OVERLAP,
                         ids=[W.overlap_name(*c) for c in W.OVERLAP])
def test_overlap_step_matches_jax_and_the_ordinary_step(
        run, kind, formulation, topo, options):
    """Four ranks on a 2x2 mesh with ``overlap=True`` (the plain step's
    split: the interior while the exchange is in flight, then the edge
    bands; the kernel step takes none, one tile substage a substage, as
    JAX's): JAX's ``DomainDecomposition(..., overlap=True)`` step of the
    same kind on four CPU devices and the port's own step without
    ``overlap``, each within 1e-12 (the same arithmetic at every point:
    bit for bit is what the CPU gives)."""
    work, refs, _ = run
    got = work / (W.overlap_name(kind, formulation, topo, options) + ".npz")
    _, it = assert_state_close(got, refs[("overlap", formulation, topo,
                                          options)])
    assert it == W.STEPS
    with np.load(work / (W.overlap_name(kind, formulation, topo, options,
                                        overlap=False) + ".npz")) as o:
        assert_state_close(got, dataclasses.make_dataclass(
            "Ordinary", FIELDS)(*(o[k] for k in FIELDS)))


@pytest.mark.parametrize("stepper", ["plain", "fused"])
def test_simulation_series_matches_jax(run, stepper):
    work, refs, _ = run
    final, series = refs["series"]
    t, it = assert_state_close(work / f"series_{stepper}.npz", final)
    assert it == W.SERIES_STEPS
    rows = np.loadtxt(work / f"series_{stepper}.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    with open(work / f"series_{stepper}.csv") as f:
        header = f.readline().strip().split(",")
    np.testing.assert_array_equal(rows[:, 1], np.arange(W.SERIES_STEPS + 1))
    for col, name in enumerate(header[2:], start=2):
        want = [float(rep[name]) for rep in series]
        np.testing.assert_allclose(rows[:, col], want, rtol=1e-10,
                                   atol=1e-12, err_msg=name)


def test_port_sharded_checkpoint_restores_in_jax(run):
    work, refs, _ = run
    m, _ = jax_case("vector_invariant", "PP")
    back = jckpt.restore_sharded(str(work / "ck_port"), m.grid,
                                 jmake_mesh(shape=(2, 4)))
    with open(work / "ck_port" / "meta.json") as f:
        assert json.load(f)["n_slabs"] == WORLD
    assert int(back.clock.iteration) == W.STEPS
    assert float(back.clock.time) == pytest.approx(W.STEPS * W.DT)
    assert_state_close(work / "plain_vector_invariant_PP_2x2.npz",
                       jax.device_get(back), exact=True)


def test_resume_under_another_layout_matches_uninterrupted(run):
    """Saved at step 3 on a 2x2 mesh, restored on 4x1, 3 more steps: JAX's
    6 uninterrupted steps."""
    work, refs, _ = run
    _, it = assert_state_close(work / "resumed_4x1.npz", refs["6 steps"])
    assert it == 2 * W.STEPS


def test_jax_sharded_checkpoint_restores_in_port(run):
    work, refs, _ = run
    t, it = assert_state_close(work / "jax_restored_4x1.npz",
                               refs["initial"], exact=True)
    assert (t, it) == (0.75, 150)


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_field_slabs_are_read_back(run, reader):
    work, refs, _ = run
    path = str(work / "fields")
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["n_processes"] == WORLD
    assert os.path.exists(os.path.join(path, "A", "000000.p00003.npz"))
    assert not os.path.exists(os.path.join(path, "A", "000000.npy"))
    cls = JFieldTimeSeries if reader == "jax" else FieldTimeSeries
    for name in ("A", "h"):
        ts = cls(path, name)
        np.testing.assert_allclose(ts.iterations, [0, W.FIELD_EVERY,
                                                   W.FIELD_STEPS])
        np.testing.assert_array_equal(ts[0], np.asarray(
            getattr(refs["initial"], name)))
        for i, ref in ((1, refs[("vector_invariant", "PP")]),
                       (-1, refs["6 steps"])):
            np.testing.assert_allclose(ts[i], np.asarray(getattr(ref, name)),
                                       rtol=1e-12, atol=1e-12)


# -- the decomposed CLI ---------------------------------------------------------

@pytest.mark.parametrize("scenario,mesh", [("64x64_two_Gaussians_high_B",
                                            "2x2"),
                                           ("64x64_low_B_low_U", "4x1")])
def test_decomposed_cli_matches_single_process(tmp_path, scenario, mesh):
    args = ["run", scenario, "--device", "cpu", "--dtype", "float64",
            "--stop-time", "0.05", "--fields-interval", "0.02",
            "--checkpoint-every", "5"]
    port = str(_free_port())
    procs = start(
        lambda r: [sys.executable, "-m", "swmhd_tpu_torch.cli", *args,
                   "--outdir", str(tmp_path / "dd")],
        lambda r: dict(RANK=str(r), WORLD_SIZE=str(WORLD),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(WORLD),
                       MASTER_ADDR="localhost", MASTER_PORT=port))
    cli.main(args + ["--outdir", str(tmp_path / "one")])
    outs = finish(procs)
    assert f"decomposed over a {mesh} mesh" in "".join(outs)

    a = ScalarTimeSeries(str(tmp_path / "one" / "energies.csv"))
    b = ScalarTimeSeries(str(tmp_path / "dd" / "energies.csv"))
    assert sorted(a.columns) == sorted(b.columns)
    np.testing.assert_array_equal(b.iteration, np.arange(6))
    for name in a.columns:
        np.testing.assert_allclose(b[name], a[name], rtol=1e-10, atol=1e-12,
                                   err_msg=name)
    with np.load(tmp_path / "one" / "final.npz") as x, \
            np.load(tmp_path / "dd" / "final.npz") as y:
        for k in FIELDS:
            np.testing.assert_allclose(y[k], x[k], rtol=1e-12, atol=1e-12)
        assert (float(y["time"]), int(y["iteration"])) == (0.05, 5)
    for name in ("A", "s"):
        one = JFieldTimeSeries(str(tmp_path / "one" / "fields"), name)
        dd = JFieldTimeSeries(str(tmp_path / "dd" / "fields"), name)
        assert len(one) == len(dd) == 3
        for i in range(3):
            np.testing.assert_allclose(dd[i], one[i], rtol=1e-12,
                                       atol=1e-12)
    with open(tmp_path / "dd" / "checkpoint" / "meta.json") as f:
        assert json.load(f)["iteration"] == 5


# -- in-process: the global index origin, meshes, the tile substage ------------

def tile_xy(a, b, hx, hy, topology):
    """``a[..., x0-hx:x1+hx, y0-hy:y1+hy]`` for ``b = (x0, x1, y0, y1)``,
    wrapped or clamped per axis."""
    x0, x1, y0, y1 = b
    a = np.take(a, np.arange(x0 - hx, x1 + hx), axis=-2,
                mode="wrap" if topology[0] == "periodic" else "clip")
    return np.take(a, np.arange(y0 - hy, y1 + hy), axis=-1,
                   mode="wrap" if topology[1] == "periodic" else "clip")


@pytest.mark.parametrize("formulation", W.FORMULATIONS)
@pytest.mark.parametrize("topo", sorted(W.TOPOLOGIES))
def test_index_context_puts_walls_at_the_global_walls(formulation, topo):
    """The port's tendencies on a padded tile with an IndexContext, cropped,
    equal JAX's global tendencies: clamps, flux zeros, near-wall
    degradation and masks act at the domain walls only."""
    jm, js = jax_case(formulation, topo)
    want = jm.tendencies(js)
    g = np.stack([np.asarray(getattr(js, f)) for f in FIELDS])
    tm = bench_model(W.N, torch.float64, "cpu", formulation,
                     W.TOPOLOGIES[topo], W.gamma(topo))[0]
    H, n = 6, W.N // 2
    scale = max(float(np.abs(np.asarray(getattr(want, f))).max())
                for f in FIELDS)
    for x0, y0 in ((0, 0), (n, n), (0, n)):
        p = torch.as_tensor(tile_xy(g, (x0, x0 + n, y0, y0 + n), H, H,
                                    W.TOPOLOGIES[topo]))
        local = dataclasses.replace(tm, grid=dataclasses.replace(
            tm.grid, Nx=n + 2 * H, Ny=n + 2 * H, Lx=tm.grid.dx * (n + 2 * H),
            Ly=tm.grid.dy * (n + 2 * H)))
        prev = op.set_index_ctx(op.IndexContext(x0 - H, y0 - H, W.N, W.N))
        try:
            G = local.tendencies(State(*p.unbind(0)))
        finally:
            op.set_index_ctx(prev)
        for f in FIELDS:
            got = getattr(G, f)[H:H + n, H:H + n].numpy()
            w = np.asarray(getattr(want, f))[x0:x0 + n, y0:y0 + n]
            assert np.abs(got - w).max() <= 1e-12 * scale, (f, x0, y0)


@pytest.mark.parametrize("formulation", W.FORMULATIONS)
@pytest.mark.parametrize("topo,mesh", [("PP", (2, 2)), ("PB", (4, 1)),
                                       ("PP", (3, 1)), ("PP", (1, 4))])
def test_tile_substage_reference_is_the_substage_on_a_tile(formulation, topo,
                                                          mesh):
    """The plain version of the tile kernel on tiles cut from a global
    state (halo 6 where the axis is sharded, none where it is whole)
    gives the global substage's values there, in both substages that
    take and leave G_prev."""
    tm, st = bench_model(48, torch.float64, "cpu", formulation,
                         W.TOPOLOGIES[topo], W.gamma(topo), walls=True)
    s = K.stack(st)
    s1, g1 = K.substage_reference(tm, s, W.DT, 0)
    s2, g2 = K.substage_reference(tm, s1, W.DT, 1, g1)
    px, py = mesh
    nx, ny = 48 // px, 48 // py
    hx, hy = (6 if px > 1 else 0), (6 if py > 1 else 0)
    topology = W.TOPOLOGIES[topo]
    for ix in range(px):
        for iy in range(py):
            b = (ix * nx, (ix + 1) * nx, iy * ny, (iy + 1) * ny)
            cut = lambda a: torch.as_tensor(
                tile_xy(a.numpy(), b, hx, hy, topology))
            t1, h1 = K.substage(tm, cut(s), W.DT, 0, None, halo=(hx, hy))
            gp = g1[:, b[0]:b[1], b[2]:b[3]].contiguous()
            t2, h2 = K.substage(tm, cut(s1), W.DT, 1, gp, write_G=False,
                                halo=(hx, hy))
            assert h2 is None
            for got, want in ((t1, s1), (h1, g1), (t2, s2)):
                w = want[:, b[0]:b[1], b[2]:b[3]]
                assert float((got - w).abs().max()) <= 1e-13 * float(
                    want.abs().max())


@pytest.mark.parametrize("formulation", W.FORMULATIONS)
def test_biharmonic_tile_substage_reference_on_a_halo_of_7(formulation):
    """With a biharmonic closure the tile substage's plain version on
    2x2 tiles padded by model.exchange_halo = 7 gives the global
    substage's values; padded by 2 it does not."""
    tm, st = bench_model(48, torch.float64, "cpu", formulation, walls=True)
    tm = dataclasses.replace(tm, **option_kwargs(
        "biharmonic", swmhd_tpu_torch, W.BIHARMONIC_NU))
    assert tm.exchange_halo == 7
    s = K.stack(st)
    s1, g1 = K.substage_reference(tm, s, W.DT, 0)
    b = (24, 48, 0, 24)
    for H, exact in ((7, True), (2, False)):
        cut = torch.as_tensor(tile_xy(s.numpy(), b, H, H, W.TOPOLOGIES["PP"]))
        t1, h1 = K.substage(tm, cut, W.DT, 0, None, halo=(H, H))
        err = float((h1 - g1[:, 24:, :24]).abs().max())
        assert (err <= 1e-13 * float(g1.abs().max())) == exact, (H, err)


def test_tile_substage_rejects_a_padded_wall():
    tm = bench_model(16, torch.float64, "cpu",
                     topology=W.TOPOLOGIES["PB"], gamma=-0.05)[0]
    with pytest.raises(ValueError, match="periodic axis"):
        K.substage(tm, torch.zeros(4, 28, 28, dtype=torch.float64), W.DT,
                   0, None, halo=(6, 6))


def test_branch_labels_name_the_axis_modes():
    E, B, P = K.EXCHANGED_AXIS, K.BOUNDED_AXIS, K.PERIODIC_AXIS
    assert K.branch_label((0, E, P)) == "vector_invariant, exchanged x"
    assert K.branch_label((1, E, B)) == "conservative, bounded y, exchanged x"
    assert K.branch_label((0, E, E)) == "vector_invariant, exchanged xy"
    assert K.branch_label((0, P, P)) == "vector_invariant, periodic"
    assert K.branch_label((0, E, E, 2)) == \
        "vector_invariant, exchanged xy, biharmonic"
    assert K.branch_label(K.Branch(1, P, P, momentum=2, tracer=1)) == \
        "conservative, periodic, centered2 momentum, upwind3 tracer"


def test_meshes_and_what_is_not_ported():
    assert make_mesh(4) == Mesh(2, 2) and make_mesh(8) == Mesh(2, 4)
    assert make_mesh(6) == Mesh(2, 3) and make_mesh(shape=(4, 1)) == Mesh(4, 1)
    assert [Mesh(2, 2).coords(r) for r in range(4)] == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    assert Mesh(2, 2).rank(-1, 2) == 2
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(4, shape=(3, 1))
    tm = bench_model(16, torch.float64, "cpu")[0]
    # overlap is accepted; the split needs 3 * halo <= min(nx, ny)
    dd = DomainDecomposition(tm, Mesh(1, 1), overlap=True)
    assert dd.overlap and not dd.split
    assert DomainDecomposition(tm, Mesh(1, 1), halo=5, overlap=True).split
    assert not DomainDecomposition(tm, Mesh(1, 1), halo=5).split
    with pytest.raises(ValueError, match="needs 4 processes"):
        DomainDecomposition(tm, Mesh(2, 2))
    with pytest.raises(ValueError, match="needs 4 processes"):
        DomainDecomposition(tm, Mesh(2, 2), overlap=True)
    assert tm.exchange_halo == 6 and DomainDecomposition(tm).halo == 6


def test_single_process_decomposition_steps_like_the_model():
    """A 1x1 mesh: both decomposed steppers pad by local wraps and give
    the model's own step."""
    tm, st = bench_model(24, torch.float64, "cpu", walls=True)
    dd = DomainDecomposition(tm)
    assert dd.kernel_halo() == (0, 0)
    want = tm.step_fn(W.DT, 2)(st)
    for fn in (dd.step_fn(W.DT, 2), dd.fused_step_fn(W.DT, 2)):
        got = fn(dd.shard_state(st))
        assert torch.allclose(K.stack(got), K.stack(want), rtol=0,
                              atol=1e-13)
        assert got.clock == want.clock


@pytest.mark.parametrize("formulation", W.FORMULATIONS)
@pytest.mark.parametrize("topo", sorted(W.TOPOLOGIES))
def test_single_process_split_steps_like_the_ordinary_step(formulation,
                                                          topo):
    """A 1x1 mesh of a 24² grid (3 · 6 <= 24): the plain step's split
    pads by local wraps or clamps, and both steppers with ``overlap``
    (the kernel stepper, which takes no split, where x is periodic) give
    the ordinary step bit for bit."""
    tm, st = bench_model(24, torch.float64, "cpu", formulation,
                         W.TOPOLOGIES[topo], W.gamma(topo), walls=True)
    a, b = DomainDecomposition(tm), DomainDecomposition(tm, overlap=True)
    assert b.split and not a.split
    kinds = ["step_fn"] + (["fused_step_fn"] if topo == "PP" else [])
    for kind in kinds:
        want = getattr(a, kind)(W.DT, 2)(a.shard_state(st))
        got = getattr(b, kind)(W.DT, 2)(b.shard_state(st))
        assert torch.equal(K.stack(got), K.stack(want)), kind
        assert got.clock == want.clock


@pytest.mark.parametrize("formulation", W.FORMULATIONS)
@pytest.mark.parametrize("options,halo", [(None, 6), ("biharmonic", 7)])
def test_split_of_the_tile_substage_reference_is_one_tile_substage(
        formulation, options, halo):
    """The interior on the unpadded tile and the four bands on slabs of
    the padded tile, each written in place through ``substage(...,
    out=, at=)``, on the last tile of a 2x2 cut of a 256² state (sliced
    with wrap): G and the state of substages 0 and 1 equal one tile
    substage's (its plain version here), within 1e-12 and, as every
    point's arithmetic is the same, bit for bit; each region call is a
    plain call and no launch."""
    tm, st = bench_model(256, torch.float64, "cpu", formulation)
    tm = dataclasses.replace(tm, **option_kwargs(
        options, swmhd_tpu_torch, W.BIHARMONIC_NU))
    assert tm.exchange_halo == halo
    tiles, pad = tile_layout(256, 256, (2, 2), halo)
    p = cut_tile(K.stack(st), tiles[-1], *pad)
    K.reset_counters()
    worst, bitwise = split_against_tile(K, tm, p, W.DT, pad)
    assert worst <= 1e-12 and bitwise, worst
    # 2 tile substages, 2 splits of an interior and four bands
    assert K.substage_reference.calls == 2 + 2 * 5
    assert K.substage.launches == 0


def test_region_outside_the_output_is_refused():
    tm, st = bench_model(24, torch.float64, "cpu")
    s = K.stack(st)
    out = (torch.empty_like(s), torch.empty_like(s))
    with pytest.raises(ValueError, match="does not lie"):
        K.substage(tm, s, W.DT, 0, halo=(0, 0), out=out, at=(1, 0))
    with pytest.raises(ValueError, match="exactly when write_G"):
        K.substage(tm, s, W.DT, 0, write_G=False, out=out)
    with pytest.raises(ValueError, match="laid out like"):
        K.substage(tm, s, W.DT, 1, s[:, :, :12], out=out)


def test_region_parts_name_interior_and_bands():
    from swmhd_tpu_torch.parallel.decomposition import band_slabs
    part = K.region_part
    assert part((0, 0), (24, 24), (0, 0), (24, 24)) == "whole"
    assert part((6, 6), (32, 32), (0, 0), (32, 32)) == "tile"
    assert part((6, 6), (32, 32), (6, 6), (20, 20)) == "interior"
    assert part((0, 6), (64, 32), (0, 6), (64, 20)) == "interior"
    bands = band_slabs(32, 32, 6, 6)
    assert [b[2] for b in bands] == [(0, 0), (26, 0), (0, 0), (0, 26)]
    assert [(r.stop - r.start, c.stop - c.start) for r, c, _ in bands] == [
        (18, 44), (18, 44), (44, 18), (44, 18)]
    extents = [(6, 32), (6, 32), (32, 6), (32, 6)]
    assert {part((6, 6), (32, 32), at, e)
            for (_, _, at), e in zip(bands, extents)} == {"band"}
    assert [b[2] for b in band_slabs(16, 64, 6, 0)] == [(0, 0), (10, 0)]
    assert [b[2] for b in band_slabs(64, 16, 0, 6)] == [(0, 0), (0, 10)]


# -- the readers ------------------------------------------------------------------

def _slab(path, idx, pid, bounds, shape, value):
    x0, x1, y0, y1 = bounds
    np.savez(os.path.join(path, f"{idx:06d}.p{pid:05d}.npz"),
             data=np.full((x1 - x0, y1 - y0), value),
             bounds=np.asarray(bounds), shape=np.asarray(shape))


def test_field_reader_checks_slab_coverage_by_mask(tmp_path):
    """An overlap that an equal gap would hide from an area sum is caught,
    and a slab still being written (``.tmp``) is not read."""
    os.makedirs(tmp_path / "A")
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"times": [0.0, 1.0, 2.0], "iterations": [0, 1, 2]}, f)
    d = str(tmp_path / "A")
    for pid, b in enumerate([(0, 2, 0, 4), (2, 4, 0, 4)]):
        _slab(d, 0, pid, b, (4, 4), pid)
    _slab(d, 1, 0, (0, 3, 0, 4), (4, 4), 0)      # rows 0-2
    _slab(d, 1, 1, (2, 3, 0, 4), (4, 4), 1)      # row 2 again, row 3 none
    _slab(d, 2, 0, (0, 4, 0, 2), (4, 4), 0)
    ts = FieldTimeSeries(str(tmp_path), "A")
    np.testing.assert_array_equal(ts[0], np.repeat([0, 0, 1, 1], 4)
                                  .reshape(4, 4))
    with pytest.raises(RuntimeError, match="overlaps"):
        ts[1]
    with open(os.path.join(d, "000002.p00001.npz.tmp"), "w") as f:
        f.write("partial")
    with pytest.raises(RuntimeError, match="cover 8 of 16"):
        ts[-1]


def test_scalar_reader_reads_columns(tmp_path):
    path = tmp_path / "e.csv"
    path.write_text("time,iteration,total_energy\n0.0,0,1.5\n0.1,1,1.25\n")
    ts = ScalarTimeSeries(str(path))
    np.testing.assert_array_equal(ts.iteration, [0, 1])
    np.testing.assert_array_equal(ts["total_energy"], [1.5, 1.25])
    with pytest.raises(AttributeError):
        ts.missing


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tile kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", W.FORMULATIONS)
@pytest.mark.parametrize("topo,mesh,options", [
    ("PP", (2, 2), None), ("PB", (4, 1), None), ("PP", (4, 1), None),
    ("PP", (1, 4), None), ("PP", (2, 2), "biharmonic"),
    ("PB", (4, 1), "laplacian"),
    *(("PP", (2, 2), o) for o in OPTIONS[2:])])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_kernel_is_the_substage_kernel_on_a_tile(cuda, formulation,
                                                     topo, mesh, options,
                                                     dtype):
    """On the card the tile kernel runs the single-device kernel's
    expressions in the same order at every unpadded point: G and the
    state agree bit for bit; and it agrees with its plain version. The
    halo is model.exchange_halo (7 with the biharmonic closure)."""
    tm, st = bench_model(64, dtype, cuda, formulation, W.TOPOLOGIES[topo],
                         W.gamma(topo), walls=True)
    tm = dataclasses.replace(tm, **option_kwargs(
        options, swmhd_tpu_torch, W.BIHARMONIC_NU if options else 0.0))
    s = K.stack(st)
    s1, g1 = K.substage(tm, s, W.DT, 0)
    px, py = mesh
    nx, ny = 64 // px, 64 // py
    H = tm.exchange_halo
    hx, hy = (H if px > 1 else 0), (H if py > 1 else 0)
    K.reset_counters()
    for ix in range(px):
        for iy in range(py):
            b = (ix * nx, (ix + 1) * nx, iy * ny, (iy + 1) * ny)
            p = torch.as_tensor(tile_xy(s.cpu().numpy(), b, hx, hy,
                                        W.TOPOLOGIES[topo])).to(cuda)
            t1, h1 = K.substage(tm, p.contiguous(), W.DT, 0, None,
                                halo=(hx, hy))
            r1, rg = K.substage_reference(tm, p, W.DT, 0, None, (hx, hy))
            assert torch.equal(t1, s1[:, b[0]:b[1], b[2]:b[3]])
            assert torch.equal(h1, g1[:, b[0]:b[1], b[2]:b[3]])
            tol = 1e-12 if dtype == torch.float64 else 2e-5
            for got, want in ((h1, rg), (t1, r1)):
                assert float((got - want).abs().max()) <= tol * float(
                    want.abs().max())
    assert K.substage.launches == px * py
    E = K.EXCHANGED_AXIS
    assert set(K.substage.launches_by_branch) == {
        K.kernel_params(tm).branch._replace(
            mode_x=E if px > 1 else K.PERIODIC_AXIS,
            mode_y=E if py > 1 else K.kernel_params(tm).wall_y)}


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", W.FORMULATIONS)
@pytest.mark.parametrize("topo,mesh,options", [
    ("PP", (2, 2), None), ("PP", (2, 2), "biharmonic"), ("PB", (4, 1), None),
    ("PB", (4, 1), "biharmonic"), ("PP", (1, 2), None)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_split_launches_are_the_tile_launch(cuda, formulation, topo, mesh,
                                            options, dtype):
    """On the card the region launches (the interior on the unpadded
    tile, a band on each slab of the padded tile, each writing its region
    in place) give G and the state of substages 0 and 1 bit
    for bit as the one tile launch does, on the last tile of ``mesh`` of
    a 128² grid at the model's halo (6; 7 with the biharmonic closure),
    with walls where the tile holds whole rows."""
    tm, st = bench_model(128, dtype, cuda, formulation, W.TOPOLOGIES[topo],
                         W.gamma(topo), walls=True)
    tm = dataclasses.replace(tm, **option_kwargs(
        options, swmhd_tpu_torch, W.BIHARMONIC_NU if options else 0.0))
    tiles, pad = tile_layout(128, 128, mesh, tm.exchange_halo)
    p = cut_tile(K.stack(st), tiles[-1], *pad)
    K.reset_counters()
    worst, bitwise = split_against_tile(K, tm, p, W.DT, pad)
    assert bitwise, worst
    bands = 2 * sum(h > 0 for h in pad)
    assert K.substage.launches_by_part == {"tile": 2, "interior": 2,
                                           "band": 2 * bands}
