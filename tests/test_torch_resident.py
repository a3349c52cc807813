"""The resident kernel (``ops.substage.multistep``), the chunk captured as
CUDA graphs (``ops.substage.GraphChunk``, what ``KernelStepper.step_fn``
runs on the card with a series) and the CLI's energy series.

On the CPU: ``cli.energies`` against the five names it keeps of the JAX
package's ``energy_report``; the chunk plan; the clock a captured series
sees; ``windowed_steps`` against ``multistep_reference``; a
``KernelStepper`` chunk with a series against the model's own step and
against the JAX package's ``resident_step_fn`` (interpret mode) with the
same series, at 32² float64 to 1e-12.

Tests marked ``cuda`` run on the card and skip without one: the resident
kernel bit for bit against 3·n one-substage launches in every branch of
port_cases.branch_cases and on a grid whose tiles do not divide evenly
among the blocks; the graph chunk bit for bit against the eager chunk,
its rows at their steps, on both routes (resident at 128², one-substage
launches at 2048²); a ``TimeStepWizard`` change of Δt recapturing; the
returned state not overwritten by a later replay; a series that syncs
with the host or reads the clock raising at capture. ``python -m pytest
tests/test_torch_resident.py -m cuda`` on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swmhd_tpu
from swmhd_tpu import diagnostics as jdiag
from swmhd_tpu.models.state import Clock as JClock, State as JState
from swmhd_tpu.ops.fused_step import resident_step_fn
import swmhd_tpu_torch
from swmhd_tpu_torch import cli, scenarios
from swmhd_tpu_torch.convert import state_from_numpy
from swmhd_tpu_torch.models.shallow_water import run_steps
from swmhd_tpu_torch.models.state import Clock
from swmhd_tpu_torch.ops import substage as K
from swmhd_tpu_torch.ops.energies import ENERGY_NAMES
from swmhd_tpu_torch.simulation import (Callback, IterationInterval,
                                        Simulation, TimeStepWizard)
from swmhd_tpu_torch.io import ScalarSeriesWriter
from port_cases import CONS, VI, bench_model, branch_cases, with_options

torch.set_num_threads(1)

FIELDS = ("h", "u", "v", "A")
TOPOLOGIES = {"periodic": ("periodic", "periodic"),
              "walled": ("periodic", "bounded")}


def model_pair(formulation, topology, N=32):
    """The same model in both packages, float64: FPlane(1), the
    formulation's Lorentz forcing, γ = −0.05 when walled."""
    gamma = -0.05 if topology == "walled" else 0.0
    models = []
    for pkg, kw in ((swmhd_tpu, {"dtype": jnp.float64}),
                    (swmhd_tpu_torch, {"dtype": torch.float64,
                                       "device": "cpu"})):
        g = pkg.Grid.regular(N, N, (-5.0, 5.0), (-5.0, 5.0),
                             topology=TOPOLOGIES[topology], **kw)
        forcing = (pkg.divergence_lorentz_forcing(gamma)
                   if formulation == CONS
                   else pkg.jacobian_lorentz_forcing(gamma))
        models.append(pkg.ShallowWaterModel(
            grid=g, formulation=formulation, coriolis=pkg.FPlane(1.0),
            forcing=forcing, A_background_gradient_y=gamma))
    return models


def seeded_arrays(N, seed):
    """Smooth fields from a seed: a few random Fourier modes on the
    domain, h near 1."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-5.0, 5.0, N, endpoint=False)[:, None]
    y = np.linspace(-5.0, 5.0, N, endpoint=False)[None, :]
    k = np.pi / 5

    def field(scale):
        a, b, c, d = rng.standard_normal(4)
        return scale * (a * np.sin(k * x + b) * np.cos(2 * k * y + c)
                        + d * np.cos(k * y))
    return {"h": 1.0 + field(0.05), "u": field(0.5), "v": field(0.4),
            "A": field(0.2)}


def state_pair(arrays):
    js = JState(clock=JClock.zero(jnp.float64),
                **{k: jnp.asarray(arrays[k]) for k in FIELDS})
    return js, state_from_numpy(arrays, device="cpu", dtype=torch.float64)


def jax_energies(h0):
    """The JAX CLI's series: the five names of ``energy_report``."""
    def fn(model, state):
        rep = jdiag.energy_report(model, state, h0)
        return {n: rep[n] for n in ENERGY_NAMES}
    return fn


def close(got, want, tol):
    got = got.double().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(np.asarray(got) - want).max()) <= tol * scale


# -- the CLI's series ---------------------------------------------------------------

@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_cli_energies_match_jax_energy_report(formulation, topology):
    """``cli.energies`` gives exactly the five names the JAX CLI keeps of
    ``energy_report``, each within 1e-12."""
    jm, tm = model_pair(formulation, topology)
    js, ts = state_pair(seeded_arrays(32, 1))
    jh0, th0 = state_pair(seeded_arrays(32, 2))
    want = jax_energies(jh0.h)(jm, js)
    got = cli.energies(tm, ts, th0.h)
    assert tuple(got) == ENERGY_NAMES
    for name in ENERGY_NAMES:
        assert float(got[name]) == pytest.approx(float(want[name]),
                                                 rel=1e-12, abs=1e-300), name


# -- the chunk plan --------------------------------------------------------------------

PLAN_K = 4


PLAN_NS = [1, PLAN_K - 1, PLAN_K, PLAN_K + 1, 2 * PLAN_K + 3]


@pytest.mark.parametrize("n", PLAN_NS)
def test_chunk_plan_puts_each_row_at_its_step(n):
    """k-step replays, then the remainder: the plan covers the chunk's
    steps once each and in order, so the rows of replay i land at its
    offset (the rows themselves: ``test_graph_chunk_rows_land_at_their
    _steps`` on the card)."""
    k = min(n, PLAN_K)
    plan = K.chunk_plan(n, k)
    assert [j for _, j in plan[:-1]] == [k] * (len(plan) - 1)
    assert plan[-1][1] == (n % k or k)
    assert [o for o, _ in plan] == list(np.cumsum([0] + [j for _, j in
                                                         plan])[:-1])
    assert sum(j for _, j in plan) == n


def test_a_series_that_reads_the_clock_raises():
    """The clock is no device value in a captured chunk: a series that
    reads it from the state a :class:`GraphChunk` hands it raises, naming
    the clock; a chunk refuses a CPU state."""
    _, tm = model_pair(VI, "periodic", N=16)
    _, st = state_pair(seeded_arrays(16, 4))
    s = K.stack(st)
    with pytest.raises(RuntimeError, match="clock"):
        K.unstack(s, K._NO_CLOCK).clock.time
    chunk = K.GraphChunk(K.KernelStepper(tm), 0.01, 2,
                         lambda st: {"m": st.h.sum()})
    with pytest.raises(ValueError, match="CUDA"):
        chunk(st)


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_windowed_steps_match_multistep_bitwise(formulation, topology):
    """``windowed_steps`` (the one-substage route) passes G on as the
    resident kernel keeps it: on CPU tensors, three steps equal
    ``multistep_reference`` bit for bit and leave the input alone."""
    _, tm = model_pair(formulation, topology, N=16)
    _, st = state_pair(seeded_arrays(16, 6))
    s = K.stack(st)
    kept = s.clone()
    got = K.windowed_steps(tm, s, 0.005, 3)
    assert torch.equal(got, K.multistep_reference(tm, s, 0.005, 3))
    assert torch.equal(s, kept)


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_kernel_stepper_chunk_matches_model_and_jax(formulation, topology):
    """Three steps with the CLI's series through ``KernelStepper`` on the
    CPU against the model's own step and against the JAX package's
    ``resident_step_fn`` with the same series (interpret mode), 32²
    float64, within 1e-12."""
    jm, tm = model_pair(formulation, topology)
    js, ts = state_pair(seeded_arrays(32, 5))
    dt, n = 0.005, 3
    th0, jh0 = ts.h.clone(), js.h

    def series(state):
        return cli.energies(tm, state, th0)

    got, gs = K.KernelStepper(tm).step_fn(dt, n, series)(ts)
    plain, ps = tm.step_fn(dt, n, series)(ts)
    jfn = jax.jit(resident_step_fn(
        jm, dt, n, interpret=True,
        diagnostics=lambda s: jax_energies(jh0)(jm, s)))
    want, ws = jfn(js)
    for k, name in enumerate(FIELDS):
        w = np.asarray(getattr(want, name))
        assert close(got.fields()[k], w, 1e-12), name
        assert close(got.fields()[k], plain.fields()[k].numpy(), 1e-12)
    for name in ENERGY_NAMES:
        assert gs[name].shape == (n,)
        assert close(gs[name], np.asarray(ws[name]), 1e-12), name
        assert close(gs[name], ps[name].numpy(), 1e-12), name
    assert got.clock == plain.clock


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def resident_pair(model, s, dt, n_steps):
    """(one resident launch, 3·n one-substage launches) of n_steps steps,
    with the counters read in between."""
    K.reset_counters()
    x = K.multistep(model, s, dt, n_steps)
    assert (K.multistep.launches, K.multistep.substages,
            K.substage.launches) == (1, 3 * n_steps, 0)
    y = K.windowed_steps(model, s, dt, n_steps)
    assert K.substage.launches == 3 * n_steps
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize(
    "cfg,options", branch_cases(),
    ids=[f"{f}-{'-'.join(t)}-{o}" for (f, t, _), o in branch_cases()])
def test_resident_matches_substage_launches_bitwise(cuda, cfg, options,
                                                    dtype):
    """Two steps through one resident launch equal six one-substage
    launches bit for bit, at 72² (ragged tiles), in each branch of
    port_cases.branch_cases, with wall-reaching fields."""
    formulation, topology, gamma = cfg
    model, state = bench_model(72, dtype, cuda, formulation, topology,
                               gamma, walls=True)
    model = with_options(model, options, 0.005)
    x, y = resident_pair(model, K.stack(state), 0.005, 2)
    assert torch.isfinite(x).all()
    assert torch.equal(x, y), f"{(x - y).abs().max().item():.3e} off"


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_resident_walks_uneven_tiles_bitwise(cuda, formulation):
    """At 1000² float32 the kernel's tiles (32×32, ragged at the far
    edges) outnumber the blocks the card holds at once, and do not divide
    evenly among them: blocks walk different numbers of tiles, and three
    steps still equal nine one-substage launches bit for bit."""
    model, state = bench_model(1000, torch.float32, cuda, formulation)
    s = K.stack(state)
    smem, regs, blocks, grid = K.ready(model, s)
    tiles = K.resident_tiles(1000, 1000, 32)
    assert grid < tiles and tiles % grid
    x, y = resident_pair(model, s, 0.001, 3)
    assert torch.equal(x, y), f"{(x - y).abs().max().item():.3e} off"


def scenario(name, formulation, dtype, device):
    model, state, sc = scenarios.build(name, formulation, dtype=dtype,
                                       device=device)
    return model, state, sc.dt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_graph_chunk_matches_eager_chunk_bitwise(cuda, formulation, dtype):
    """Seven steps with the CLI's series as replays of a 3-step graph and
    a 1-step one equal the eager chunk (a resident launch a step, then the
    series) bit for bit, state and series; each replay counts the
    launches its graph holds."""
    model, state, dt = scenario("128x128_two_Gaussians_high_B",
                                formulation, dtype, cuda)
    h0 = state.h.clone()

    def series(st):
        return cli.energies(model, st, h0)

    stepper = K.KernelStepper(model)
    assert K.takes_resident(model, state.h)
    chunk = K.GraphChunk(stepper, dt, 7, series, k=3)
    want, ws = run_steps(stepper.one_step(dt), dt, 7, series)(state)
    K.reset_counters()
    got, gs = chunk(state)
    assert (K.multistep.launches, K.multistep.substages,
            K.substage.launches) == (7, 21, 0)
    got2, gs2 = chunk(state)
    assert (K.multistep.launches, K.multistep.substages) == (14, 42)
    assert sorted(chunk.graphs) == [1, 3]
    for a, b, c in zip(got.fields(), want.fields(), got2.fields()):
        assert torch.equal(a, b) and torch.equal(c, b)
    for name in ENERGY_NAMES:
        assert torch.equal(gs[name], ws[name]), name
        assert torch.equal(gs2[name], ws[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", PLAN_NS)
def test_graph_chunk_rows_land_at_their_steps(cuda, n):
    """Through replays of ``chunk_plan``'s graphs the series rows and the
    state equal the eager chunk's bit for bit, the clock advances by n
    steps and the state returned is the static buffer's clone."""
    model, state, dt = scenario("128x128_low_B_low_U", VI, torch.float64,
                                cuda)
    state = state.replace(clock=Clock(0.25, 7))

    def series(st):
        return {"mass": st.h.sum(), "A2": (st.A * st.A).sum()}

    stepper = K.KernelStepper(model)
    chunk = K.GraphChunk(stepper, dt, n, series, k=PLAN_K)
    got, gs = chunk(state)
    want, ws = run_steps(stepper.one_step(dt), dt, n, series)(state)
    assert sorted(chunk.graphs) == sorted({j for _, j in chunk.plan})
    assert list(gs) == ["mass", "A2"]
    for name in ws:
        assert gs[name].shape == (n,)
        assert torch.equal(gs[name], ws[name]), name
    for a, b in zip(got.fields(), want.fields()):
        assert torch.equal(a, b)
    assert got.clock == want.clock == Clock(0.25 + n * dt, 7 + n)
    assert got.h.data_ptr() != chunk.s.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("formulation", [VI, CONS])
def test_graph_chunk_above_l2_takes_one_substage_launches(cuda,
                                                          formulation):
    """At 2048² float32 the resident kernel's working set exceeds the
    card's L2: the stepper takes three one-substage launches a step, in
    the graph chunk as in the eager one, bit for bit, and no resident
    launch."""
    model, state = bench_model(2048, torch.float32, cuda, formulation)
    stepper = K.KernelStepper(model)
    assert not K.takes_resident(model, state.h)

    def series(st):
        return {"mass": st.h.sum()}

    chunk = stepper.step_fn(0.001, 5, series)
    K.reset_counters()
    got, gs = chunk(state)
    assert (K.multistep.launches, K.substage.launches) == (0, 15)
    want, ws = run_steps(stepper.one_step(0.001), 0.001, 5, series)(state)
    assert torch.equal(gs["mass"], ws["mass"])
    for a, b in zip(got.fields(), want.fields()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_returned_state_is_not_overwritten_by_a_later_replay(cuda):
    model, state, dt = scenario("128x128_low_B_low_U", VI, torch.float64,
                                cuda)
    fn = K.KernelStepper(model).step_fn(dt, 2, lambda s: {"m": s.h.sum()})
    first, _ = fn(state)
    kept = [f.clone() for f in first.fields()]
    second, _ = fn(first)
    third, _ = fn(second)
    for a, b in zip(first.fields(), kept):
        assert torch.equal(a, b)
    assert not torch.equal(second.h, first.h)
    assert not torch.equal(third.h, second.h)


def host_synced_series(st):
    return {"m": st.h.sum() * float(st.h.max().item())}


def clock_reading_series(st):
    return {"m": st.h.sum() * st.clock.time}


@pytest.mark.cuda
@pytest.mark.parametrize("series", [host_synced_series,
                                    clock_reading_series])
def test_a_series_that_syncs_raises_at_capture(cuda, series):
    """``.item()`` in a series cannot be captured, nor can the clock be
    read: the chunk raises and names the function, and nothing is
    counted."""
    model, state, dt = scenario("128x128_low_B_low_U", CONS, torch.float32,
                                cuda)
    K.reset_counters()
    with pytest.raises(RuntimeError, match=series.__name__):
        K.KernelStepper(model).step_fn(dt, 3, series)(state)
    assert K.multistep.launches == 0 and K.substage.launches == 0
    # the card still runs a chunk afterwards
    out, s = K.KernelStepper(model).step_fn(
        dt, 3, lambda st: {"m": st.h.sum()})(state)
    assert torch.isfinite(out.h).all() and s["m"].shape == (3,)


def wizard_run(model, state, dt, stepper, path):
    """20 steps with the energy series and a TimeStepWizard every 5:
    (final state, Δt after each adjustment, the simulation)."""
    sim = Simulation(model, dt=dt, stop_iteration=20, stepper=stepper)
    history = []

    class Recorded(TimeStepWizard):
        # a TimeStepWizard itself, so that the run queues no chunk past
        # it (a discarded chunk's launches would count)
        def __call__(self, s):
            super().__call__(s)
            history.append(s.dt)
    sim.callbacks["wizard"] = Callback(Recorded(cfl=0.4),
                                       IterationInterval(5))
    h0 = state.h.clone()
    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=lambda m, st: cli.energies(m, st, h0),
        schedule=IterationInterval(1), path=str(path))
    return sim.run(state), history, sim


@pytest.mark.cuda
def test_wizard_change_of_dt_recaptures(cuda, tmp_path):
    """A Δt change clears the simulation's chunk functions: the next chunk
    captures its graphs anew with the new Δt, and the run matches the
    plain stepper's (Δt history within 1e-12, state within 1e-11)."""
    model, state, _ = scenario("128x128_two_Gaussians_high_B", VI,
                               torch.float64, cuda)
    K.reset_counters()
    final, hist, sim = wizard_run(model, state, 0.01,
                                  K.KernelStepper(model),
                                  tmp_path / "kernel.csv")
    assert (K.multistep.launches, K.multistep.substages) == (20, 60)
    want, want_hist, _ = wizard_run(model, state, 0.01, None,
                                    tmp_path / "plain.csv")
    changes = sum(a != b for a, b in zip([0.01] + hist, hist))
    assert changes >= 2
    assert max(abs(a - b) / b for a, b in zip(hist, want_hist)) <= 1e-12
    for a, b in zip(final.fields(), want.fields()):
        assert float((a - b).abs().max()) <= 1e-11 * float(b.abs().max())
