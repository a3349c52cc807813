"""swmhd_tpu_torch's TimeStepWizard and the diagnostics behind it, held
against swmhd_tpu at float64 on the CPU.

- ``total_energy``, ``total_energy_deviation``, ``derived_fields`` and
  ``cfl_numbers`` on the same seeded numpy state, both formulations,
  periodic and walled in y (γ = −0.05): derived fields within 1e-12 of
  each field's scale, the CFL numbers within 1e-14 relative (maxima and a
  square root are exact or correctly rounded).
- The JAX package's ``test_time_step_wizard`` run through both packages,
  and ``64x64_two_Gaussians_high_B`` with a wizard every 5 iterations and
  an energy series, from a Δt above the target CFL: Δt after every
  adjustment within 1e-15 relative, states within 1e-12, series rows
  within 1e-10.
- Each clamp of the wizard, its stepper-cache clearing and a wizard
  reattached to another grid.
- Four ranks over gloo (``tests/torch_group_worker.py``) on a 2×2 mesh:
  the same Δt history on every rank and as one process, and
  ``cfl_numbers`` on tiles equal to the whole grid's.
- The small API the JAX package has: exports, ``Grid.with_dtype``,
  ``State.shape``, ``Clock.zero``, ``progress_callback(h0=None)``.
"""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swmhd_tpu
import swmhd_tpu_torch
import torch_group_worker as G
from swmhd_tpu import diagnostics as jdiag
from swmhd_tpu import scenarios as jscen
from swmhd_tpu.io import ScalarSeriesWriter as JSeriesWriter
from swmhd_tpu.models.state import Clock as JClock, State as JState
from swmhd_tpu_torch import diagnostics as tdiag
from swmhd_tpu_torch import scenarios as tscen
from swmhd_tpu_torch.convert import state_from_numpy
from swmhd_tpu_torch.io import ScalarSeriesWriter as TSeriesWriter
from swmhd_tpu_torch.io.readers import ScalarTimeSeries
from swmhd_tpu_torch.ops.substage import KernelStepper

torch.set_num_threads(1)

FIELDS = ("h", "u", "v", "A")
FORMULATIONS = ("vector_invariant", "conservative")
TOPOLOGIES = {"periodic": ("periodic", "periodic"),
              "walled_y": ("periodic", "bounded")}
ENERGIES = ("kinetic_energy", "magnetic_energy", "potential_energy",
            "total_energy")


def model_pair(formulation, topology, shape=(32, 24), g_acc=9.81):
    """The same model in both packages: FPlane(1), the formulation's
    Lorentz forcing, γ = −0.05 when walled."""
    gamma = -0.05 if topology == "walled_y" else 0.0
    models = []
    for pkg, kw in ((swmhd_tpu, {"dtype": jnp.float64}),
                    (swmhd_tpu_torch, {"dtype": torch.float64,
                                       "device": "cpu"})):
        g = pkg.Grid.regular(*shape, (-5.0, 5.0), (-4.0, 4.0),
                             topology=TOPOLOGIES[topology], **kw)
        forcing = (pkg.divergence_lorentz_forcing(gamma)
                   if formulation == "conservative"
                   else pkg.jacobian_lorentz_forcing(gamma))
        models.append(pkg.ShallowWaterModel(
            grid=g, formulation=formulation, coriolis=pkg.FPlane(1.0),
            forcing=forcing, A_background_gradient_y=gamma,
            gravitational_acceleration=g_acc))
    return models


def seeded_arrays(shape, seed):
    rng = np.random.default_rng(seed)
    return {"h": 1.0 + 0.2 * rng.random(shape),
            "u": 0.5 * rng.standard_normal(shape),
            "v": 0.3 * rng.standard_normal(shape),
            "A": 0.2 * rng.standard_normal(shape)}


def state_pair(arrays):
    js = JState(clock=JClock.zero(jnp.float64),
                **{k: jnp.asarray(arrays[k]) for k in FIELDS})
    return js, state_from_numpy(arrays, device="cpu", dtype=torch.float64)


def assert_field_close(got, want, tol, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale, what


# -- the diagnostics -------------------------------------------------------------

@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_diagnostics_match_jax(formulation, topology):
    jm, tm = model_pair(formulation, topology)
    js, ts = state_pair(seeded_arrays((32, 24), 1))
    jh0, th0 = state_pair(seeded_arrays((32, 24), 2))
    jh0, th0 = jh0.h, th0.h

    jd = jdiag.derived_fields(jm, js, jh0)
    td = tdiag.derived_fields(tm, ts, th0)
    assert sorted(td) == sorted(jd)
    for name in jd:
        assert_field_close(td[name], jd[name], 1e-12, name)
    assert sorted(tdiag.derived_fields(tm, ts)) == sorted(
        jdiag.derived_fields(jm, js))

    g = tm.gravitational_acceleration
    gamma = tm.A_background_gradient_y
    ju, jv = jm.velocities(js)
    tu, tv = tm.velocities(ts)
    jE = jdiag.total_energy(ju, jv, js.h, js.A, jh0, g, jm.grid, gamma)
    tE = tdiag.total_energy(tu, tv, ts.h, ts.A, th0, g, tm.grid, gamma)
    assert float(tE) == pytest.approx(float(jE), rel=1e-12)
    jE0 = jdiag.total_energy(ju, jv, jh0, js.A, jh0, g, jm.grid, gamma)
    tE0 = tdiag.total_energy(tu, tv, th0, ts.A, th0, g, tm.grid, gamma)
    assert float(tdiag.total_energy_deviation(tE, tE0)) == pytest.approx(
        float(jdiag.total_energy_deviation(jE, jE0)), rel=1e-10)

    for dt in (0.01, 0.0037):
        want = [float(c) for c in jdiag.cfl_numbers(jm, js, dt)]
        got = [float(c) for c in tdiag.cfl_numbers(tm, ts, dt)]
        assert min(want) > 0
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


# -- the wizard against the JAX wizard -----------------------------------------

def record_wizard(pkg, history, **kw):
    """A Callback function running ``pkg``'s wizard and recording
    ``sim.dt`` after each adjustment."""
    wizard = pkg.TimeStepWizard(**kw)

    def adjust(sim):
        wizard(sim)
        history.append(sim.dt)
    return adjust


def centered_model(pkg, N=32, g_acc=1.0):
    """tests/test_simulation.py's wizard model."""
    kw = ({"dtype": jnp.float64} if pkg is swmhd_tpu
          else {"dtype": torch.float64, "device": "cpu"})
    g = pkg.Grid.regular(N, N, (0, 1), (0, 1), **kw)
    return pkg.ShallowWaterModel(grid=g, momentum_advection="centered2",
                                 mass_advection="centered2",
                                 tracer_advection="centered2",
                                 gravitational_acceleration=g_acc)


def assert_states_close(got, want, tol=1e-12):
    for k in FIELDS:
        assert_field_close(getattr(got, k), getattr(want, k), tol, k)


def test_time_step_wizard_matches_jax():
    """The JAX package's test_time_step_wizard: Δt = 0.5, grossly over the
    wave CFL, shrunk every iteration by both wizards alike."""
    histories, finals = [], []
    for pkg in (swmhd_tpu, swmhd_tpu_torch):
        model = centered_model(pkg)
        sim = pkg.Simulation(model, dt=0.5, stop_iteration=4)
        history = []
        sim.callbacks["wizard"] = pkg.Callback(
            record_wizard(pkg, history, cfl=0.5, min_change=0.1),
            pkg.IterationInterval(1))
        finals.append(sim.run(model.initial_state(h=1.0)))
        histories.append(history)
        assert sim.dt < 0.5
    jh, th = histories
    assert len(th) == len(jh) == 5
    np.testing.assert_allclose(th, jh, rtol=1e-15, atol=0)
    assert_states_close(finals[1], finals[0])


@pytest.fixture(scope="module", params=FORMULATIONS)
def jax_wizard_run(request, tmp_path_factory):
    """64x64_two_Gaussians_high_B through the JAX package with a wizard
    every 5 iterations and an energy series: (formulation, Δt history,
    final state, CSV path)."""
    formulation = request.param
    dt, cfl, every, steps = G.WIZARD_RUN
    model, state, _ = jscen.build(G.WIZARD_SCENARIO, formulation,
                                  dtype=jnp.float64)
    path = str(tmp_path_factory.mktemp("jax") / "energies.csv")
    sim = swmhd_tpu.Simulation(model, dt=dt, stop_iteration=steps)
    history = []
    sim.callbacks["wizard"] = swmhd_tpu.Callback(
        record_wizard(swmhd_tpu, history, cfl=cfl),
        swmhd_tpu.IterationInterval(every))
    h0 = state.h
    sim.output_writers["energies"] = JSeriesWriter(
        fn=lambda m, s: {k: v for k, v in
                         jdiag.energy_report(m, s, h0).items()
                         if k in ENERGIES},
        schedule=swmhd_tpu.IterationInterval(1), path=path)
    final = sim.run(state)
    return formulation, history, final, path


@pytest.mark.parametrize("stepper", ["plain", "kernel"])
def test_wizard_scenario_run_matches_jax(jax_wizard_run, stepper, tmp_path):
    """The scenario with a wizard and an energy series through the port's
    plain step and its kernel stepper (the kernel's plain version on the
    CPU): Δt history, series rows and final state equal to JAX's."""
    formulation, jax_history, jax_final, jax_csv = jax_wizard_run
    dt, cfl, every, steps = G.WIZARD_RUN
    model, state, _ = tscen.build(G.WIZARD_SCENARIO, formulation,
                                  dtype=torch.float64, device="cpu")
    sim = swmhd_tpu_torch.Simulation(
        model, dt=dt, stop_iteration=steps,
        stepper=KernelStepper(model) if stepper == "kernel" else None)
    history = []
    sim.callbacks["wizard"] = swmhd_tpu_torch.Callback(
        record_wizard(swmhd_tpu_torch, history, cfl=cfl),
        swmhd_tpu_torch.IterationInterval(every))
    h0 = state.h
    sim.output_writers["energies"] = TSeriesWriter(
        fn=lambda m, s: {k: v for k, v in
                         tdiag.energy_report(m, s, h0).items()
                         if k in ENERGIES},
        schedule=swmhd_tpu_torch.IterationInterval(1),
        path=str(tmp_path / "energies.csv"))
    final = sim.run(state)

    assert len(history) == steps // every + 1
    assert len(set(history)) >= 3 and history[0] < dt   # >= 2 changes
    np.testing.assert_allclose(history, jax_history, rtol=1e-15, atol=0)
    assert_states_close(final, jax_final)
    assert final.clock.iteration == steps
    assert final.clock.time == pytest.approx(float(jax_final.clock.time),
                                             rel=1e-15)
    got, want = ScalarTimeSeries(str(tmp_path / "energies.csv")), \
        ScalarTimeSeries(jax_csv)
    assert sorted(got.columns) == sorted(want.columns)
    np.testing.assert_array_equal(got.iteration, np.arange(steps + 1))
    np.testing.assert_allclose(got.time, want.time, rtol=1e-15, atol=0)
    for name in ENERGIES:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-10,
                                   atol=1e-14, err_msg=name)


# -- each clamp ------------------------------------------------------------------

# (case, dt, wizard keywords, g, expected dt): the centred 32² model at rest
# (h = 1), so the wave CFL is √g·64·Δt and the advective one 0
CLAMPS = [
    ("max_change", 0.001, {"cfl": 0.5}, 1.0, 0.001 * 1.1),
    ("min_change", 0.5, {"cfl": 0.5}, 1.0, 0.5 * 0.5),
    ("min_dt", 0.5, {"cfl": 0.5, "min_change": 0.01, "min_dt": 0.1}, 1.0,
     0.1),
    ("max_dt", 0.001, {"cfl": 0.5, "max_dt": 0.00105}, 1.0, 0.00105),
    ("on_target", 2.0 ** -7, {"cfl": 0.5}, 1.0, 2.0 ** -7),
    ("current_zero", 0.5, {"cfl": 0.5}, 0.0, 0.5),
]


@pytest.mark.parametrize("case,dt,kw,g_acc,want", CLAMPS,
                         ids=[c[0] for c in CLAMPS])
def test_wizard_clamps_match_jax(case, dt, kw, g_acc, want):
    """Each bound of one adjustment, in both packages; the port's stepper
    cache is cleared exactly when Δt changes."""
    got = []
    for pkg in (swmhd_tpu, swmhd_tpu_torch):
        model = centered_model(pkg, g_acc=g_acc)
        sim = pkg.Simulation(model, dt=dt, stop_iteration=1)
        sim.state = model.initial_state(h=1.0)
        if pkg is swmhd_tpu_torch:
            sim._stepper(1)
            assert sim._steppers
        pkg.TimeStepWizard(**kw)(sim)
        got.append(sim.dt)
        if pkg is swmhd_tpu_torch:
            assert bool(sim._steppers) == (sim.dt == dt), case
    assert got[1] == pytest.approx(want, rel=1e-15)
    assert got[1] == pytest.approx(got[0], rel=1e-15)


def test_wizard_reattached_uses_the_new_grid():
    """One wizard on a 32² and then a 64² grid of the same domain: the
    second adjustment reads the 64² spacings (twice the wave CFL), as a
    fresh wizard and the JAX wizard do."""
    wizards = {pkg: pkg.TimeStepWizard(cfl=0.5, min_change=0.01)
               for pkg in (swmhd_tpu, swmhd_tpu_torch)}
    out = {}
    for pkg, wizard in wizards.items():
        for N in (32, 64):
            model = centered_model(pkg, N=N)
            for w in (wizard, pkg.TimeStepWizard(cfl=0.5, min_change=0.01)):
                sim = pkg.Simulation(model, dt=0.1, stop_iteration=1)
                sim.state = model.initial_state(h=1.0)
                w(sim)
                out.setdefault((pkg, N), []).append(sim.dt)
    for N, want in ((32, 0.5 / 64), (64, 0.5 / 128)):
        for pkg in wizards:
            np.testing.assert_allclose(out[(pkg, N)], [want, want],
                                       rtol=1e-15)


# -- decomposed -------------------------------------------------------------------

def test_decomposed_wizard_matches_one_process(tmp_path):
    """A 2×2 mesh of gloo ranks: every rank takes the same Δt at every
    adjustment, equal to one process's; the state agrees to 1e-12, the
    ScalarWriter (rank 0's file, outputs reduced over ranks) to 1e-10,
    and cfl_numbers on tiles equals the whole grid's."""
    reports = G.run_group("wizard", 4, tmp_path)
    model, state, _ = tscen.build(G.WIZARD_SCENARIO, dtype=torch.float64,
                                  device="cpu")
    history = []
    sim = G.wizard_simulation(model, KernelStepper(model),
                              str(tmp_path / "one.csv"), history)
    final = sim.run(state)

    assert len(set(history)) >= 3
    for r in reports:
        assert r["dt_history"] == reports[0]["dt_history"]
        np.testing.assert_allclose(r["dt_history"], history, rtol=1e-15,
                                   atol=0)
        np.testing.assert_allclose(r["tiled_cfl"], r["global_cfl"],
                                   rtol=1e-14, atol=0)
    want = [float(c) for c in tdiag.cfl_numbers(model, final, sim.dt)]
    np.testing.assert_allclose(reports[0]["global_cfl"], want, rtol=1e-12)
    with np.load(tmp_path / "wizard.npz") as z:
        for k in FIELDS:
            assert_field_close(z[k], getattr(final, k).numpy(), 1e-12, k)
    got, one = (ScalarTimeSeries(str(tmp_path / n))
                for n in ("wizard.csv", "one.csv"))
    np.testing.assert_array_equal(got.iteration, one.iteration)
    assert len(one.iteration) == G.WIZARD_RUN[3] // G.WIZARD_RUN[2] + 1
    for name in one.columns:
        np.testing.assert_allclose(got[name], one[name], rtol=1e-10,
                                   atol=1e-14, err_msg=name)


# -- the small API ------------------------------------------------------------------

def _api(pkg):
    """What the API test reads from one package."""
    g = pkg.Grid.regular(8, 6, (0, 1), (0, 2), **(
        {"dtype": jnp.float32} if pkg is swmhd_tpu
        else {"dtype": torch.float32, "device": "cpu"}))
    model = pkg.ShallowWaterModel(grid=g)
    dt64 = jnp.float64 if pkg is swmhd_tpu else torch.float64
    return {
        "exports": sorted(set(pkg.__all__) & set(swmhd_tpu.__all__)),
        "version": pkg.__version__,
        "parallel": sorted(__import__(pkg.__name__ + ".parallel",
                                      fromlist=["x"]).__all__),
        "utils": sorted(__import__(pkg.__name__ + ".utils",
                                   fromlist=["x"]).__all__),
        "io": sorted(__import__(pkg.__name__ + ".io",
                                fromlist=["x"]).__all__),
        "with_dtype": g.with_dtype(dt64).dtype_name,
        "shape": tuple(model.initial_state(h=1.0).shape),
        "clock_zero": (float(pkg.Clock.zero().time),
                       int(pkg.Clock.zero().iteration)),
        "progress_h0": inspect.signature(
            __import__(pkg.__name__ + ".simulation", fromlist=["x"])
            .progress_callback).parameters["h0"].default,
    }


@pytest.mark.parametrize("item", ["exports", "version", "parallel", "utils",
                                  "io", "with_dtype", "shape", "clock_zero",
                                  "progress_h0"])
def test_small_api_matches_jax(item):
    """The port has the JAX package's small API; ``make_pod_mesh`` stays
    out of ``parallel`` on purpose."""
    got, want = _api(swmhd_tpu_torch)[item], _api(swmhd_tpu)[item]
    if item == "exports":
        assert got == sorted(swmhd_tpu.__all__)
    elif item == "parallel":
        assert got == sorted(set(want) - {"make_pod_mesh"})
    else:
        assert got == want


def test_port_api_details():
    """What the JAX API cannot show: Grid.with_dtype keeps the device,
    Clock.zero ignores its dtype, progress_callback(h0) runs, and the
    exported ``profiling`` and ``diagnostics`` are the port's own."""
    g = swmhd_tpu_torch.Grid.regular(8, 8, (0, 1), (0, 1), device="cpu")
    g64 = g.with_dtype(torch.float64)
    assert (g64.device, g64.dtype, g.with_dtype("float64")) == \
        ("cpu", torch.float64, g64)
    assert swmhd_tpu_torch.Clock.zero(torch.float32) == \
        swmhd_tpu_torch.Clock(0.0, 0)
    model = swmhd_tpu_torch.ShallowWaterModel(grid=g64)
    sim = swmhd_tpu_torch.Simulation(model, dt=0.01, stop_iteration=2)
    sim.callbacks["progress"] = swmhd_tpu_torch.Callback(
        swmhd_tpu_torch.simulation.progress_callback(h0=None),
        swmhd_tpu_torch.IterationInterval(1))
    assert sim.run(model.initial_state(h=1.0)).clock.iteration == 2
    assert swmhd_tpu_torch.profiling.__name__ == "swmhd_tpu_torch.profiling"
    assert swmhd_tpu_torch.diagnostics is tdiag
