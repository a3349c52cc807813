"""swmhd_tpu_torch's model == swmhd_tpu's at float64, in both
formulations: tendencies, RK3 steps, the scenario initial conditions, the
frozen 1000-step trajectories ``tests/fixtures/jacobian_64.npz``
(vector-invariant) and ``divergence_64.npz`` (conservative), and the
branches beyond the scenarios' model: Laplacian and biharmonic closures,
the VorticityStencil, Centered2 and UpwindBiased3 momentum, mass and
tracer advection (to 1e-10), and the halo widths.

Both packages get the same numpy state (the JAX initial condition, carried
across with ``convert.state_from_numpy``). States agree to 1e-12 of each
field's scale. Tendencies agree to 1e-12 of the largest tendency: the
mass tendency −∇·(u h̃) of a nearly divergence-free vortex is a small
difference of fluxes of order u·h/Δx, so its roundoff is set by those
fluxes, not by its own size. Over 1000 steps roundoff grows by about 1e4
(f32_tolerance.npz against float32 epsilon), so float64 differences stay
near 1e-12 and the fixture bound is 1e-9.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swmhd_tpu
import swmhd_tpu_torch
from port_cases import OPTIONS, initial_fields, option_kwargs
from swmhd_tpu import scenarios as jscen
from swmhd_tpu import (Grid as JGrid, ShallowWaterModel as JModel,
                       FPlane as JFPlane, VECTOR_INVARIANT, CONSERVATIVE,
                       jacobian_lorentz_forcing as j_forcing,
                       divergence_lorentz_forcing as j_div_forcing)
from swmhd_tpu import diagnostics as jdiag
from swmhd_tpu_torch import scenarios as tscen
from swmhd_tpu_torch import diagnostics as tdiag
from swmhd_tpu_torch import (Grid as TGrid, ShallowWaterModel as TModel,
                             FPlane as TFPlane,
                             jacobian_lorentz_forcing as t_forcing,
                             divergence_lorentz_forcing as t_div_forcing)
from swmhd_tpu_torch.convert import state_from_numpy

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE = os.path.join(FIXTURES, "jacobian_64.npz")
FIELDS = ("h", "u", "v", "A")


def fused_test_pair(N=64, formulation=VECTOR_INVARIANT):
    """The initial condition of tests/test_fused.py::build in both
    packages: vortex, height bump, Gaussian dipole (the vortex is the
    transport in the conservative formulation, as there)."""
    L = 10.0
    conservative = formulation == CONSERVATIVE
    jg = JGrid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                       dtype=jnp.float64)
    jm = JModel(grid=jg, formulation=formulation, coriolis=JFPlane(1.0),
                forcing=j_div_forcing() if conservative else j_forcing())
    js = jm.initial_state(
        u=lambda x, y: 5 * y * jnp.exp(-(x**2 + y**2)),
        v=lambda x, y: -5 * x * jnp.exp(-(x**2 + y**2)),
        h=lambda x, y: 1.0 + 0.05 * jnp.exp(-(x**2 + y**2)),
        A=lambda x, y: 0.5 * jnp.exp(-((x - 0.5)**2 + y**2))
        - 0.5 * jnp.exp(-((x + 0.5)**2 + y**2)))
    tg = TGrid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                       dtype=torch.float64, device="cpu")
    tm = TModel(grid=tg, formulation=formulation, coriolis=TFPlane(1.0),
                forcing=t_div_forcing() if conservative else t_forcing())
    return jm, js, tm, to_torch(js)


def scenario_pair(name, formulation=VECTOR_INVARIANT):
    jm, js, _ = jscen.build(name, formulation, dtype=jnp.float64)
    tm, _, _ = tscen.build(name, formulation, dtype=torch.float64,
                           device="cpu")
    return jm, js, tm, to_torch(js)


def to_torch(js):
    return state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                            device="cpu", dtype=torch.float64)


def assert_fields_close(got, want, tol=1e-12, what="", shared_scale=False):
    shared = max(np.max(np.abs(np.asarray(getattr(want, k))))
                 for k in FIELDS)
    for k in FIELDS:
        g = getattr(got, k).numpy()
        w = np.asarray(getattr(want, k))
        scale = shared if shared_scale else max(np.max(np.abs(w)), 1e-300)
        err = np.max(np.abs(g - w)) / scale
        assert err <= tol, f"{what} {k}: {err:.3e}"


PAIRS = {"fused_test_ic": fused_test_pair,
         "64x64_low_B_low_U": lambda: scenario_pair("64x64_low_B_low_U"),
         "adjustment_jacobian": lambda: scenario_pair("adjustment_jacobian")}


CONSERVATIVE_PAIRS = {
    "fused_test_ic": lambda: fused_test_pair(formulation=CONSERVATIVE),
    "64x64_low_B_low_U": lambda: scenario_pair("64x64_low_B_low_U",
                                               CONSERVATIVE),
    "adjustment_divergence": lambda: scenario_pair("adjustment_divergence",
                                                   CONSERVATIVE)}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_tendencies_match_jax(case):
    jm, js, tm, ts = PAIRS[case]()
    assert_fields_close(tm.tendencies(ts), jax.jit(jm.tendencies)(js),
                        what=case, shared_scale=True)


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_step_fn_matches_jax(case):
    jm, js, tm, ts = PAIRS[case]()
    got = tm.step_fn(0.01, 2)(ts)
    want = jax.jit(jm.step_fn(0.01, 2))(js)
    assert_fields_close(got, want, what=case)
    assert got.clock.iteration == int(want.clock.iteration) == 2
    assert got.clock.time == pytest.approx(float(want.clock.time), abs=1e-15)


@pytest.mark.parametrize("case", sorted(CONSERVATIVE_PAIRS))
def test_conservative_tendencies_match_jax(case):
    jm, js, tm, ts = CONSERVATIVE_PAIRS[case]()
    assert_fields_close(tm.tendencies(ts), jax.jit(jm.tendencies)(js),
                        what=case, shared_scale=True)


@pytest.mark.parametrize("case", sorted(CONSERVATIVE_PAIRS))
def test_conservative_step_fn_matches_jax(case):
    jm, js, tm, ts = CONSERVATIVE_PAIRS[case]()
    got = tm.step_fn(0.01, 2)(ts)
    want = jax.jit(jm.step_fn(0.01, 2))(js)
    assert_fields_close(got, want, what=case)
    assert got.clock.iteration == int(want.clock.iteration) == 2


@pytest.mark.parametrize("name", sorted(jscen.names()))
def test_scenario_initial_conditions_match_jax(name):
    _, js, jsc = jscen.build(name, VECTOR_INVARIANT, dtype=jnp.float64)
    _, ts, tsc = tscen.build(name, dtype=torch.float64, device="cpu")
    assert_fields_close(ts, js, tol=1e-14, what=name)
    for key in ("N", "L", "g", "f", "dt", "stop_time", "h0", "topology",
                "A_bg_grad_y"):
        assert getattr(tsc, key) == getattr(jsc, key), key


@pytest.mark.parametrize("name", sorted(jscen.names()))
def test_conservative_scenario_initial_conditions_match_jax(name):
    """Transports uh = u0·h0 where the scenario has a velocity; the
    forcing is the divergence form."""
    jm, js, _ = jscen.build(name, CONSERVATIVE, dtype=jnp.float64)
    tm, ts, _ = tscen.build(name, CONSERVATIVE, dtype=torch.float64,
                            device="cpu")
    assert_fields_close(ts, js, tol=1e-14, what=name)
    ((key, fn),) = tm.forcing
    assert key == ("uh", "vh") == tuple(dict(jm.forcing))[0]
    assert fn.divergence_lorentz_A_bg_grad_y == tm.A_background_gradient_y


@pytest.mark.parametrize("case", ["fused_test_ic", "64x64_low_B_low_U"])
def test_conservative_velocities_and_energies_match_jax(case):
    """Physical velocities, transports and both energy reports (the
    reference's index-aligned kinetic energy is ½(uh²+vh²)/h here)."""
    jm, js, tm, ts = CONSERVATIVE_PAIRS[case]()
    for got, want in zip(tm.velocities(ts) + tm.transports(ts),
                         jm.velocities(js) + jm.transports(js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-13, atol=1e-15)
    for t_fn, j_fn in ((tdiag.reference_energy_report,
                        jdiag.reference_energy_report),
                       (tdiag.energy_report, jdiag.energy_report)):
        got, want = t_fn(tm, ts, ts.h), j_fn(jm, js, js.h)
        for name, value in got.items():
            assert float(value) == pytest.approx(float(want[name]),
                                                 rel=1e-12, abs=1e-15), name


def test_step_fn_diagnostics_series_on_device():
    _, _, tm, ts = fused_test_pair(N=32)
    fn = tm.step_fn(0.01, 3, diagnostics=lambda s: {"mass": s.h.sum()})
    out, series = fn(ts)
    assert series["mass"].shape == (3,)
    assert float(series["mass"][-1]) == pytest.approx(float(out.h.sum()))
    assert out.clock.iteration == 3


def test_frozen_trajectory_1000_steps():
    want = np.load(FIXTURE)
    tm, ts, _ = tscen.build("64x64_two_Gaussians_high_B", dtype=torch.float64,
                            device="cpu")
    got = tm.step_fn(0.01, 1000)(ts)
    for k in FIELDS:
        err = np.max(np.abs(getattr(got, k).numpy() - want[k]))
        assert err <= 1e-9, f"{k}: {err:.3e}"


def test_frozen_divergence_trajectory_1000_steps():
    want = np.load(os.path.join(FIXTURES, "divergence_64.npz"))
    tm, ts, _ = tscen.build("64x64_two_Gaussians_high_B", CONSERVATIVE,
                            dtype=torch.float64, device="cpu")
    got = tm.step_fn(0.01, 1000)(ts)
    for k in FIELDS:
        err = np.max(np.abs(getattr(got, k).numpy() - want[k]))
        assert err <= 1e-9, f"{k}: {err:.3e}"


def test_unported_configurations_raise():
    """Only an unknown formulation or vorticity stencil raises; a closure
    and Centered2 momentum, which raised before they were ported, build
    models whose tendencies are JAX's."""
    tg = TGrid.regular(16, 16, (-5, 5), (-5, 5), dtype=torch.float64,
                       device="cpu")
    with pytest.raises(ValueError, match="unknown formulation"):
        TModel(grid=tg, formulation="divergence")
    with pytest.raises(ValueError, match="unknown vector_invariant_stencil"):
        TModel(grid=tg, vector_invariant_stencil="ζ")
    for formulation, options in ((CONSERVATIVE, "laplacian"),
                                 (VECTOR_INVARIANT, "centered2 momentum")):
        jm, js, tm, ts = branch_pair(formulation, ("periodic", "periodic"),
                                     options, N=16)
        assert_fields_close(tm.tendencies(ts), jm.tendencies(js),
                            tol=1e-10, what=options, shared_scale=True)


# viscosity of each closure: ν·dt/dx^p of 0.002 (Laplacian) and 0.0002
# (biharmonic) at 32² and dt = 0.01
BRANCH_NU = {"laplacian": 2e-3, "biharmonic": 2e-5}
# (formulation, topology, options): the vorticity stencil and the mass
# scheme act only in the vector-invariant formulation
BRANCH_CASES = [(f, t, o) for f in (VECTOR_INVARIANT, CONSERVATIVE)
                for t in (("periodic", "periodic"), ("bounded", "bounded"))
                for o in OPTIONS
                if f == VECTOR_INVARIANT or o != "vorticity stencil"]


def branch_pair(formulation, topology, options, N=32):
    """``(jax model, jax state, port model, port state)`` of
    tests/test_torch_substage.py's configuration (walled fields where
    there are walls) with ``options``, an entry of port_cases.OPTIONS, or
    none."""
    conservative = formulation == CONSERVATIVE
    gamma = -0.05 if "bounded" in topology else 0.0
    ext = ((-5.0, 5.0), (-5.0, 5.0))
    kw = dict(formulation=formulation, A_background_gradient_y=gamma)
    nu = BRANCH_NU.get(options, 0.0)
    jkw = option_kwargs(options, swmhd_tpu, nu)
    tkw = option_kwargs(options, swmhd_tpu_torch, nu)
    jm = JModel(grid=JGrid.regular(N, N, *ext, topology=topology,
                                   dtype=jnp.float64),
                coriolis=JFPlane(1.0),
                forcing=j_div_forcing(gamma) if conservative
                else j_forcing(gamma), **kw, **jkw)
    js = jm.initial_state(**initial_fields(jnp, h_bump=0.05,
                                           walls="bounded" in topology))
    tm = TModel(grid=TGrid.regular(N, N, *ext, topology=topology,
                                   dtype=torch.float64, device="cpu"),
                coriolis=TFPlane(1.0),
                forcing=t_div_forcing(gamma) if conservative
                else t_forcing(gamma), **kw, **tkw)
    return jm, js, tm, to_torch(js)


@pytest.mark.parametrize("formulation,topology,options", BRANCH_CASES,
                         ids=[f"{f}-{t[0]}-{o}" for f, t, o in BRANCH_CASES])
def test_branch_tendencies_match_jax(formulation, topology, options):
    """Each new branch's tendencies equal JAX's within 1e-10 of the
    largest tendency (the JAX model runs eagerly: no compile per branch),
    and differ from the default model's by more than 100 times that, so
    a kernel that ignored the option would fail its comparison."""
    jm, js, tm, ts = branch_pair(formulation, topology, options)
    got = tm.tendencies(ts)
    assert_fields_close(got, jm.tendencies(js), tol=1e-10, what=options,
                        shared_scale=True)
    base = branch_pair(formulation, topology, None)[2].tendencies(ts)
    scale = max(float(getattr(got, k).abs().max()) for k in FIELDS)
    moved = max(float((getattr(got, k) - getattr(base, k)).abs().max())
                for k in FIELDS)
    assert moved > 100 * 1e-10 * scale, (options, moved / scale)


@pytest.mark.parametrize("options", [None, "laplacian", "biharmonic",
                                     "centered2 momentum",
                                     "upwind3 mass, centered2 tracer"])
def test_halo_and_exchange_halo_match_jax(options):
    jm, _, tm, _ = branch_pair(VECTOR_INVARIANT, ("periodic", "periodic"),
                               options, N=16)
    assert (tm.halo, tm.exchange_halo) == (jm.halo, jm.exchange_halo)
    if options == "biharmonic":
        assert tm.exchange_halo == 7


def test_biharmonic_steps_match_jax():
    """Two RK3 steps with a biharmonic closure on walled grids."""
    for formulation in (VECTOR_INVARIANT, CONSERVATIVE):
        jm, js, tm, ts = branch_pair(formulation, ("periodic", "bounded"),
                                     "biharmonic", N=16)
        state = js
        for _ in range(2):
            state = jm.step(state, 0.01)
        assert_fields_close(tm.step_fn(0.01, 2)(ts), state, tol=1e-12,
                            what=formulation)
