"""The reference agrees with the port's plain step and energies on the
CPU, and the harness builds the port's state as ``scenarios.build`` does."""

import pytest
import torch

from portbench import harness, traffic
from portbench.reference import swmhd as R

from helpers import tiny_cell

SCENARIOS = {
    "64x64_two_Gaussians_high_B": {"A": ["two_gaussians", 0.5], "uv": None,
                                   "h0": 1.0, "topology_y": "periodic",
                                   "A_bg_grad_y": 0.0},
    "64x64_low_B_low_U": {"A": None, "uv": ["vortex", 1.0], "h0": 1.0,
                          "topology_y": "bounded", "A_bg_grad_y": -0.05},
}
PERTURB = {"h": [(0.3, -0.2, 0.01, 0.5)], "A": [(-1.0, 0.5, 0.02, 0.5)]}


def port_at(name, formulation, dtype, n=32):
    """The port's model and state of ``name`` on an n² grid."""
    import dataclasses
    from swmhd_tpu_torch import scenarios
    sc = scenarios.get(name)
    model, state, _ = scenarios.build(name, formulation, dtype=dtype,
                                      device="cpu")
    if n != sc.N:
        from swmhd_tpu_torch.grid import Grid
        grid = Grid.regular(n, n, (-5.0, 5.0), (-5.0, 5.0),
                            topology=sc.topology, dtype=dtype, device="cpu")
        model = dataclasses.replace(model, grid=grid)
        state = model.initial_state(u=sc.u0, v=sc.v0, h=sc.h0, A=sc.A0)
    return model, state


@pytest.mark.parametrize("formulation", ["vector_invariant", "conservative"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_step_and_energies_agree_with_the_port(name, formulation):
    from swmhd_tpu_torch import cli
    model, st = port_at(name, formulation, torch.float64)
    ini = SCENARIOS[name]
    m = R.Model(R.Grid(32, 10.0, ini["topology_y"]), formulation, 9.81, 1.0,
                ini["A_bg_grad_y"])
    ref = R.initial_state(m, ini, PERTURB)   # transports u·h0, h0 = 1
    st = st.replace(h=st.h + R.bumps(PERTURB["h"], "cc", m.grid,
                                     torch.float64, "cpu"),
                    A=st.A + R.bumps(PERTURB["A"], "cc", m.grid,
                                     torch.float64, "cpu"))
    h0 = ref[0]
    for a, b in zip(st.fields(), ref):
        assert torch.allclose(a, b, rtol=0, atol=1e-14)
    for _ in range(3):
        st = model.step(st, 0.01)
        ref = R.step(m, ref, 0.01)
    for a, b in zip(st.fields(), ref):
        assert torch.allclose(a, b, rtol=0, atol=1e-13)
    e_port = cli.energies(model, st, h0)
    e_ref = R.energies(m, ref, h0)
    assert set(e_port) == set(e_ref)
    for k in e_ref:
        assert abs(float(e_port[k]) - float(e_ref[k])) <= 1e-13


@pytest.mark.parametrize("formulation", ["vector_invariant", "conservative"])
@pytest.mark.parametrize("traffic_name", ["tiny.series", "tiny.walls"])
def test_harness_builds_what_the_reference_builds(tmp_path, traffic_name,
                                                  formulation):
    """The program's seeded initial state (the harness through the port's
    scenario registry) and the reference's own (from the traffic file)
    agree to float32 rounding."""
    cell = tiny_cell(tmp_path, traffic_name,
                     "jacobian" if formulation == "vector_invariant"
                     else "divergence")
    p = traffic.perturbation(cell.traffic["perturbation"], 2 ** 31 + 5)
    _, state = harness.build_program(cell, p, "cpu")
    from portbench.check import Judge
    ref = Judge(cell, p, "cpu").init
    for a, b in zip(state.fields(), ref):
        assert a.dtype == torch.float32
        assert float((a.double() - b).abs().max()) <= 1e-6


def test_harness_build_matches_scenarios_build():
    """At the scenario's own grid the harness's model and state are those
    of ``scenarios.build`` (no perturbation)."""
    from swmhd_tpu_torch import scenarios

    class C:
        config = harness.load(f"{harness.PKG}/configs/divergence.json")
        traffic = {"scenario": "64x64_low_B_low_U", "N": 64,
                   "initial": {"h0": 1.0, "A_bg_grad_y": -0.05,
                               "topology_y": "bounded"}}
    model, state = harness.build_program(C, {"h": [], "A": []}, "cpu")
    m2, s2, _ = scenarios.build("64x64_low_B_low_U", "conservative",
                                device="cpu")
    for key in ("grid", "formulation", "gravitational_acceleration",
                "coriolis", "momentum_advection", "mass_advection",
                "tracer_advection", "A_background_gradient_y"):
        assert getattr(model, key) == getattr(m2, key)
    assert [k for k, _ in model.forcing] == [k for k, _ in m2.forcing]
    for a, b in zip(state.fields(), s2.fields()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config", ["jacobian", "divergence"])
def test_a_scheme_the_reference_does_not_compute_is_refused(config):
    """Each configuration states the scheme the reference computes, and a
    configuration that states another is refused by the reference and,
    for the closure, by the harness."""
    conf = harness.load(f"{harness.PKG}/configs/{config}.json")
    R.check_scheme(conf)
    for key, value in (("closure", "laplacian"), ("time_stepper", "RK4"),
                       ("momentum_advection", "centered2")):
        with pytest.raises(ValueError):
            R.check_scheme({**conf, key: value})

    class C:
        config = {**conf, "closure": "laplacian"}
        traffic = {"scenario": "64x64_low_B_low_U", "N": 64,
                   "initial": {"h0": 1.0, "A_bg_grad_y": -0.05,
                               "topology_y": "bounded"}}
    with pytest.raises(ValueError):
        harness.build_program(C, {"h": [], "A": []}, "cpu")
