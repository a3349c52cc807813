"""The CUDA substage module (swmhd_tpu_torch.ops.substage).

On the CPU: the plain versions against the JAX Pallas kernels they port,
run as tests/test_fused.py runs them (interpret mode), at 32² float64 to
1e-12 of each field's scale — ``multistep_reference`` against
``resident_step_fn`` and chained ``substage_reference`` calls against
``fused_step_fn``, in both formulations, periodic and wall-bounded; the
wrappers' CPU dispatch (plain version, no launch); and the
configurations the kernel rejects.

Tests marked ``cuda`` run the kernel itself and skip without a card:
``python -m pytest tests/test_torch_substage.py -m cuda`` on the GPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swmhd_tpu import (Grid as JGrid, ShallowWaterModel as JModel,
                       FPlane as JFPlane, jacobian_lorentz_forcing as jforce,
                       divergence_lorentz_forcing as jdivforce)
import swmhd_tpu
from swmhd_tpu.ops.fused_step import (build_fused_calls, fused_step_fn,
                                      resident_step_fn)
from swmhd_tpu_torch import (Grid as TGrid, ShallowWaterModel as TModel,
                             FPlane as TFPlane,
                             jacobian_lorentz_forcing as tforce,
                             divergence_lorentz_forcing as tdivforce)
from swmhd_tpu_torch.convert import state_from_numpy
import swmhd_tpu_torch
from swmhd_tpu_torch.ops import substage as K
from chip_smoke import OPTIONS, initial_fields, option_kwargs, stable_nu

torch.set_num_threads(1)

L = 10.0
FIELDS = ("h", "u", "v", "A")


def ic(xp, walls=False):
    """Vortex, height bump, Gaussian dipole; with ``walls``, plus
    chip_smoke's smooth wall-reaching terms, so a wall-bounded run has
    structure next to its walls."""
    return initial_fields(xp, h_bump=0.05, walls=walls)


def torch_model(N=32, dtype=torch.float64, device="cpu", topology=None,
                **kw):
    g = TGrid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                      topology=topology or ("periodic", "periodic"),
                      dtype=dtype, device=device)
    kw.setdefault("forcing", tforce())
    return TModel(grid=g, coriolis=TFPlane(1.0), **kw)


def jax_pair(N=32, formulation="vector_invariant",
             topology=("periodic", "periodic"), gamma=0.0, options=None,
             nu=0.0):
    """The same model and initial state in both packages (the vortex is
    the transport in the conservative formulation), with ``options`` (an
    entry of chip_smoke.OPTIONS; closures of viscosity ``nu``)."""
    conservative = formulation == "conservative"
    g = JGrid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                      topology=topology, dtype=jnp.float64)
    jm = JModel(grid=g, formulation=formulation, coriolis=JFPlane(1.0),
                forcing=jdivforce(gamma) if conservative else jforce(gamma),
                A_background_gradient_y=gamma,
                **option_kwargs(options, swmhd_tpu, nu))
    js = jm.initial_state(**ic(jnp, walls="bounded" in topology))
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                          device="cpu", dtype=torch.float64)
    tm = torch_model(N, topology=topology, formulation=formulation,
                     forcing=tdivforce(gamma) if conservative
                     else tforce(gamma),
                     A_background_gradient_y=gamma,
                     **option_kwargs(options, swmhd_tpu_torch, nu))
    return jm, js, tm, ts


def assert_close(got, want, tol):
    """got: stacked (4, N, N) tensor; want: a JAX State."""
    for n, k in enumerate(FIELDS):
        w = np.asarray(getattr(want, k), dtype=np.float64)
        err = np.max(np.abs(got[n].double().cpu().numpy() - w))
        assert err <= tol * np.max(np.abs(w)), f"{k}: {err:.3e}"


def test_multistep_reference_matches_resident_kernel():
    jm, js, tm, ts = jax_pair()
    want = resident_step_fn(jm, 0.01, n_steps=3, interpret=True)(js)
    assert_close(K.multistep_reference(tm, K.stack(ts), 0.01, 3), want,
                 1e-12)


def test_substage_reference_matches_windowed_kernel():
    jm, js, tm, ts = jax_pair()
    want = fused_step_fn(jm, 0.01, n_steps=2, tile_x=16, halo=8,
                         interpret=True)(js)
    s = K.stack(ts)
    for _ in range(2):
        g = None
        for stage in range(3):
            s, g = K.substage_reference(tm, s, 0.01, stage, g)
    assert_close(s, want, 1e-12)


# (formulation, topology, A_background_gradient_y): the kernel's branches
# beyond the periodic vector-invariant one
BRANCHES = {
    "conservative periodic": ("conservative", ("periodic", "periodic"), 0.0),
    "vector_invariant bounded y": ("vector_invariant",
                                   ("periodic", "bounded"), -0.05),
    "conservative bounded y": ("conservative", ("periodic", "bounded"),
                               -0.05),
}
RESIDENT_BRANCHES = dict(BRANCHES, **{
    "vector_invariant bounded xy": ("vector_invariant",
                                    ("bounded", "bounded"), -0.05),
    "conservative bounded xy": ("conservative", ("bounded", "bounded"),
                                -0.05),
})


@pytest.mark.parametrize("case", sorted(RESIDENT_BRANCHES))
def test_multistep_reference_matches_resident_kernel_branches(case):
    jm, js, tm, ts = jax_pair(32, *RESIDENT_BRANCHES[case])
    want = resident_step_fn(jm, 0.01, n_steps=3, interpret=True)(js)
    assert_close(K.multistep_reference(tm, K.stack(ts), 0.01, 3), want,
                 1e-12)


def test_substage_reference_matches_windowed_kernel_biharmonic():
    """One substage of the JAX K1 kernel (interpret mode) with a
    biharmonic closure at 16² against the plain substage: the new state
    and G."""
    jm, js, tm, ts = jax_pair(16, options="biharmonic", nu=2e-5)
    calls, _, H = build_fused_calls(jm, 0.01, tile_x=8, halo=8,
                                    interpret=True)
    pad = lambda f: jnp.concatenate([f[-H:], f, f[:H]], axis=0)
    out = calls[0](jnp.zeros((1,), jnp.float64),
                   *(pad(getattr(js, k)) for k in FIELDS))
    s_new, G = K.substage_reference(tm, K.stack(ts), 0.01, 0)
    for n, k in enumerate(FIELDS):
        for got, want in ((s_new[n], out[n][H:-H]), (G[n], out[4 + n])):
            w = np.asarray(want)
            assert np.abs(got.numpy() - w).max() <= 1e-12 * np.abs(w).max()


@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_substage_reference_matches_windowed_kernel_branches(case):
    jm, js, tm, ts = jax_pair(32, *BRANCHES[case])
    want = fused_step_fn(jm, 0.01, n_steps=2, tile_x=16, halo=8,
                         interpret=True)(js)
    s = K.stack(ts)
    for _ in range(2):
        g = None
        for stage in range(3):
            s, g = K.substage_reference(tm, s, 0.01, stage, g)
    assert_close(s, want, 1e-12)


def test_cpu_tensors_take_the_plain_version():
    K.reset_counters()
    tm = torch_model(16)
    s = K.stack(tm.initial_state(**ic(torch)))
    a, G = K.substage(tm, s, 0.01, 0)
    b, G_ref = K.substage_reference(tm, s, 0.01, 0)
    assert torch.equal(a, b) and torch.equal(G, G_ref)
    assert K.substage(tm, s, 0.01, 0, write_G=False)[1] is None
    assert torch.equal(K.multistep(tm, s, 0.01, 2),
                       K.multistep_reference(tm, s, 0.01, 2))
    assert K.substage.launches == 0 and K.multistep.launches == 0
    assert K.substage_reference.calls > 0


# (branch of BRANCHES/RESIDENT_BRANCHES or None for the periodic
# vector-invariant model, per-step diagnostics)
STEPPER_CASES = [
    pytest.param(None, False, id="False"),
    pytest.param(None, True, id="True"),
    pytest.param("conservative bounded y", True,
                 id="conservative bounded y"),
    pytest.param("vector_invariant bounded xy", True,
                 id="vector_invariant bounded xy"),
]


@pytest.mark.parametrize("case,diagnostics", STEPPER_CASES)
def test_kernel_stepper_matches_model_step(case, diagnostics):
    """The stepper's two chunk paths (multistep; substages per step with
    a series) give the model's own RK3 step on the CPU."""
    if case is None:
        tm, walls = torch_model(16), False
    else:
        tm, walls = jax_pair(16, *RESIDENT_BRANCHES[case])[2], True
    st = tm.initial_state(**ic(torch, walls=walls))
    diag = (lambda s: {"mass": s.h.sum()}) if diagnostics else None
    got = K.KernelStepper(tm).step_fn(0.01, 3, diag)(st)
    want = tm.step_fn(0.01, 3, diag)(st)
    if diagnostics:
        (got, gs), (want, ws) = got, want
        assert torch.allclose(gs["mass"], ws["mass"], rtol=1e-14)
    for a, b in zip(got.fields(), want.fields()):
        assert torch.allclose(a, b, rtol=1e-13, atol=1e-13)
    assert got.clock == want.clock


@pytest.mark.parametrize("case", sorted(RESIDENT_BRANCHES))
def test_kernel_params_cover_the_branches(case):
    formulation, topology, gamma = RESIDENT_BRANCHES[case]
    _, _, tm, _ = jax_pair(16, formulation, topology, gamma)
    params = K.kernel_params(tm)
    assert params.branch == (int(formulation == "conservative"),
                             int(topology[0] == "bounded"),
                             int(topology[1] == "bounded"), 0, 0, 0, 0, 0)
    assert params[8:] == (tm.grid.dx, tm.grid.dy, 9.81, 1.0, gamma, 0.0,
                          0.0)
    walls = "x" * (topology[0] == "bounded") + "y" * (topology[1] == "bounded")
    label = f"bounded {walls}" if walls else "periodic"
    assert K.branch_label(params.branch) == f"{formulation}, {label}"


# the model options and the kernel's runtime switches they set:
# (closure, momentum, mass, tracer, stencil) and the label's tail
OPTION_SWITCHES = {
    "laplacian": ((1, 0, 0, 0, 0), "laplacian"),
    "biharmonic": ((2, 0, 0, 0, 0), "biharmonic"),
    "vorticity stencil": ((0, 0, 0, 0, 1), "vorticity stencil"),
    "centered2 momentum": ((0, 2, 0, 0, 0), "centered2 momentum"),
    "upwind3 momentum": ((0, 1, 0, 0, 0), "upwind3 momentum"),
    "upwind3 mass, centered2 tracer": ((0, 0, 1, 2, 0),
                                       "upwind3 mass, centered2 tracer"),
    "centered2 mass, upwind3 tracer": ((0, 0, 2, 1, 0),
                                       "centered2 mass, upwind3 tracer"),
}


@pytest.mark.parametrize("options", OPTIONS)
def test_kernel_params_take_the_options(options):
    """Every model option is a runtime switch of the kernel: accepted, with
    the closure's ν and κ, and named by its branch label."""
    _, _, tm, _ = jax_pair(16, "vector_invariant", ("periodic", "bounded"),
                           -0.05, options, nu=1e-4)
    params = K.kernel_params(tm)
    switches, tail = OPTION_SWITCHES[options]
    assert params.branch == (0, 0, 1, *switches)
    closure = options in ("laplacian", "biharmonic")
    assert (params.nu, params.kappa) == ((1e-4, 1.5 * 1e-4) if closure
                                         else (0.0, 0.0))
    assert K.branch_label(params.branch) == \
        f"vector_invariant, bounded y, {tail}"
    # the tile kernel keeps its intermediates on chip; its tiles follow
    # the formulation's layout, which a biharmonic closure widens
    h100 = (232448, 132)
    assert K.tile_shape(tm.formulation, 2048, 2048, torch.float32,
                        options == "biharmonic", *h100) == (32, 32)
    assert K.smem_bytes(tm.formulation, torch.float32, 32,
                        options == "biharmonic") == (
        80864 if options == "biharmonic" else 69312)


@pytest.mark.parametrize("options", [o for o in OPTIONS
                                     if "mass" in o or "stencil" in o])
def test_conservative_kernel_params_keep_only_used_options(options):
    """The conservative formulation reconstructs no mass and has no
    vorticity flux: those options leave its branch the default's, while
    the tracer's scheme stays."""
    _, _, tm, _ = jax_pair(16, "conservative", ("periodic", "bounded"),
                           -0.05, options)
    closure, momentum, _, tracer, _ = OPTION_SWITCHES[options][0]
    assert K.kernel_params(tm).branch == (1, 0, 1, closure, momentum, 0,
                                          tracer, 0)


UNSUPPORTED = {
    # walls are covered; the jacobian forcing on the conservative
    # formulation (whose kernel computes the divergence form) is not
    "bounded walls": dict(topology=("periodic", "bounded"),
                          formulation="conservative"),
    "jacobian forcing on conservative": dict(formulation="conservative"),
    "divergence forcing on vector_invariant": dict(forcing=tdivforce()),
    "no Lorentz forcing": dict(forcing=()),
    "background gradient mismatch": dict(A_background_gradient_y=-0.05),
    "a closure of another package": dict(
        closure=swmhd_tpu.LaplacianDiffusion(nu=1e-3)),
    "grid below 8": dict(N=4),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_configurations_raise(case):
    kw = dict(UNSUPPORTED[case])
    tm = torch_model(kw.pop("N", 16), **kw)
    with pytest.raises(ValueError):
        K.kernel_params(tm)
    with pytest.raises(ValueError):
        K.KernelStepper(tm)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vector_invariant periodic"]
                         + sorted(RESIDENT_BRANCHES))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 2e-5)])
def test_kernel_matches_plain_on_card(cuda, case, dtype, tol):
    """The kernel against the plain version at 64² in every branch of
    the default model's options."""
    formulation, topology, gamma = RESIDENT_BRANCHES.get(
        case, ("vector_invariant", ("periodic", "periodic"), 0.0))
    conservative = formulation == "conservative"
    tm = torch_model(64, dtype, cuda, topology=topology,
                     formulation=formulation,
                     forcing=tdivforce(gamma) if conservative
                     else tforce(gamma),
                     A_background_gradient_y=gamma)
    assert_kernel_matches_plain(tm, tol)
    assert K.substage.launches == 1 and K.multistep.launches == 1


def assert_kernel_matches_plain(tm, tol):
    """G of one substage (relative to the largest G) and 10 RK3 steps
    (relative to the largest field) of the 64² model ``tm`` on the card
    against the plain version, over the grid and over the four rows next
    to each wall on their own; the launch counters start from 0."""
    topology = (tm.grid.topology_x, tm.grid.topology_y)
    s = K.stack(tm.initial_state(**ic(torch, walls="bounded" in topology)))
    K.reset_counters()
    _, G = K.substage(tm, s, 0.005, 0)
    _, G_ref = K.substage_reference(tm, s, 0.005, 0)
    x = K.multistep(tm, s, 0.005, 10)
    y = K.multistep_reference(tm, s, 0.005, 10)
    torch.cuda.synchronize()
    rows = [(slice(None),) * 3]
    for axis, topo in ((1, topology[0]), (2, topology[1])):
        if topo == "bounded":
            for edge in (slice(0, 4), slice(60, 64)):
                sl = [slice(None)] * 3
                sl[axis] = edge
                rows.append(tuple(sl))
    for sl in rows:
        assert float((G[sl] - G_ref[sl]).abs().max()) \
            <= tol * float(G_ref.abs().max())
        assert float((x[sl] - y[sl]).abs().max()) <= tol * float(y.abs().max())


# (formulation, topology, options) of the kernel-vs-plain test of the
# new branches on the card
OPTION_CASES = [(f, t, o) for f in ("vector_invariant", "conservative")
                for t in (("periodic", "periodic"), ("bounded", "bounded"))
                for o in OPTIONS
                if f == "vector_invariant" or o != "vorticity stencil"]


@pytest.mark.cuda
@pytest.mark.parametrize("formulation,topology,options", OPTION_CASES,
                         ids=[f"{f}-{t[0]}-{o}" for f, t, o in OPTION_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 2e-5)])
def test_option_kernel_matches_plain_on_card(cuda, formulation, topology,
                                             options, dtype, tol):
    """The kernel against the plain version at 64² in each new branch;
    the closures at ν·dt/dx^p = 0.01."""
    gamma = -0.05 if "bounded" in topology else 0.0
    conservative = formulation == "conservative"
    tm = torch_model(64, dtype, cuda, topology=topology,
                     formulation=formulation,
                     forcing=tdivforce(gamma) if conservative
                     else tforce(gamma), A_background_gradient_y=gamma)
    tm = dataclasses.replace(tm, **option_kwargs(
        options, swmhd_tpu_torch, stable_nu(tm.grid, 0.005, options)))
    assert_kernel_matches_plain(tm, tol)
    assert set(K.substage.launches_by_branch) == {K.kernel_params(tm).branch}


@pytest.mark.cuda
def test_unsupported_configuration_raises_on_card(cuda):
    tm = torch_model(16, device=cuda, **UNSUPPORTED["bounded walls"])
    s = K.stack(tm.initial_state(**ic(torch)))
    with pytest.raises(ValueError):
        K.substage(tm, s, 0.01, 0)
    with pytest.raises(ValueError):
        K.multistep(tm, s, 0.01, 1)
