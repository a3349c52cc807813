"""The CUDA substage module (swmhd_tpu_torch.ops.substage).

On the CPU: the plain versions against the JAX Pallas kernels they port,
run as tests/test_fused.py runs them (interpret mode), at 32² float64 to
1e-12 of each field's scale — ``multistep_reference`` against
``resident_step_fn`` and chained ``substage_reference`` calls against
``fused_step_fn``; the wrappers' CPU dispatch (plain version, no launch);
and the configurations the kernel rejects.

Tests marked ``cuda`` run the kernel itself and skip without a card:
``python -m pytest tests/test_torch_substage.py -m cuda`` on the GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swmhd_tpu import (Grid as JGrid, ShallowWaterModel as JModel,
                       FPlane as JFPlane, jacobian_lorentz_forcing as jforce)
from swmhd_tpu.ops.fused_step import fused_step_fn, resident_step_fn
from swmhd_tpu_torch import (Grid as TGrid, ShallowWaterModel as TModel,
                             FPlane as TFPlane,
                             jacobian_lorentz_forcing as tforce)
from swmhd_tpu_torch.convert import state_from_numpy
from swmhd_tpu_torch.ops import substage as K

torch.set_num_threads(1)

L = 10.0
FIELDS = ("h", "u", "v", "A")


def ic(xp):
    e = lambda x, y: xp.exp(-(x ** 2 + y ** 2))
    return dict(
        u=lambda x, y: 5 * y * e(x, y), v=lambda x, y: -5 * x * e(x, y),
        h=lambda x, y: 1.0 + 0.05 * e(x, y),
        A=lambda x, y: 0.5 * xp.exp(-((x - 0.5) ** 2 + y ** 2))
        - 0.5 * xp.exp(-((x + 0.5) ** 2 + y ** 2)))


def torch_model(N=32, dtype=torch.float64, device="cpu", topology=None,
                **kw):
    g = TGrid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                      topology=topology or ("periodic", "periodic"),
                      dtype=dtype, device=device)
    kw.setdefault("forcing", tforce())
    return TModel(grid=g, coriolis=TFPlane(1.0), **kw)


def jax_pair(N=32):
    g = JGrid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                      dtype=jnp.float64)
    jm = JModel(grid=g, coriolis=JFPlane(1.0), forcing=jforce())
    js = jm.initial_state(**ic(jnp))
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                          dtype=torch.float64)
    return jm, js, torch_model(N), ts


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


@pytest.mark.parametrize("diagnostics", [False, True])
def test_kernel_stepper_matches_model_step(diagnostics):
    """The stepper's two chunk paths (multistep; substages per step with
    a series) give the model's own RK3 step on the CPU."""
    tm = torch_model(16)
    st = tm.initial_state(**ic(torch))
    diag = (lambda s: {"mass": s.h.sum()}) if diagnostics else None
    got = K.KernelStepper(tm).step_fn(0.01, 3, diag)(st)
    want = tm.step_fn(0.01, 3, diag)(st)
    if diagnostics:
        (got, gs), (want, ws) = got, want
        assert torch.allclose(gs["mass"], ws["mass"], rtol=1e-14)
    for a, b in zip(got.fields(), want.fields()):
        assert torch.allclose(a, b, rtol=1e-13, atol=1e-13)
    assert got.clock == want.clock


UNSUPPORTED = {
    "bounded walls": dict(topology=("periodic", "bounded")),
    "no Lorentz forcing": dict(forcing=()),
    "background gradient mismatch": dict(A_background_gradient_y=-0.05),
    "upwind3 mass advection": dict(mass_advection="upwind3"),
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
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 2e-5)])
def test_kernel_matches_plain_on_card(cuda, dtype, tol):
    """G of one substage (relative to the largest G) and 10 RK3 steps
    (relative to the largest field) at 64² on the card."""
    tm = torch_model(64, dtype, cuda)
    s = K.stack(tm.initial_state(**ic(torch)))
    K.reset_counters()
    _, G = K.substage(tm, s, 0.005, 0)
    _, G_ref = K.substage_reference(tm, s, 0.005, 0)
    assert float((G - G_ref).abs().max()) <= tol * float(G_ref.abs().max())
    x = K.multistep(tm, s, 0.005, 10)
    y = K.multistep_reference(tm, s, 0.005, 10)
    torch.cuda.synchronize()
    assert float((x - y).abs().max()) <= tol * float(y.abs().max())
    assert K.substage.launches == 1 and K.multistep.launches == 1


@pytest.mark.cuda
def test_unsupported_configuration_raises_on_card(cuda):
    tm = torch_model(16, device=cuda, topology=("periodic", "bounded"))
    s = K.stack(tm.initial_state(**ic(torch)))
    with pytest.raises(ValueError):
        K.substage(tm, s, 0.01, 0)
    with pytest.raises(ValueError):
        K.multistep(tm, s, 0.01, 1)
