"""swmhd_tpu_torch Coriolis, both Lorentz forces and their forcing hooks,
the staggered Laplacians and both diffusion closures == swmhd_tpu's on
the same random float64 fields at 32×48, for periodic and bounded axes.

Tolerance max|Δ| <= 1e-13·max(1, max|ref|), 1e-12 for the Laplacians
and closures: same formulas, same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swmhd_tpu import Grid as JGrid
from swmhd_tpu import physics as jphys
from swmhd_tpu import forcing as jforcing
from swmhd_tpu.physics import diffusion as jdiff
from swmhd_tpu_torch import Grid as TGrid
from swmhd_tpu_torch import physics as tphys
from swmhd_tpu_torch import forcing as tforcing
from swmhd_tpu_torch.physics import diffusion as tdiff

torch.set_num_threads(1)

NX, NY = 32, 48
TOPOLOGIES = [("periodic", "periodic"), ("periodic", "bounded"),
              ("bounded", "bounded")]


def twin_grids(topology):
    ext = ((-5.0, 5.0), (-4.0, 6.0))
    return (JGrid.regular(NX, NY, *ext, topology=topology,
                          dtype=jnp.float64),
            TGrid.regular(NX, NY, *ext, topology=topology,
                          dtype=torch.float64, device="cpu"))


def inputs(seed=0):
    """A, u, v random; h = 1 + a positive perturbation."""
    rng = np.random.default_rng(seed)
    A, u, v = (rng.standard_normal((NX, NY)) for _ in range(3))
    h = 1.0 + 0.3 * rng.uniform(size=(NX, NY))
    return {"A": A, "u": u, "v": v, "h": h}


def assert_close(got, want, tol=1e-13, what=""):
    got = got.numpy()
    want = np.asarray(want)
    err = np.max(np.abs(got - want))
    assert err <= tol * max(1.0, np.max(np.abs(want))), (what, err)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_coriolis_matches_jax(topology):
    jg, tg = twin_grids(topology)
    f = inputs(1)
    jc, tc = jphys.FPlane(1.3), tphys.FPlane(1.3)
    assert_close(tc.tendency_u(torch.from_numpy(f["v"]), tg),
                 jc.tendency_u(jnp.asarray(f["v"]), jg), what="u")
    assert_close(tc.tendency_v(torch.from_numpy(f["u"]), tg),
                 jc.tendency_v(jnp.asarray(f["u"]), jg), what="v")


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("gamma", [0.0, -0.05])
def test_lorentz_jacobian_matches_jax(topology, gamma):
    jg, tg = twin_grids(topology)
    f = inputs(2)
    tA, th = torch.from_numpy(f["A"]), torch.from_numpy(f["h"])
    jA, jh = jnp.asarray(f["A"]), jnp.asarray(f["h"])
    for g_, w_ in zip(tphys.magnetic_field_cc(tA, th, tg, gamma),
                      jphys.magnetic_field_cc(jA, jh, jg, gamma)):
        assert_close(g_, w_, what="B")
    for g_, w_ in zip(tphys.lorentz_force_jacobian(tA, th, tg, gamma),
                      jphys.lorentz_force_jacobian(jA, jh, jg, gamma)):
        assert_close(g_, w_, what="force")


@pytest.mark.parametrize("gamma", [0.0, -0.05])
def test_jacobian_forcing_hook_matches_jax(gamma):
    jg, tg = twin_grids(("periodic", "periodic"))
    f = inputs(3)
    ((tkey, tfn),) = tforcing.jacobian_lorentz_forcing(gamma).items()
    ((jkey, jfn),) = jforcing.jacobian_lorentz_forcing(gamma).items()
    assert tkey == jkey == ("u", "v")
    tf = {k: torch.from_numpy(v) for k, v in f.items()}
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    for g_, w_ in zip(tfn(tg, None, tf), jfn(jg, None, jf)):
        assert_close(g_, w_)
    assert tfn.jacobian_lorentz_A_bg_grad_y == gamma


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("gamma", [0.0, -0.05])
def test_lorentz_divergence_matches_jax(topology, gamma):
    """Face B, its numerators and ∇·(hB⊗B): UpwindBiased3 reconstructions
    (degraded at walls), face areas, plain clamped differences."""
    jg, tg = twin_grids(topology)
    f = inputs(4)
    tA, th = torch.from_numpy(f["A"]), torch.from_numpy(f["h"])
    jA, jh = jnp.asarray(f["A"]), jnp.asarray(f["h"])
    for g_, w_ in zip(tphys.magnetic_field_faces(tA, th, tg, gamma),
                      jphys.magnetic_field_faces(jA, jh, jg, gamma)):
        assert_close(g_, w_, what="B faces")
    for g_, w_ in zip(tphys.lorentz_force_divergence(tA, th, tg, gamma),
                      jphys.lorentz_force_divergence(jA, jh, jg, gamma)):
        assert_close(g_, w_, what="force")


@pytest.mark.parametrize("gamma", [0.0, -0.05])
def test_divergence_forcing_hook_matches_jax(gamma):
    jg, tg = twin_grids(("periodic", "bounded"))
    f = inputs(5)
    ((tkey, tfn),) = tforcing.divergence_lorentz_forcing(gamma).items()
    ((jkey, jfn),) = jforcing.divergence_lorentz_forcing(gamma).items()
    assert tkey == jkey == ("uh", "vh")
    tf = {k: torch.from_numpy(v) for k, v in f.items()}
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    for g_, w_ in zip(tfn(tg, None, tf), jfn(jg, None, jf)):
        assert_close(g_, w_)
    assert tfn.divergence_lorentz_A_bg_grad_y == gamma
    assert not hasattr(tfn, "jacobian_lorentz_A_bg_grad_y")


# -- diffusion closures ------------------------------------------------------------


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("name", ["laplacian_u", "laplacian_v",
                                  "laplacian_c"])
def test_laplacians_match_jax(topology, name):
    jg, tg = twin_grids(topology)
    a = inputs(6)["u"]
    assert_close(getattr(tdiff, name)(torch.from_numpy(a), tg),
                 getattr(jdiff, name)(jnp.asarray(a), jg), tol=1e-12,
                 what=name)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("kind", ["LaplacianDiffusion",
                                  "BiharmonicDiffusion"])
def test_closures_match_jax(topology, kind):
    """ν and κ of each closure on u, v and the tracer; its halo."""
    jg, tg = twin_grids(topology)
    f = inputs(7)
    jc = getattr(jdiff, kind)(nu=2e-3, kappa=3e-3)
    tc = getattr(tdiff, kind)(nu=2e-3, kappa=3e-3)
    assert tc.halo == jc.halo == (1 if kind == "LaplacianDiffusion" else 2)
    for method, key in (("tendency_u", "u"), ("tendency_v", "v"),
                        ("tendency_c", "A")):
        got = getattr(tc, method)(torch.from_numpy(f[key]), tg)
        want = getattr(jc, method)(jnp.asarray(f[key]), jg)
        assert_close(got, want, tol=1e-12, what=method)
        assert float(got.abs().max()) > 1e-3, method
