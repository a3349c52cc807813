"""swmhd_tpu_torch operators and advection == swmhd_tpu's, on the same
random float64 fields (numpy seed) at 32×48 — non-square, so a transposed
index cannot pass — for periodic and bounded topologies.

Tolerance max|Δ| <= 1e-13·max(1, max|ref|): the formulas and their
operation order are the same, so only roundoff separates them. float32
``_normalize_betas`` must be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swmhd_tpu import Grid as JGrid
from swmhd_tpu import advection as jadv
from swmhd_tpu import operators as jop
from swmhd_tpu_torch import Grid as TGrid
from swmhd_tpu_torch import advection as tadv
from swmhd_tpu_torch import operators as top

torch.set_num_threads(1)

NX, NY = 32, 48
TOPOLOGIES = [("periodic", "periodic"), ("bounded", "bounded"),
              ("periodic", "bounded")]


def twin_grids(topology, jdtype=jnp.float64, tdtype=torch.float64):
    ext = ((-5.0, 5.0), (-4.0, 6.0))
    return (JGrid.regular(NX, NY, *ext, topology=topology, dtype=jdtype),
            TGrid.regular(NX, NY, *ext, topology=topology, dtype=tdtype,
                          device="cpu"))


def fields(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((NX, NY)).astype(dtype) for _ in range(n)]


def assert_close(got, want, tol=1e-13, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= tol * max(1.0, np.max(np.abs(want))), (what, err)


UNARY = ["dx_f", "dx_c", "dy_f", "dy_c", "dx_c_flux", "dy_c_flux",
         "ddx_c_flux", "ddy_c_flux", "ddx_f", "ddx_c", "ddy_f", "ddy_c",
         "ix_f", "ix_c", "iy_f", "iy_c", "ixy_fc", "ixy_cf", "ixy_ff",
         "ixy_cc", "laplacian_cc"]
BINARY = ["vorticity_ff", "divergence_cc", "kinetic_energy_cc"]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_operators_match_jax(topology):
    jg, tg = twin_grids(topology)
    a, b = fields(2)
    for name in UNARY:
        assert_close(getattr(top, name)(torch.from_numpy(a), tg),
                     getattr(jop, name)(jnp.asarray(a), jg), what=name)
    for name in BINARY:
        assert_close(getattr(top, name)(torch.from_numpy(a),
                                        torch.from_numpy(b), tg),
                     getattr(jop, name)(jnp.asarray(a), jnp.asarray(b), jg),
                     what=name)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("n", [-3, -2, -1, 1, 2, 3])
def test_shifts_match_jax(topology, n):
    jg, tg = twin_grids(topology)
    (a,) = fields(1, seed=1)
    assert_close(top.shift_x(torch.from_numpy(a), n, tg),
                 jop.shift_x(jnp.asarray(a), n, jg), tol=0.0)
    assert_close(top.shift_y(torch.from_numpy(a), n, tg),
                 jop.shift_y(jnp.asarray(a), n, jg), tol=0.0)


RECON = ["left3_x_f", "right3_x_f", "left3_y_f", "right3_y_f",
         "left3_x_c", "right3_x_c", "left3_y_c", "right3_y_c"]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_reconstructions_match_jax(topology):
    jg, tg = twin_grids(topology)
    (a,) = fields(1, seed=2)
    for name in RECON:
        assert_close(getattr(tadv, name)(torch.from_numpy(a), tg),
                     getattr(jadv, name)(jnp.asarray(a), jg), what=name)
    for name in ("pair_x_f", "pair_y_f", "pair_x_c", "pair_y_c"):
        got = getattr(tadv, "weno5_" + name)(torch.from_numpy(a), tg)
        want = getattr(jadv, "weno5_" + name)(jnp.asarray(a), jg)
        for side, g_, w_ in zip("lr", got, want):
            assert_close(g_, w_, what=f"weno5_{name} {side}")


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("scheme", ["centered2", "upwind3", "weno5"])
def test_scheme_face_pairs_match_jax(topology, scheme):
    jg, tg = twin_grids(topology)
    a, u = fields(2, seed=3)
    ts, js = tadv.get_scheme(scheme), jadv.get_scheme(scheme)
    for axis in ("x", "y"):
        got = getattr(ts, f"both_{axis}_f")(torch.from_numpy(a), tg)
        want = getattr(js, f"both_{axis}_f")(jnp.asarray(a), jg)
        for g_, w_ in zip(got, want):
            assert_close(g_, w_, what=f"{scheme} {axis}")
        assert_close(tadv.upwind_biased_product(torch.from_numpy(u), *got),
                     jadv.upwind_biased_product(jnp.asarray(u), *want),
                     what=f"{scheme} {axis} upwind")


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("scheme", ["centered2", "upwind3", "weno5"])
def test_scheme_center_pairs_match_jax(topology, scheme):
    """Center-from-face reconstructions: the face form shifted by one as
    an array, which near a clamped wall differs from a window offset by
    one."""
    jg, tg = twin_grids(topology)
    a, u = fields(2, seed=7)
    ts, js = tadv.get_scheme(scheme), jadv.get_scheme(scheme)
    for axis in ("x", "y"):
        got = getattr(ts, f"both_{axis}_c")(torch.from_numpy(a), tg)
        want = getattr(js, f"both_{axis}_c")(jnp.asarray(a), jg)
        for g_, w_ in zip(got, want):
            assert_close(g_, w_, what=f"{scheme} {axis}")
        assert_close(tadv.upwind_biased_product(torch.from_numpy(u), *got),
                     jadv.upwind_biased_product(jnp.asarray(u), *want),
                     what=f"{scheme} {axis} upwind")


def test_weno_pieces_match_jax():
    jg, tg = twin_grids(("periodic", "periodic"))
    (a,) = fields(1, seed=4)
    tsh = lambda x, n: top.shift_y(x, n, tg)
    jsh = lambda x, n: jop.shift_y(x, n, jg)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    tb, jb = tadv.weno_betas_left(ta, tsh), jadv.weno_betas_left(ja, jsh)
    for fn in ("weno_candidates_left", "weno_candidates_right"):
        for g_, w_ in zip(getattr(tadv, fn)(ta, tsh),
                          getattr(jadv, fn)(ja, jsh)):
            assert_close(g_, w_, what=fn)
    for g_, w_ in zip(tb, jb):
        assert_close(g_, w_, what="betas")
    for g_, w_ in zip(tadv.shift_betas_left_to_right(tb, tsh),
                      jadv.shift_betas_left_to_right(jb, jsh)):
        assert_close(g_, w_, tol=0.0, what="shifted betas")
    ps = tadv.weno_candidates_left(ta, tsh)
    assert_close(tadv._weno_combine(ps, tb),
                 jadv._weno_combine(jadv.weno_candidates_left(ja, jsh), jb),
                 what="combine")


def _flush_subnormals(x):
    """XLA on the CPU flushes subnormal float32 results to zero; PyTorch
    keeps them. Compare the bits of normal results and zero otherwise."""
    x = np.asarray(x, dtype=np.float32)
    return np.where(np.abs(x) < np.finfo(np.float32).tiny,
                    np.float32(0), x).view(np.int32)


def test_normalize_betas_f32_bit_identical():
    """Including the exponent clamp: sums from 1e-30 (tiny scale) up to
    1e38 (field blown up, clamp at 2^-126 active)."""
    rng = np.random.default_rng(5)
    mags = 10.0 ** rng.uniform(-30, 38.5, size=(3, 4096))
    b = (mags * rng.uniform(0.01, 1, size=mags.shape)).astype(np.float32)
    b[:, :8] = 0.0                                      # constant field
    got_b, got_eps = tadv._normalize_betas(
        tuple(torch.from_numpy(x) for x in b), tadv.WENO_EPS)
    want_b, want_eps = jadv._normalize_betas(
        tuple(jnp.asarray(x) for x in b), jadv._WENO_EPS)
    for g_, w_ in zip(got_b + (got_eps,), want_b + (want_eps,)):
        np.testing.assert_array_equal(_flush_subnormals(g_.numpy()),
                                      _flush_subnormals(w_))
    clamped = b.astype(np.float64).sum(axis=0) >= 2.0 ** 127
    assert clamped.any() and (~clamped).any()


@pytest.mark.parametrize("value", [1.0, -0.37, 1e-3, 250.0])
def test_weno_f32_constant_field_exact(value):
    """betas are 0: without the f32 normalisation the weights are 0/0."""
    _, tg = twin_grids(("periodic", "periodic"), tdtype=torch.float32)
    c = torch.full((NX, NY), value, dtype=torch.float32)
    for recon in (tadv.weno5_pair_x_f(c, tg) + tadv.weno5_pair_y_f(c, tg)
                  + tadv.weno5_pair_x_c(c, tg) + tadv.weno5_pair_y_c(c, tg)):
        assert torch.isfinite(recon).all()
        ulp = np.spacing(np.float32(abs(value)))
        assert np.max(np.abs(recon.numpy() - np.float32(value))) <= ulp


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_weno_f32_random_matches_jax(topology):
    jg, tg = twin_grids(topology, jnp.float32, torch.float32)
    (a,) = fields(1, seed=6, dtype=np.float32)
    for name in ("weno5_pair_x_f", "weno5_pair_y_f"):
        got = getattr(tadv, name)(torch.from_numpy(a), tg)
        want = getattr(jadv, name)(jnp.asarray(a), jg)
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                       rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.float64, torch.float64)])
def test_grid_coordinates_match_jax(jdtype, tdtype):
    """Same operation order in the grid dtype: identical coordinates."""
    jg, tg = twin_grids(("periodic", "bounded"), jdtype, tdtype)
    for name in ("xf", "xc", "yf", "yc"):
        np.testing.assert_array_equal(getattr(tg, name)().numpy(),
                                      np.asarray(getattr(jg, name)()))
    for loc in ("cc", "fc", "cf", "ff"):
        for t, j in zip(tg.nodes(loc), jg.nodes(loc)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (tg.dx, tg.dy, tg.shape) == (jg.dx, jg.dy, jg.shape)
    assert (tg.Ax, tg.Ay, tg.Az) == (jg.Ax, jg.Ay, jg.Az)
