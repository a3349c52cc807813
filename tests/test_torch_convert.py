"""State and checkpoints across the two packages: ``convert`` round-trips
a JAX state, and a checkpoint written by either package restores in the
other with the same arrays (bit for bit) and clock."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swmhd_tpu import checkpoint as jckpt
from swmhd_tpu import scenarios as jscen
from swmhd_tpu.models.state import Clock as JClock
from swmhd_tpu_torch import checkpoint as tckpt
from swmhd_tpu_torch import scenarios as tscen
from swmhd_tpu_torch.convert import (grid_from_meta, state_from_numpy,
                                     state_to_numpy)
from swmhd_tpu_torch.models.state import Clock

torch.set_num_threads(1)

FIELDS = ("h", "u", "v", "A")
SCENARIO = "64x64_low_B_low_U"


def jax_state(dtype=jnp.float64):
    model, state, _ = jscen.build(SCENARIO, dtype=dtype)
    rng = np.random.default_rng(0)
    state = state.replace(
        h=state.h + 0.01 * jnp.asarray(rng.standard_normal(state.h.shape),
                                       dtype),
        clock=JClock(time=jnp.asarray(1.23, jnp.float64),
                     iteration=jnp.asarray(123, jnp.int32)))
    return model, state


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float64, torch.float64),
                                           (jnp.float32, torch.float32)])
def test_state_round_trip(jdtype, tdtype):
    _, js = jax_state(jdtype)
    arrays = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    arrays["time"] = np.asarray(js.clock.time)
    arrays["iteration"] = np.asarray(js.clock.iteration)
    ts = state_from_numpy(arrays, device="cpu", dtype=tdtype)
    assert ts.h.dtype == tdtype and ts.clock == Clock(1.23, 123)
    back = state_to_numpy(ts)
    for k in FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    assert back["time"] == 1.23 and back["iteration"] == 123


def test_jax_checkpoint_restores_in_port(tmp_path):
    jm, js = jax_state()
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, js, jm.grid)
    grid = tckpt.grid_from_checkpoint(path, device="cpu")
    assert grid.meta() == {k: getattr(jm.grid, k) for k in grid.meta()}
    ts = tckpt.restore(path, grid)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)))
    assert ts.clock == Clock(1.23, 123)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tm, ts, _ = tscen.build(SCENARIO, dtype=torch.float64, device="cpu")
    ts = ts.replace(clock=Clock(4.56, 456))
    path = str(tmp_path / "port.npz")
    tckpt.save(path, ts, tm.grid)
    jm, _ = jax_state()
    js = jckpt.restore(path, jm.grid)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, k)),
                                      getattr(ts, k).numpy())
    assert float(js.clock.time) == 4.56
    assert int(js.clock.iteration) == 456
    assert jckpt.grid_from_checkpoint(path) == jm.grid


def test_grid_from_meta_and_size_check(tmp_path):
    tm, ts, _ = tscen.build(SCENARIO, dtype=torch.float32, device="cpu")
    assert grid_from_meta(tm.grid.meta(), device="cpu") == tm.grid
    path = str(tmp_path / "c.npz")
    tckpt.save(path, ts, tm.grid)
    other, _, _ = tscen.build("128x128_low_B_low_U", device="cpu")
    with pytest.raises(ValueError, match="checkpoint grid"):
        tckpt.restore(path, other.grid)


@pytest.mark.parametrize("entry", ["Grid.regular", "scenarios.build",
                                   "state_from_numpy", "grid_from_meta",
                                   "grid_from_checkpoint"])
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, entry):
    """Without ``device=`` the library's entry points put everything on
    the card, and without a card they raise instead of moving to the
    CPU."""
    from swmhd_tpu_torch import Grid
    tm, ts, _ = tscen.build(SCENARIO, device="cpu")
    path = str(tmp_path / "c.npz")
    tckpt.save(path, ts, tm.grid)
    calls = {
        "Grid.regular": lambda: Grid.regular(8, 8, (0, 1), (0, 1)),
        "scenarios.build": lambda: tscen.build(SCENARIO),
        "state_from_numpy": lambda: state_from_numpy(
            {k: np.zeros((8, 8)) for k in FIELDS}),
        "grid_from_meta": lambda: grid_from_meta(tm.grid.meta()),
        "grid_from_checkpoint": lambda: tckpt.grid_from_checkpoint(path),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
