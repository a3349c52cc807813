"""The port's main path end to end on the CPU: ``swmhd_tpu_torch.cli run``
writes the energy series and a ``final.npz`` that the JAX package restores
and evaluates to the same energies, and with a closure the same files as
the JAX package's CLI; the port never imports JAX; and the stepper
selection never moves a CUDA run to the CPU.
"""

import argparse
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swmhd_tpu import checkpoint as jckpt
from swmhd_tpu import diagnostics as jdiag
from swmhd_tpu import scenarios as jscen
from swmhd_tpu.io.readers import FieldTimeSeries
from swmhd_tpu_torch import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO = "64x64_two_Gaussians_high_B"
ENERGIES = ("kinetic_energy", "magnetic_energy", "potential_energy",
            "total_energy", "cross_helicity")


def run(outdir, *extra, scenario=SCENARIO):
    cli.main(["run", scenario, "--device", "cpu", "--dtype", "float64",
              "--outdir", str(outdir), *extra])


def read_csv(path):
    with open(path) as f:
        header = f.readline().strip().split(",")
    return header, np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def test_cli_run_energies_match_jax_on_restored_final(tmp_path):
    run(tmp_path, "--stop-time", "0.2")
    header, rows = read_csv(tmp_path / "energies.csv")
    assert header == ["time", "iteration"] + sorted(ENERGIES)
    assert rows.shape[0] == 21
    np.testing.assert_allclose(rows[:, 1], np.arange(21))
    np.testing.assert_allclose(rows[:, 0], 0.01 * np.arange(21), atol=1e-12)
    assert np.isfinite(rows).all()

    snaps = FieldTimeSeries(str(tmp_path / "fields"), "A")
    np.testing.assert_allclose(snaps.times, [0.0, 0.1, 0.2], atol=1e-12)
    assert snaps[-1].shape == (64, 64)

    model, state0, _ = jscen.build(SCENARIO, dtype=jnp.float64)
    final = jckpt.restore(str(tmp_path / "final.npz"), model.grid)
    np.testing.assert_array_equal(snaps[-1], np.asarray(final.A))
    assert int(final.clock.iteration) == 20
    assert float(final.clock.time) == pytest.approx(0.2, abs=1e-12)
    rep = jdiag.energy_report(model, final, state0.h)
    for col, name in enumerate(sorted(ENERGIES), start=2):
        want = float(rep[name])
        assert rows[-1, col] == pytest.approx(want, rel=1e-10, abs=1e-14), \
            name


@pytest.mark.parametrize("scenario", ["64x64_low_B_low_U",
                                      "64x64_two_Gaussians_high_B"])
def test_cli_conservative_run_energies_match_jax(tmp_path, scenario):
    """The conservative formulation end to end: the series is in physical
    velocities, and the JAX package's conservative model evaluates the
    restored final state (transports in u, v) to the same energies."""
    run(tmp_path, "--stop-time", "0.1", "--formulation", "conservative",
        scenario=scenario)
    _, rows = read_csv(tmp_path / "energies.csv")
    assert rows.shape[0] == 11 and np.isfinite(rows).all()
    model, state0, _ = jscen.build(scenario, "conservative",
                                   dtype=jnp.float64)
    final = jckpt.restore(str(tmp_path / "final.npz"), model.grid)
    assert int(final.clock.iteration) == 10
    rep = jdiag.energy_report(model, final, state0.h)
    for col, name in enumerate(sorted(ENERGIES), start=2):
        assert rows[-1, col] == pytest.approx(float(rep[name]), rel=1e-10,
                                              abs=1e-14), name
    u, _ = model.velocities(final)
    snaps = FieldTimeSeries(str(tmp_path / "fields"), "u")
    np.testing.assert_allclose(snaps[-1], np.asarray(u), rtol=1e-12,
                               atol=1e-15)


def test_cli_closure_run_matches_jax_cli(tmp_path, monkeypatch):
    """``--nu --kappa --biharmonic``: the port's CLI run and the JAX
    package's CLI run with the same flags write the same final.npz and
    energies.csv (within 1e-10)."""
    from swmhd_tpu import cli as jcli
    flags = ["--stop-time", "0.05", "--nu", "1e-4", "--kappa", "1e-4",
             "--biharmonic"]
    run(tmp_path / "port", *flags)
    monkeypatch.setenv("SWMHD_COMPILE_CACHE", "")   # no cache under HOME
    jcli.main(["run", SCENARIO, "--dtype", "float64", "--outdir",
               str(tmp_path / "jax"), *flags])
    header, rows = read_csv(tmp_path / "port" / "energies.csv")
    jheader, jrows = read_csv(tmp_path / "jax" / "energies.csv")
    assert header == jheader and rows.shape == jrows.shape == (6, 7)
    np.testing.assert_allclose(rows, jrows, rtol=1e-10, atol=1e-14)
    with np.load(tmp_path / "port" / "final.npz") as x, \
            np.load(tmp_path / "jax" / "final.npz") as y:
        for k in ("h", "u", "v", "A"):
            np.testing.assert_allclose(x[k], y[k], rtol=1e-10, atol=1e-12,
                                       err_msg=k)
        assert int(x["iteration"]) == int(y["iteration"]) == 5


@pytest.mark.parametrize("flags,want", [
    ([], None),
    (["--biharmonic"], None),
    (["--nu", "1e-3"], ("LaplacianDiffusion", 1e-3, 0.0)),
    (["--kappa", "2e-3", "--biharmonic"], ("BiharmonicDiffusion", 0.0,
                                          2e-3))])
def test_closure_flags(flags, want):
    """A closure only where --nu or --kappa is nonzero, biharmonic with
    --biharmonic (the JAX CLI's rule)."""
    p = argparse.ArgumentParser()
    cli._add_run_args(p)
    c = cli.closure_of(p.parse_args([SCENARIO, *flags]))
    assert (c if c is None else (type(c).__name__, c.nu, c.kappa)) == want


def test_cli_resume_continues_the_series(tmp_path):
    run(tmp_path / "a", "--stop-time", "0.1", "--checkpoint-every", "5")
    run(tmp_path / "b", "--stop-time", "0.15", "--resume",
        str(tmp_path / "a" / "checkpoint.npz"))
    _, rows = read_csv(tmp_path / "b" / "energies.csv")
    np.testing.assert_allclose(rows[:, 1], np.arange(10, 16))


def test_cli_list(capsys):
    cli.main(["list"])
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 8
    assert SCENARIO in out


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", SCENARIO, "--stop-time", "0.01",
                  "--outdir", str(tmp_path)])


def test_select_stepper_on_cpu_is_plain():
    from swmhd_tpu_torch import scenarios
    model, _, _ = scenarios.build(SCENARIO, device="cpu")
    assert cli.select_stepper(model, fused=True) == (None, "plain")
    assert cli.select_stepper(model, fused=False) == (None, "plain")


def test_port_never_imports_jax():
    """Every module of swmhd_tpu_torch, found by pkgutil.walk_packages,
    imports without jax or swmhd_tpu."""
    code = ("import importlib, pkgutil, sys, swmhd_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages("
            "swmhd_tpu_torch.__path__, 'swmhd_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "missing = {'swmhd_tpu_torch.bench', 'swmhd_tpu_torch.scaling', "
            "'swmhd_tpu_torch.validate', 'swmhd_tpu_torch.ops.vi_tile', "
            "'swmhd_tpu_torch.probes.exp_fused2d'} - set(names); "
            "bad = [m for m in sys.modules if m in ('jax', 'swmhd_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'swmhd_tpu.'))]; "
            "print(len(names), sorted(missing), bad); "
            "sys.exit(1 if bad or missing else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
