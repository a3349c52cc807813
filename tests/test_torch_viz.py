"""swmhd_tpu_torch.viz, ``cli run --movie`` and ``io.ScalarWriter`` on the
CPU: the four cases of tests/test_viz.py on a port run, the energy figure
and the movie frames of the same files pixel for pixel through both
packages, the CLI's movie in one process and over two gloo ranks (one
render, on rank 0), and the ScalarWriter round trip of
tests/test_simulation.py against the JAX ScalarWriter's rows.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swmhd_tpu
import swmhd_tpu_torch
from swmhd_tpu import viz as jviz
from swmhd_tpu.io import ScalarWriter as JScalarWriter
from swmhd_tpu_torch import cli, diagnostics, scenarios, viz
from swmhd_tpu_torch.io import (FieldWriter, ScalarSeriesWriter,
                                ScalarTimeSeries, ScalarWriter)
from swmhd_tpu_torch.simulation import (IterationInterval, Simulation,
                                        TimeInterval)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO = "64x64_two_Gaussians_high_B"


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    """tests/test_viz.py's 20-step run with both writers, on the port."""
    outdir = str(tmp_path_factory.mktemp("run"))
    model, state, sc = scenarios.build(SCENARIO, dtype=torch.float64,
                                       device="cpu")
    h0 = state.h
    sim = Simulation(model, dt=0.01, stop_iteration=20)
    sim.output_writers["fields"] = FieldWriter(
        outputs={"A": lambda s: s.state.A,
                 "s": lambda s: torch.sqrt(s.state.u ** 2)},
        schedule=TimeInterval(0.05),
        path=os.path.join(outdir, "fields"))
    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=lambda m, s: {k: v for k, v in
                         diagnostics.energy_report(m, s, h0).items()
                         if k in ("kinetic_energy", "magnetic_energy",
                                  "potential_energy", "total_energy")},
        schedule=IterationInterval(1),
        path=os.path.join(outdir, "energies.csv"))
    sim.run(state)
    return outdir, model, state


def test_render_energy_plot(short_run, tmp_path):
    outdir, _, _ = short_run
    png = viz.render_energy_plot(os.path.join(outdir, "energies.csv"),
                                 str(tmp_path / "energy.png"),
                                 title="smoke")
    assert os.path.getsize(png) > 10_000


def test_render_movie_frames(short_run, tmp_path):
    outdir, _, _ = short_run
    out = viz.render_movie(os.path.join(outdir, "fields"),
                           str(tmp_path / "movie.mp4"))
    if os.path.isdir(out):
        frames = os.listdir(out)
        assert len(frames) >= 2
        assert all(f.endswith(".png") for f in frames)
    else:
        assert os.path.getsize(out) > 10_000


def test_render_field_verification(short_run, tmp_path):
    _, model, state = short_run
    paths = viz.render_field_verification(
        model.grid, state.A, state.h, str(tmp_path / "verify"))
    assert len(paths) == 2
    for p in paths:
        assert os.path.getsize(p) > 10_000


def test_render_scenario_outputs(short_run):
    outdir, _, _ = short_run
    made = viz.render_scenario_outputs(outdir, title="smoke")
    assert len(made) == 2
    assert os.path.exists(os.path.join(outdir, "energy_plot.png"))


def pixels(path):
    import matplotlib.image
    return matplotlib.image.imread(path)


def test_energy_plot_pixels_equal_jax(short_run, tmp_path):
    csv = os.path.join(short_run[0], "energies.csv")
    got = viz.render_energy_plot(csv, str(tmp_path / "port.png"), "same")
    want = jviz.render_energy_plot(csv, str(tmp_path / "jax.png"), "same")
    np.testing.assert_array_equal(pixels(got), pixels(want))


def test_movie_frames_equal_jax(short_run, tmp_path, monkeypatch):
    """The frames of one fields/ directory through both packages, kept as
    .png (no encoder found: no ffmpeg on the path, cv2 not importable)."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setitem(sys.modules, "cv2", None)
    fields = os.path.join(short_run[0], "fields")
    got = viz.render_movie(fields, str(tmp_path / "port.mp4"))
    want = jviz.render_movie(fields, str(tmp_path / "jax.mp4"))
    assert os.path.isdir(got) and os.path.isdir(want)
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got)) and len(names) == 5
    for n in names:
        np.testing.assert_array_equal(pixels(os.path.join(got, n)),
                                      pixels(os.path.join(want, n)), n)


def assert_movie(outdir):
    movie = os.path.join(outdir, "movie.mp4")
    frames = movie + ".frames"
    assert os.path.getsize(os.path.join(outdir, "energy_plot.png")) > 10_000
    assert (os.path.isfile(movie) and os.path.getsize(movie) > 1000) or \
        (os.path.isdir(frames) and os.listdir(frames))


def test_cli_movie(tmp_path, capsys):
    cli.main(["run", SCENARIO, "--device", "cpu", "--stop-time", "0.05",
              "--outdir", str(tmp_path), "--movie"])
    assert_movie(str(tmp_path))
    assert capsys.readouterr().out.count("rendered:") == 1


def test_cli_movie_without_matplotlib_raises_before_the_run(tmp_path,
                                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        cli.main(["run", SCENARIO, "--device", "cpu", "--stop-time", "0.05",
                  "--outdir", str(tmp_path), "--movie"])
    assert not os.path.exists(tmp_path / "energies.csv")


def test_decomposed_cli_movie_renders_once(tmp_path):
    """Two gloo ranks: rank 0 renders the movie of the slab fields/
    directory, once, after both ranks have closed their writers."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=port)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "swmhd_tpu_torch.cli", "run", SCENARIO,
         "--device", "cpu", "--stop-time", "0.05", "--fields-interval",
         "0.02", "--outdir", str(tmp_path), "--movie"], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "decomposed over a 1x2 mesh" in "".join(outs)
    assert [out.count("rendered:") for out in outs] == [1, 0]
    assert os.path.exists(tmp_path / "fields" / "A" / "000000.p00001.npz")
    assert_movie(str(tmp_path))


def small_model(pkg):
    """tests/test_simulation.py's model and state in ``pkg``."""
    L = 10.0
    kw = ({"dtype": jnp.float64} if pkg is swmhd_tpu
          else {"dtype": torch.float64, "device": "cpu"})
    xp = jnp if pkg is swmhd_tpu else torch
    g = pkg.Grid.regular(32, 32, (-L / 2, L / 2), (-L / 2, L / 2), **kw)
    model = pkg.ShallowWaterModel(
        grid=g, formulation=pkg.VECTOR_INVARIANT,
        momentum_advection=pkg.Centered2, mass_advection=pkg.Centered2,
        tracer_advection=pkg.Centered2, coriolis=pkg.FPlane(1.0))
    return model, model.initial_state(
        u=lambda x, y: 0.1 * xp.sin(2 * np.pi * y / L),
        h=1.0, A=lambda x, y: 0.1 * xp.exp(-(x ** 2 + y ** 2)))


def test_scalar_writer_roundtrip_matches_jax(tmp_path):
    """tests/test_simulation.py's ScalarWriter round trip through both
    packages: the same rows (time and iteration exact, energies within
    1e-10)."""
    rows = {}
    for pkg, writer in ((swmhd_tpu, JScalarWriter),
                        (swmhd_tpu_torch, ScalarWriter)):
        model, state = small_model(pkg)
        sim = pkg.Simulation(model, dt=0.01, stop_time=0.05)
        h0 = jnp.ones((32, 32), jnp.float64) if pkg is swmhd_tpu \
            else torch.ones((32, 32), dtype=torch.float64)
        path = str(tmp_path / f"{pkg.__name__}.csv")
        sim.output_writers["energies"] = writer(
            outputs={"total_energy": lambda s: pkg.diagnostics.energy_report(
                s.model, s.state, h0)["total_energy"],
                "max_h": lambda s: s.state.h.max()},
            schedule=pkg.IterationInterval(1), path=path)
        sim.run(state)
        ts = ScalarTimeSeries(path)
        assert len(ts.time) == 6
        assert np.all(np.isfinite(ts.total_energy))
        assert abs(ts.total_energy[-1] - ts.total_energy[0]) \
            < 0.01 * abs(ts.total_energy[0]) + 1e-12
        with open(path) as f:
            header = f.readline()
        rows[pkg] = (header, ts)
    (jh, jts), (th, tts) = rows[swmhd_tpu], rows[swmhd_tpu_torch]
    assert th == jh
    np.testing.assert_array_equal(tts.iteration, jts.iteration)
    np.testing.assert_array_equal(tts.time, jts.time)
    for name in ("total_energy", "max_h"):
        np.testing.assert_allclose(tts[name], jts[name], rtol=1e-10,
                                   atol=1e-14, err_msg=name)
