"""Plots and movies after a run, port of :mod:`swmhd_tpu.viz`: the
four-panel energy figure (kinetic, magnetic, potential energy and the
total-energy deviation), the two-panel (A, speed) movie and the
field-verification figures (A contours with the magnetic field or the
jacobian-form Lorentz force as arrows).

matplotlib (Agg backend) is imported when a figure is drawn, so the
package imports without it. The movie is an .mp4 through ffmpeg where it
is installed, else through OpenCV's mp4 writer, else a directory of .png
frames.
"""

from __future__ import annotations

import os

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def render_energy_plot(energies_csv: str, out_png: str, title: str = ""):
    from .io.readers import ScalarTimeSeries
    plt = _mpl()
    ts = ScalarTimeSeries(energies_csv)
    t = ts.time
    dev = np.abs(ts.total_energy - ts.total_energy[0]) * 100.0

    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    panels = [
        ("kinetic energy", ts.kinetic_energy, "red"),
        ("magnetic energy", ts.magnetic_energy, "blue"),
        ("potential energy", ts.potential_energy, "green"),
        ("total energy deviation (abs × 100)", dev, "black"),
    ]
    for ax, (name, series, color) in zip(axes.flat, panels):
        ax.plot(t, series, color=color, linewidth=2)
        ax.set_title(name)
        ax.set_xlabel("t")
    if title:
        fig.suptitle(f"{title}: Energy Plots")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def render_movie(fields_dir: str, out_path: str, names=("A", "s"),
                 titles=("Magnetic potential", "Speed"), fps: int = 24,
                 autoscale: bool = False, figsize=None, cmap="viridis"):
    """One frame a snapshot of ``fields_dir`` (a FieldWriter store, per-rank
    slabs included), one panel a field of ``names``; returns the movie's
    path, or the frames' directory when no encoder is found."""
    from .io.readers import FieldTimeSeries
    plt = _mpl()
    series = [FieldTimeSeries(fields_dir, n) for n in names]
    times = series[0].times
    gm = series[0].grid_meta or {}
    extent = None
    if gm:
        extent = (gm["x0"], gm["x0"] + gm["Lx"], gm["y0"], gm["y0"] + gm["Ly"])

    vmins = [min(float(s[i].min()) for i in range(len(s))) for s in series]
    vmaxs = [max(float(s[i].max()) for i in range(len(s))) for s in series]

    if figsize is None:
        figsize = (6 * len(series), 5)
    frames_dir = out_path + ".frames"
    os.makedirs(frames_dir, exist_ok=True)
    for i in range(len(times)):
        fig, axes = plt.subplots(1, len(series), figsize=figsize)
        if len(series) == 1:
            axes = [axes]
        for ax, s, ttl, vmin, vmax in zip(axes, series, titles, vmins, vmaxs):
            frame = np.asarray(s[i])
            if autoscale:  # the reference's movies recolour each frame
                vmin, vmax = float(frame.min()), float(frame.max())
                if vmax <= vmin:
                    vmax = vmin + 1e-12
            im = ax.imshow(frame.T, origin="lower",
                           extent=extent, cmap=cmap,
                           vmin=vmin, vmax=vmax)
            ax.set_title(f"{ttl} at time = {times[i]:.1f}")
            ax.set_xlabel("x")
            ax.set_ylabel("y")
            fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(os.path.join(frames_dir, f"{i:05d}.png"), dpi=100)
        plt.close(fig)

    # encode: ffmpeg if present, else OpenCV's mp4 writer, else keep frames
    import shutil
    import subprocess
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
             "-i", os.path.join(frames_dir, "%05d.png"),
             "-pix_fmt", "yuv420p", out_path],
            check=True)
        shutil.rmtree(frames_dir)
        return out_path
    try:
        import cv2
    except ImportError:
        return frames_dir
    frame_files = sorted(os.listdir(frames_dir))
    first = cv2.imread(os.path.join(frames_dir, frame_files[0]))
    h_px, w_px = first.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w_px, h_px))
    if not writer.isOpened():
        return frames_dir
    for f in frame_files:
        writer.write(cv2.imread(os.path.join(frames_dir, f)))
    writer.release()
    shutil.rmtree(frames_dir)
    return out_path


def render_field_verification(grid, A, h, out_prefix: str,
                              subsample: int = 4):
    """A-contour and quiver figures of the magnetic field and the
    jacobian-form Lorentz force (``<out_prefix>_magnetic_field.png``,
    ``<out_prefix>_lorentz_force.png``). ``A`` and ``h`` are tensors or
    arrays on ``grid``; returns the two written paths."""
    import torch
    from . import operators as op
    from .physics.lorentz import lorentz_force_jacobian, magnetic_field_cc
    plt = _mpl()

    def on_grid(a):
        return torch.as_tensor(a, dtype=grid.dtype, device=grid.device)

    def host(a):
        return a.detach().cpu().numpy()

    A, h = on_grid(A), on_grid(h)
    Xc, Yc = (host(a) for a in grid.nodes("cc"))
    Bx, By = (host(a) for a in magnetic_field_cc(A, h, grid))
    fu, fv = lorentz_force_jacobian(A, h, grid)
    # the face forces interpolated to centers for the arrows
    fu_c = host(op.ix_c(fu, grid))
    fv_c = host(op.iy_c(fv, grid))
    A_np = host(A)
    s = slice(None, None, subsample)

    made = []
    for tag, (U, V), title in (
            ("magnetic_field", (Bx, By), "A and magnetic field"),
            ("lorentz_force", (fu_c, fv_c), "A and Lorentz force")):
        fig, ax = plt.subplots(figsize=(7, 6))
        cs = ax.contourf(Xc, Yc, A_np, levels=20, cmap="viridis")
        ax.quiver(Xc[s, s], Yc[s, s], U[s, s], V[s, s], color="white")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_title(title)
        fig.colorbar(cs, ax=ax, label="A")
        path = f"{out_prefix}_{tag}.png"
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        made.append(path)
    return made


def render_scenario_outputs(outdir: str, title: str = ""):
    """The energy figure and the movie of a CLI run directory."""
    made = []
    energies = os.path.join(outdir, "energies.csv")
    if os.path.exists(energies):
        made.append(render_energy_plot(
            energies, os.path.join(outdir, "energy_plot.png"), title))
    fields = os.path.join(outdir, "fields")
    if os.path.isdir(fields):
        made.append(render_movie(fields, os.path.join(outdir, "movie.mp4")))
    return made
