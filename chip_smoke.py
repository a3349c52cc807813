#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (swmhd_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases,
each printing lines of findings; any failure exits non-zero:

1. versions of torch, CUDA, nvcc and the card (name, power limit);
2. build of the CUDA kernels from ``swmhd_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. each kernel branch against its plain PyTorch version at 256²: the
   vector-invariant and conservative formulations, periodic, bounded in y
   (A background gradient −0.05) and bounded in x and y (with fields that
   carry structure next to the walls); one substage's
   tendencies G and 10 RK3 steps, float64 (<= 1e-11) and float32
   (<= 2e-5), relative to the largest field of the compared set, with the
   error over the four rows next to each wall printed on its own;
4. 1000 float32 steps of ``64x64_two_Gaussians_high_B`` in each
   formulation against the frozen float64 trajectories
   ``tests/fixtures/{jacobian,divergence}_64.npz``, within the per-field
   drift bounds of ``tests/fixtures/f32_tolerance.npz``;
5. the main path: ``swmhd_tpu_torch.cli run <scenario> --stop-time 1.0``
   on CUDA in float32 for ``128x128_two_Gaussians_high_B`` and
   ``128x128_low_B_low_U`` in both formulations (each: 101 finite energy
   rows, ``final.npz``, 300 substage launches, no plain-version call);
6. the ``bench.py`` configuration at 2048² float32 in both formulations:
   20 steps through the kernel stepper timed with CUDA events after a
   warm-up, and 100 steps of each ``128x128_low_B_low_U`` (bounded y)
   through the stepper without a series (one multistep call); then,
   outside the counted window, the plain versions' times, per substage and
   per step, the 2048² states after 3 steps against each other, the
   kernel against the plain version at 128² for the four configurations
   of phase 5 (G of one substage and 10 steps, float32 <= 2e-5, wall rows
   printed), the 128² rates of ``128x128_two_Gaussians_high_B``, and the
   CLI runs of phase 5 timed with the kernel and with ``--no-fused`` in
   turns.

Phases 5 and 6's kernel runs are the main path: the launch counters are
zeroed just before phase 5 and read just after the kernel runs of phase
6; comparisons with the plain versions happen outside that window. The
last two lines are a JSON object of per-kernel findings (one entry per
entry point and branch) and the result line ``{"ok": true, "device":
{...}}``.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_N = 2048
SMOKE_N = 256
F64_BOUND = 1e-11
F32_BOUND = 2e-5          # tests/test_fused.py's f32 kernel-vs-XLA bound
WALL_ROWS = 4

VI, CONS = "vector_invariant", "conservative"
PERIODIC = ("periodic", "periodic")
BOUNDED_Y = ("periodic", "bounded")
BOUNDED_XY = ("bounded", "bounded")
# (formulation, topology, A background gradient) compared in phase 3
CONFIGS = [(VI, PERIODIC, 0.0), (CONS, PERIODIC, 0.0),
           (VI, BOUNDED_Y, -0.05), (CONS, BOUNDED_Y, -0.05),
           (VI, BOUNDED_XY, -0.05), (CONS, BOUNDED_XY, -0.05)]
# the CLI runs of the main path: (scenario, formulation)
CLI_RUNS = [("128x128_two_Gaussians_high_B", VI),
            ("128x128_low_B_low_U", VI),
            ("128x128_two_Gaussians_high_B", CONS),
            ("128x128_low_B_low_U", CONS)]
SOURCES = {VI: "swmhd_tpu_torch/csrc/vector_invariant.cu",
           CONS: "swmhd_tpu_torch/csrc/conservative.cu"}
REPLACES = {"swmhd_substage": "swmhd_tpu/ops/fused_step.py:176",
            "swmhd_multistep": "swmhd_tpu/ops/fused_step.py:458"}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def command_output(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"{cmd[0]}: {e}")
    if out.returncode != 0:
        fail(f"{' '.join(cmd)} exited {out.returncode}: {out.stderr}")
    return out.stdout.strip()


def rel_err(a, b, scale=None):
    """max|a-b| / max|b| (or / scale), in float64."""
    a, b = a.double(), b.double()
    s = float(b.abs().max()) if scale is None else scale
    return float((a - b).abs().max()) / max(s, 1e-300)


def bench_model(N, dtype, device, formulation=VI, topology=PERIODIC,
                gamma=0.0):
    """The bench.py configuration: vortex + dipole A, h = 1 (the vortex
    is the transport in the conservative formulation; h = 1 makes it the
    same velocity)."""
    import torch
    from swmhd_tpu_torch import (Grid, ShallowWaterModel, FPlane,
                                 jacobian_lorentz_forcing,
                                 divergence_lorentz_forcing)
    g = Grid.regular(N, N, (-5.0, 5.0), (-5.0, 5.0), topology=topology,
                     dtype=dtype, device=device)
    forcing = (divergence_lorentz_forcing(gamma) if formulation == CONS
               else jacobian_lorentz_forcing(gamma))
    model = ShallowWaterModel(grid=g, formulation=formulation,
                              gravitational_acceleration=9.81,
                              coriolis=FPlane(1.0), forcing=forcing,
                              A_background_gradient_y=gamma)
    e = lambda x, y: torch.exp(-(x ** 2 + y ** 2))
    state = model.initial_state(
        u=lambda x, y: 5 * y * e(x, y), v=lambda x, y: -5 * x * e(x, y),
        h=1.0,
        A=lambda x, y: 0.5 * torch.exp(-((x - 0.5) ** 2 + y ** 2))
        - 0.5 * torch.exp(-((x + 0.5) ** 2 + y ** 2)))
    return model, state


def wall_terms(xp):
    """Smooth terms (periodic in x over the [-5, 5]² domain) that stay
    O(0.1) at the domain edges, as ``initial_state`` keyword functions of
    the array module ``xp``: added to fields that are ≈e^-25 at the edges,
    they give the rows next to a wall structure (h varies too)."""
    k = xp.pi / 5
    return dict(
        u=lambda x, y: 0.3 * xp.cos(0.6 * y) + 0.1 * xp.sin(k * x),
        v=lambda x, y: 0.2 * xp.cos(k * x) * (1 + 0.3 * y),
        h=lambda x, y: 0.05 * xp.cos(k * x) * xp.sin(0.3 * y + 0.5),
        A=lambda x, y: 0.1 * xp.sin(k * x) * xp.cos(0.5 * y))


def wall_model(N, dtype, device, formulation, topology, gamma):
    """The bench configuration plus :func:`wall_terms`."""
    import torch
    model, state = bench_model(N, dtype, device, formulation, topology,
                               gamma)
    add = model.initial_state(**wall_terms(torch))
    return model, state.replace(
        **{f: getattr(state, f) + getattr(add, f) for f in "huvA"})


def timed(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def wall_errors(a, b, scale, topology):
    """Errors over the WALL_ROWS rows next to each wall of the bounded
    axes, as 'y0 …, y1 …' (last axes of stacked (4, Nx, Ny) tensors)."""
    parts = []
    for axis, name in ((1, "x"), (2, "y")):
        if topology[axis - 1] != "bounded":
            continue
        n = a.shape[axis]
        for side, idx in (("0", slice(0, WALL_ROWS)),
                          ("1", slice(n - WALL_ROWS, n))):
            sl = [slice(None)] * 3
            sl[axis] = idx
            parts.append(f"{name}{side} "
                         f"{rel_err(a[tuple(sl)], b[tuple(sl)], scale):.2e}")
    return ", ".join(parts)


def compare_branch(K, dev, cfg, dtype, bound, dt=0.005):
    """Phase 3 for one configuration; returns its kernel branch and the
    max abs errors of G and of the 10-step state."""
    import torch
    formulation, topology, gamma = cfg
    make = wall_model if "bounded" in topology else bench_model
    model, state = make(SMOKE_N, dtype, dev, *cfg)
    s = K.stack(state)
    s_k, G_k = K.substage(model, s, dt, 0)
    s_p, G_p = K.substage_reference(model, s, dt, 0)
    g_scale = float(G_p.abs().max())
    g_err = [rel_err(G_k[n], G_p[n], g_scale) for n in range(4)]
    s2_k, _ = K.substage(model, s_k, dt, 1, G_k)
    s2_p, _ = K.substage_reference(model, s_p, dt, 1, G_p)
    x = K.multistep(model, s, dt, 10)
    y = K.multistep_reference(model, s, dt, 10)
    torch.cuda.synchronize()
    scale = float(y.abs().max())
    sub_err = rel_err(s2_k, s2_p, scale)
    step_err = [rel_err(x[n], y[n], scale) for n in range(4)]
    worst = max(g_err + step_err + [sub_err])
    label = f"{formulation} {'/'.join(topology)} gamma {gamma:g}"
    walls = ""
    if "bounded" in topology:
        walls = (f"; next to walls: G {wall_errors(G_k, G_p, g_scale, topology)}"
                 f"; 10 steps {wall_errors(x, y, scale, topology)}")
    say(3, f"{dtype} {SMOKE_N}^2 {label}: G rel err (h,u,v,A) "
           f"{', '.join(f'{e:.2e}' for e in g_err)}; substage 2 "
           f"{sub_err:.2e}; 10 steps (h,u,v,A) "
           f"{', '.join(f'{e:.2e}' for e in step_err)}{walls}; "
           f"bound {bound:g}")
    if not (torch.isfinite(x).all() and torch.isfinite(G_k).all()
            and worst <= bound):
        fail(f"kernel disagrees with the plain version in {dtype}, "
             f"{label}: {worst:.3e} > {bound:g}")
    return (K.kernel_params(model)[:3],
            float((G_k - G_p).abs().max()), float((x - y).abs().max()))


def compare_main_size(K, label, model, s, dt, y10, G_k, G_p):
    """The kernel against the plain version at a size the main path runs:
    G of one substage (``G_k`` against ``G_p``) and 10 RK3 steps against
    ``y10``, the plain result, in float32 within F32_BOUND."""
    import torch
    x10 = K.multistep(model, s, dt, 10)
    topology = (model.grid.topology_x, model.grid.topology_y)
    g_scale, scale = float(G_p.abs().max()), float(y10.abs().max())
    g_err, err = rel_err(G_k, G_p, g_scale), rel_err(x10, y10, scale)
    walls = ""
    if "bounded" in topology:
        walls = (f"; next to walls: G {wall_errors(G_k, G_p, g_scale, topology)}"
                 f"; 10 steps {wall_errors(x10, y10, scale, topology)}")
    say(6, f"{label} f32 kernel vs plain: G rel err {g_err:.2e}; 10 steps "
           f"{err:.2e}{walls}; bound {F32_BOUND:g}")
    if not (torch.isfinite(x10).all() and max(g_err, err) <= F32_BOUND):
        fail(f"kernel disagrees with the plain version, {label}: "
             f"{max(g_err, err):.3e} > {F32_BOUND:g}")


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "swmhd_tpu_torch")):
        fail(f"no swmhd_tpu_torch package next to {__file__}: run from "
             f"the root of a checkout")
    sys.path.insert(0, HERE)
    from swmhd_tpu_torch.ops import _build
    from swmhd_tpu_torch.ops import substage as K
    from swmhd_tpu_torch import scenarios, cli
    import numpy as np
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1 -------------------------------------------------------------------
    nvcc = command_output([_build._nvcc(), "--version"]).splitlines()[-1]
    smi = command_output(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).splitlines()[0]
    say(1, f"python {sys.version.split()[0]} torch {torch.__version__} "
           f"cuda {torch.version.cuda}; nvcc: {nvcc}; card: {smi}")

    # 2 -------------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    regs = [ln.split("info    : ")[-1] for ln in lib.log.splitlines()
            if "registers" in ln]
    spills = [ln.strip() for ln in lib.log.splitlines()
              if "spill stores" in ln and ", 0 bytes spill" not in ln]
    say(2, f"built {os.path.relpath(lib.path, HERE)} in "
           f"{lib.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f} "
           f"s); ptxas: {'; '.join(regs)}; nonzero spills: "
           f"{'; '.join(spills) or 'none'}")

    # 3 -------------------------------------------------------------------
    errors = {}           # branch -> (substage G, multistep) f32 abs err
    for cfg in CONFIGS:
        for dtype, bound in ((torch.float64, F64_BOUND),
                             (torch.float32, F32_BOUND)):
            b, g_err, step_err = compare_branch(K, dev, cfg, dtype, bound)
            if dtype == torch.float32:
                errors[b] = (g_err, step_err)

    # 4 -------------------------------------------------------------------
    tol = np.load(os.path.join(HERE, "tests", "fixtures",
                               "f32_tolerance.npz"))
    for key, formulation in (("jacobian_64", VI), ("divergence_64", CONS)):
        fx = np.load(os.path.join(HERE, "tests", "fixtures", f"{key}.npz"))
        model, state, sc = scenarios.build("64x64_two_Gaussians_high_B",
                                           formulation,
                                           dtype=torch.float32, device=dev)
        out = K.multistep(model, K.stack(state), sc.dt, 1000).cpu().double()
        parts, ok = [], True
        for n, name in enumerate(("h", "u", "v", "A")):
            drift = float(np.max(np.abs(out[n].numpy() - fx[name])))
            bound = float(tol[f"{key}:{name}"])
            parts.append(f"{name} {drift:.3e}/{bound:.3e}")
            ok &= drift <= bound
        say(4, f"f32 1000 steps {formulation} vs {key}.npz, drift/bound: "
               f"{', '.join(parts)}")
        if not ok:
            fail(f"f32 fixture drift from {key}.npz exceeds "
                 f"f32_tolerance.npz")

    # 5 -------------------------------------------------------------------
    def cli_run(scenario, formulation, *flags):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            cli.main(["run", scenario, "--formulation", formulation,
                      "--stop-time", "1.0", "--outdir", tmp, *flags])
            wall = time.perf_counter() - t0
            rows = np.loadtxt(os.path.join(tmp, "energies.csv"),
                              delimiter=",", skiprows=1, ndmin=2)
            has_final = os.path.exists(os.path.join(tmp, "final.npz"))
        return wall, rows, has_final

    def plain_calls():
        return K.substage_reference.calls + K.multistep_reference.calls

    K.reset_counters()
    cli_walls = {}
    for scenario, formulation in CLI_RUNS:
        before = K.substage.launches
        wall, rows, has_final = cli_run(scenario, formulation)
        launches = K.substage.launches - before
        cli_walls[(scenario, formulation)] = wall
        say(5, f"cli run {scenario} {formulation} f32 t=1.0: {wall:.2f} s "
               f"wall, {len(rows)} energy rows, finite "
               f"{bool(np.isfinite(rows).all())}, final.npz {has_final}, "
               f"substage launches {launches}, plain calls {plain_calls()}")
        if not (len(rows) == 101 and np.isfinite(rows).all()
                and has_final):
            fail(f"the CLI run of {scenario} ({formulation}) did not write "
                 f"101 finite rows and final.npz")
        if launches != 300:
            fail(f"expected 300 substage launches, got {launches}")

    # 6 -------------------------------------------------------------------
    bench_dt, steps = 0.001, 20
    bench = {}            # formulation -> (model, state, ms per step)
    for formulation in (VI, CONS):
        model, state = bench_model(BENCH_N, torch.float32, dev, formulation)
        stepper = K.KernelStepper(model)
        stepper.step_fn(bench_dt, 1)(state)                   # warm-up
        run20 = stepper.step_fn(bench_dt, steps)
        ms_call, _ = timed(lambda: run20(state), 1)
        bench[formulation] = (model, state, ms_call / steps)
    walled = {}           # formulation -> (model, state, dt, ms per step)
    for formulation in (VI, CONS):
        model, state, sc = scenarios.build("128x128_low_B_low_U",
                                           formulation, dtype=torch.float32,
                                           device=dev)
        run100 = K.KernelStepper(model).step_fn(sc.dt, 100)
        ms_call, out = timed(lambda: run100(state), 1)
        if not all(torch.isfinite(f).all() for f in out.fields()):
            fail(f"128x128_low_B_low_U ({formulation}) went non-finite")
        walled[formulation] = (model, state, sc.dt, ms_call / 100)
    launches = {"swmhd_substage": dict(K.substage.launches_by_branch),
                "swmhd_multistep": dict(K.multistep.launches_by_branch)}
    if plain_calls():
        fail(f"plain versions ran {plain_calls()} times on the main path")
    # (conservative, wall_x, wall_y) of the main path's runs
    main_branches = [(c, 0, wall_y) for c in (0, 1) for wall_y in (0, 1)]
    for name, counts in launches.items():
        for b in main_branches:
            if not counts.get(b):
                fail(f"{name} [{K.branch_label(b)}] was not launched on the "
                     f"main path")
    say(6, "main-path launches by branch: " + json.dumps(
        {name: {K.branch_label(b): n for b, n in counts.items()}
         for name, counts in launches.items()}))

    # outside the counted window: plain timings and comparisons
    timings = {}          # branch -> {entry point: (ms, plain ms)}
    pts = BENCH_N * BENCH_N
    for formulation in (VI, CONS):
        model, state, ms_step = bench[formulation]
        s = K.stack(state)
        K.multistep_reference(model, s, bench_dt, 1)          # warm-up
        plain_ms_step, y = timed(
            lambda: K.multistep_reference(model, s, bench_dt, 3), 1)
        plain_ms_step /= 3
        x = K.multistep(model, s, bench_dt, 3)
        err3 = rel_err(x, y)
        sub_ms, _ = timed(lambda: K.substage(model, s, bench_dt, 0), 10)
        sub_plain_ms, _ = timed(
            lambda: K.substage_reference(model, s, bench_dt, 0), 3)
        rate, plain_rate = pts / (ms_step * 1e-3), pts / (plain_ms_step * 1e-3)
        say(6, f"bench {BENCH_N}^2 f32 {formulation} periodic on {smi}: "
               f"kernel {ms_step:.4f} ms/step = {rate:.4e} points/s; plain "
               f"{plain_ms_step:.4f} ms/step = {plain_rate:.4e} points/s; "
               f"substage kernel {sub_ms:.4f} ms, plain {sub_plain_ms:.4f} "
               f"ms; 3-step rel err {err3:.2e}")
        if not (math.isfinite(err3) and err3 <= F32_BOUND):
            fail(f"bench state after 3 steps disagrees ({formulation}): "
                 f"{err3:.3e}")
        timings[K.kernel_params(model)[:3]] = {
            "swmhd_substage": (sub_ms, sub_plain_ms),
            "swmhd_multistep": (ms_step, plain_ms_step)}
    for formulation in (VI, CONS):
        model, state, dt, ms_step = walled[formulation]
        s = K.stack(state)
        K.multistep_reference(model, s, dt, 1)
        plain_ms_step, y10 = timed(
            lambda: K.multistep_reference(model, s, dt, 10), 1)
        plain_ms_step /= 10
        K.substage(model, s, dt, 0)
        sub_ms, (_, G_k) = timed(lambda: K.substage(model, s, dt, 0), 100)
        sub_plain_ms, (_, G_p) = timed(
            lambda: K.substage_reference(model, s, dt, 0), 10)
        compare_main_size(K, f"128x128_low_B_low_U {formulation}", model, s,
                          dt, y10, G_k, G_p)
        n = model.grid.Nx * model.grid.Ny
        say(6, f"128x128_low_B_low_U f32 {formulation} bounded y on {smi}: "
               f"multistep kernel {ms_step:.4f} ms/step = "
               f"{n / (ms_step * 1e-3):.4e} points/s; plain "
               f"{plain_ms_step:.4f} ms/step = "
               f"{n / (plain_ms_step * 1e-3):.4e} points/s; substage kernel "
               f"{sub_ms:.4f} ms, plain {sub_plain_ms:.4f} ms")
        timings[K.kernel_params(model)[:3]] = {
            "swmhd_substage": (sub_ms, sub_plain_ms),
            "swmhd_multistep": (ms_step, plain_ms_step)}

    # the 128² periodic CLI configuration per step, checked against the
    # plain version; then the CLI runs end to end with the kernel and
    # with --no-fused, in turns
    pts = 128 * 128
    for formulation in (VI, CONS):
        model, state, sc = scenarios.build("128x128_two_Gaussians_high_B",
                                           formulation, dtype=torch.float32,
                                           device=dev)
        s = K.stack(state)
        K.multistep(model, s, sc.dt, 1)
        k128, _ = timed(lambda: K.multistep(model, s, sc.dt, 100), 1)
        K.multistep_reference(model, s, sc.dt, 1)
        p128, y10 = timed(
            lambda: K.multistep_reference(model, s, sc.dt, 10), 1)
        k128, p128 = k128 / 100, p128 / 10
        say(6, f"128x128_two_Gaussians_high_B f32 {formulation} on {smi}: "
               f"multistep kernel {k128:.4f} ms/step = "
               f"{pts / (k128 * 1e-3):.4e} points/s; plain {p128:.4f} "
               f"ms/step = {pts / (p128 * 1e-3):.4e} points/s")
        compare_main_size(K, f"128x128_two_Gaussians_high_B {formulation}",
                          model, s, sc.dt, y10,
                          K.substage(model, s, sc.dt, 0)[1],
                          K.substage_reference(model, s, sc.dt, 0)[1])
    for scenario, formulation in CLI_RUNS:
        walls = {"--fused": [], "--no-fused": []}
        for flag in ("--fused", "--no-fused", "--no-fused", "--fused"):
            walls[flag].append(cli_run(scenario, formulation, flag)[0])
        say(6, f"cli {scenario} {formulation} t=1.0 wall s on {smi}: "
               f"main path {cli_walls[(scenario, formulation)]:.3f}; kernel "
               f"{', '.join(f'{w:.3f}' for w in walls['--fused'])}; "
               f"--no-fused "
               f"{', '.join(f'{w:.3f}' for w in walls['--no-fused'])}")

    if "jax" in sys.modules:
        fail("jax was imported")
    kernels = []
    for b in main_branches:
        for k, name in enumerate(("swmhd_substage", "swmhd_multistep")):
            ms, plain_ms = timings[b][name]
            kernels.append({
                "name": f"{name} [{K.branch_label(b)}]", "route": "cuda",
                "source": SOURCES[CONS if b[0] else VI],
                "replaces": REPLACES[name],
                "launches": launches[name][b],
                "max_abs_err": errors[b][k], "ms": ms, "plain_ms": plain_ms})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
