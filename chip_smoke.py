#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (swmhd_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card. Phases,
each printing one line of findings; any failure exits non-zero:

1. versions of torch, CUDA, nvcc and the card (name, power limit);
2. build of the CUDA kernels from ``swmhd_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version at 256²: one
   substage's tendencies G and 10 RK3 steps, float64 (<= 1e-11) and
   float32 (<= 2e-5), relative to the largest field of the compared set;
4. 1000 float32 steps of ``64x64_two_Gaussians_high_B`` against the frozen
   float64 trajectory ``tests/fixtures/jacobian_64.npz``, within the
   per-field drift bounds of ``tests/fixtures/f32_tolerance.npz``;
5. the main path: ``swmhd_tpu_torch.cli run 128x128_two_Gaussians_high_B
   --stop-time 1.0`` on CUDA in float32 (101 finite energy rows,
   ``final.npz``, 300 substage launches, no plain-version call);
6. the ``bench.py`` configuration at 2048² float32: 20 steps through the
   kernel stepper timed with CUDA events after a warm-up, 3 steps of the
   plain version, both as points/s, and their states after 3 steps; then
   the same two rates at 128², and the phase-5 CLI run timed with the
   kernel and with ``--no-fused`` in turns.

Phases 5 and 6's kernel runs are the main path: the launch counters are
zeroed just before phase 5 and read just after the timed kernel run of
phase 6; comparisons with the plain versions happen outside that window.
The last two lines are a JSON object of per-kernel findings and the
result line ``{"ok": true, "device": {...}}``.
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


def bench_model(N, dtype, device):
    """The bench.py configuration: vortex + dipole A, h = 1."""
    import torch
    from swmhd_tpu_torch import (Grid, ShallowWaterModel, FPlane,
                                 jacobian_lorentz_forcing)
    g = Grid.regular(N, N, (-5.0, 5.0), (-5.0, 5.0), dtype=dtype,
                     device=device)
    model = ShallowWaterModel(grid=g, gravitational_acceleration=9.81,
                              coriolis=FPlane(1.0),
                              forcing=jacobian_lorentz_forcing())
    e = lambda x, y: torch.exp(-(x ** 2 + y ** 2))
    state = model.initial_state(
        u=lambda x, y: 5 * y * e(x, y), v=lambda x, y: -5 * x * e(x, y),
        h=1.0,
        A=lambda x, y: 0.5 * torch.exp(-((x - 0.5) ** 2 + y ** 2))
        - 0.5 * torch.exp(-((x + 0.5) ** 2 + y ** 2)))
    return model, state


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
    from swmhd_tpu_torch import scenarios
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
    say(2, f"built {os.path.relpath(lib.path, HERE)} in "
           f"{lib.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f} "
           f"s); ptxas: {'; '.join(regs)}")

    # 3 -------------------------------------------------------------------
    findings = {}
    dt = 0.005
    for dtype, bound in ((torch.float64, F64_BOUND),
                         (torch.float32, F32_BOUND)):
        model, state = bench_model(SMOKE_N, dtype, dev)
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
        say(3, f"{dtype} {SMOKE_N}^2: G rel err (h,u,v,A) "
               f"{', '.join(f'{e:.2e}' for e in g_err)}; substage 2 "
               f"{sub_err:.2e}; 10 steps (h,u,v,A) "
               f"{', '.join(f'{e:.2e}' for e in step_err)}; bound {bound:g}")
        if not (torch.isfinite(x).all() and worst <= bound):
            fail(f"kernel disagrees with the plain version in {dtype}: "
                 f"{worst:.3e} > {bound:g}")
        if dtype == torch.float32:
            findings["swmhd_substage"] = float((G_k - G_p).abs().max())
            findings["swmhd_multistep"] = float((x - y).abs().max())

    # 4 -------------------------------------------------------------------
    import numpy as np
    fx = np.load(os.path.join(HERE, "tests", "fixtures", "jacobian_64.npz"))
    tol = np.load(os.path.join(HERE, "tests", "fixtures",
                               "f32_tolerance.npz"))
    model, state, sc = scenarios.build("64x64_two_Gaussians_high_B",
                                       dtype=torch.float32, device=dev)
    out = K.multistep(model, K.stack(state), sc.dt, 1000).cpu().double()
    parts, ok = [], True
    for n, name in enumerate(("h", "u", "v", "A")):
        drift = float(np.max(np.abs(out[n].numpy() - fx[name])))
        bound = float(tol[f"jacobian_64:{name}"])
        parts.append(f"{name} {drift:.3e}/{bound:.3e}")
        ok &= drift <= bound
    say(4, f"f32 1000 steps vs jacobian_64.npz, drift/bound: "
           f"{', '.join(parts)}")
    if not ok:
        fail("f32 fixture drift exceeds f32_tolerance.npz")

    # 5 -------------------------------------------------------------------
    from swmhd_tpu_torch import cli
    K.reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli.main(["run", "128x128_two_Gaussians_high_B", "--stop-time",
                  "1.0", "--outdir", tmp])
        wall = time.perf_counter() - t0
        rows = np.loadtxt(os.path.join(tmp, "energies.csv"), delimiter=",",
                          skiprows=1, ndmin=2)
        has_final = os.path.exists(os.path.join(tmp, "final.npz"))
    launches_cli = K.substage.launches
    say(5, f"cli run 128^2 f32 t=1.0: {wall:.2f} s wall, {len(rows)} energy "
           f"rows, finite {bool(np.isfinite(rows).all())}, final.npz "
           f"{has_final}, substage launches {launches_cli}, plain calls "
           f"{K.substage_reference.calls + K.multistep_reference.calls}")
    if not (len(rows) == 101 and np.isfinite(rows).all() and has_final):
        fail("the CLI run did not write 101 finite rows and final.npz")
    if launches_cli != 300:
        fail(f"expected 300 substage launches, got {launches_cli}")

    # 6 -------------------------------------------------------------------
    model, state = bench_model(BENCH_N, torch.float32, dev)
    stepper = K.KernelStepper(model)
    bench_dt, steps = 0.001, 20
    stepper.step_fn(bench_dt, 1)(state)                       # warm-up
    run20 = stepper.step_fn(bench_dt, steps)
    ms_call, _ = timed(lambda: run20(state), 1)
    launches = {"swmhd_substage": K.substage.launches,
                "swmhd_multistep": K.multistep.launches}
    plain_calls = K.substage_reference.calls + K.multistep_reference.calls
    if plain_calls:
        fail(f"plain versions ran {plain_calls} times on the main path")
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was not launched on the main path")
    ms_step = ms_call / steps

    # outside the counted window: plain timings and comparisons
    s = K.stack(state)
    K.multistep_reference(model, s, bench_dt, 1)              # warm-up
    plain_ms_step, y = timed(
        lambda: K.multistep_reference(model, s, bench_dt, 3), 1)
    plain_ms_step /= 3
    x = K.multistep(model, s, bench_dt, 3)
    err3 = rel_err(x, y)
    sub_ms, _ = timed(lambda: K.substage(model, s, bench_dt, 0), 10)
    sub_plain_ms, _ = timed(
        lambda: K.substage_reference(model, s, bench_dt, 0), 3)
    pts = BENCH_N * BENCH_N
    rate, plain_rate = pts / (ms_step * 1e-3), pts / (plain_ms_step * 1e-3)
    say(6, f"bench {BENCH_N}^2 f32 on {smi}: kernel {ms_step:.4f} ms/step "
           f"= {rate:.4e} points/s; plain {plain_ms_step:.4f} ms/step = "
           f"{plain_rate:.4e} points/s; substage kernel {sub_ms:.4f} ms, "
           f"plain {sub_plain_ms:.4f} ms; 3-step rel err {err3:.2e}")
    if not (math.isfinite(err3) and err3 <= F32_BOUND):
        fail(f"bench state after 3 steps disagrees: {err3:.3e}")

    # the main path's size: per step, and the CLI run end to end with the
    # kernel and with --no-fused, in turns
    model, state, sc = scenarios.build("128x128_two_Gaussians_high_B",
                                       dtype=torch.float32, device=dev)
    s = K.stack(state)
    K.multistep(model, s, sc.dt, 1)
    k128, _ = timed(lambda: K.multistep(model, s, sc.dt, 100), 1)
    K.multistep_reference(model, s, sc.dt, 1)
    p128, _ = timed(lambda: K.multistep_reference(model, s, sc.dt, 10), 1)
    k128, p128 = k128 / 100, p128 / 10
    walls = {"--fused": [], "--no-fused": []}
    for flag in ("--fused", "--no-fused", "--no-fused", "--fused"):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            cli.main(["run", "128x128_two_Gaussians_high_B", "--stop-time",
                      "1.0", "--outdir", tmp, flag])
            walls[flag].append(time.perf_counter() - t0)
    pts = 128 * 128
    say(6, f"128^2 f32 on {smi}: multistep kernel {k128:.4f} ms/step = "
           f"{pts / (k128 * 1e-3):.4e} points/s; plain {p128:.4f} ms/step "
           f"= {pts / (p128 * 1e-3):.4e} points/s; cli t=1.0 wall s "
           f"kernel {walls['--fused']}, --no-fused {walls['--no-fused']}")

    if "jax" in sys.modules:
        fail("jax was imported")
    kernels = [
        {"name": "swmhd_substage", "route": "cuda",
         "source": "swmhd_tpu_torch/csrc/substage.cu",
         "replaces": "swmhd_tpu/ops/fused_step.py:176",
         "launches": launches["swmhd_substage"],
         "max_abs_err": findings["swmhd_substage"],
         "ms": sub_ms, "plain_ms": sub_plain_ms},
        {"name": "swmhd_multistep", "route": "cuda",
         "source": "swmhd_tpu_torch/csrc/substage.cu",
         "replaces": "swmhd_tpu/ops/fused_step.py:458",
         "launches": launches["swmhd_multistep"],
         "max_abs_err": findings["swmhd_multistep"],
         "ms": ms_step, "plain_ms": plain_ms_step},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
