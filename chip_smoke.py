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
   carry structure next to the walls), each with no closure, a Laplacian
   and a biharmonic one (ν·dt/dx^p = 0.01), and bounded in x and y with
   the other OPTIONS (VorticityStencil, Centered2 and UpwindBiased3
   momentum, mass and tracer); one substage's tendencies G and 10 RK3
   steps, float64 (<= 1e-11) and float32 (<= 2e-5), relative to the
   largest field of the compared set, with the error over the four rows
   next to each wall printed on its own;
4. 1000 float32 steps of ``64x64_two_Gaussians_high_B`` in each
   formulation against the frozen float64 trajectories
   ``tests/fixtures/{jacobian,divergence}_64.npz``, within the per-field
   drift bounds of ``tests/fixtures/f32_tolerance.npz``;
5. the main path: ``swmhd_tpu_torch.cli run <scenario> --stop-time 1.0``
   on CUDA in float32 for ``128x128_two_Gaussians_high_B`` and
   ``128x128_low_B_low_U`` in both formulations, and with the closures of
   CLOSURE_FLAGS (``128x128_two_Gaussians_high_B --nu 1e-5 --kappa 1e-5
   --biharmonic``, ``128x128_low_B_low_U --formulation conservative --nu
   1e-3 --kappa 1e-3``) (each: 101 finite energy rows, ``final.npz``, 100
   resident launches holding 300 substages in one branch, the closure's
   where there is one, replayed from the chunks' CUDA graphs, 102 launches
   of the energy series kernel (the first row, the capture's warm-up, one
   a step), no one-substage launch and no plain-version call);
6. the ``bench.py`` configuration at 2048² float32 in both formulations,
   without and with a biharmonic closure, whose state exceeds the card's
   L2, so the kernel stepper takes one-substage launches (the
   counterpart of ``fused_step_fn``): 20 steps through the stepper timed
   with CUDA events after a warm-up (with the closure one step with a
   series, so through a graph chunk), exactly 3 launches a step in each
   of those branches and none elsewhere; and 100 steps of each
   ``128x128_low_B_low_U`` (bounded y; conservative with the Laplacian
   closure; and with the scheme and stencil switches of SCHEME_RUNS,
   after one step with a series) and of the conservative
   ``128x128_two_Gaussians_high_B`` with the CLI's biharmonic closure
   through the stepper without a series (one resident launch); then,
   outside the counted window, the plain versions' times, per substage and
   per step, the resident kernel's at 2048², the 2048² states after 3
   steps against each other, the
   kernel against the plain version at 128² for the configurations of
   phase 5, of SCHEME_RUNS and ``128x128_two_Gaussians_high_B``
   conservative with the biharmonic closure (G of one substage and 10
   steps, float64 <= 1e-11 and float32 <= 2e-5, wall rows printed; with
   a closure, how far it moves G, which must exceed 100 × 1e-11), the
   128² rates of ``128x128_two_Gaussians_high_B``, and the CLI runs of
   phase 5 timed with the kernel, with ``--no-fused`` and with the kernel
   again.

7. the tile substage (``swmhd_substage`` with a halo, the kernel of the
   domain decomposition) against the whole-domain substage in one
   process: the 2048² configuration cut into 2×2, 4×1 and 1×4 layouts of
   tiles (halo 6 on each cut axis, sliced from the global state with
   wrap) and ``128x128_low_B_low_U`` into 4×1 (halo 6 in x, whole walled
   rows), in both formulations, float32 (<= 2e-5) and float64 (<=
   1e-12), G and the state of substages 0 and 1 relative to the field
   scale, printing whether the two agree bit for bit; the 2048² 2×2
   tiles with a biharmonic closure, which must agree bit for bit with a
   halo of 7 (printed for 6 and 3 besides); the tile kernel
   against its plain version on one tile at 256² with wall-reaching
   fields for each of the four tile branches, and on one tile of each
   main-path layout (2048² in 2×2, 128² in 4×1; G and the state of
   substages 0 and 1: float64 <= 1e-11; float32 states <= 2e-5 and G
   within 2e-5 or no farther from the float64 plain G than twice the
   float32 plain G; the 128² 4×1 tile also with the biharmonic closure
   of the decomposed CLI run, halo 7), where it is timed against the
   plain version and the whole-domain substage on a grid of the tile's
   size; then one substage of the 2048² grid and one of a tile of its 2×2
   mesh under torch.profiler, each formulation: a substage must launch
   exactly one CUDA kernel, its formulation's tile kernel
   (``vi_substage``, ``cons_substage``);
8. the decomposed main path, four ranks sharing the one card over gloo
   (``torch.distributed.run``, halo slabs staged through host memory):
   the 2048² configuration in both formulations, 20 steps each through
   ``DomainDecomposition.fused_stepper`` against 20 single-device
   multistep steps (<= 2e-5), with the per-step time, the time of one
   substage's halo exchange (CUDA events), the host's time to issue one
   step, the tile launches by branch (3 a step and rank) and whether the
   two states agree bit for bit; then ``swmhd_tpu_torch.cli run
   128x128_low_B_low_U
   --stop-time 1.0`` in both formulations, and vector-invariant with the
   biharmonic CLOSURE_FLAGS (halo 7), on a 4×1 mesh (101 finite energy
   rows, ``final.npz`` against the single-rank CLI run within the float32
   bound, 300 tile launches a rank). With two cards or more the 2048² run
   repeats with one rank per card over NCCL.

9. the 2-D tile probes (``csrc/tile.cu``): the probe path, the entry
   points ``swmhd_tpu_torch.probes.exp_dma``, ``exp_dma2`` and
   ``exp_fused2d`` with their default specs (the window probe bitwise
   equal to x + 1 for every spec that fits, the shared-memory refusal for
   exactly the specs over the card's opt-in limit; the wrap probe bitwise
   in all four cases; every default spec and case through the load
   probes' "tma" branch; the tile tendency at 2048² float32), and the
   load probes on inputs TMA cannot describe (UNALIGNED_SPECS, a base 4
   bytes off 16), which must take the "cp.async" branch (one block a
   tile) and be bitwise; then each load probe's spec and case through
   the "tma" branch at every P of ``ops.tile.LOAD_P`` the shape allows,
   through the "cp.async" branch and as the library call, bitwise against
   x + 1 and the plain version and timed in turns, the default plan and
   the library call also with a cold L2; the tile tendency over
   SWEEP_TILES × SWEEP_HALOS × every split at 2048² float32 (2e-5 of each
   field's scale, or no farther from the float64 G than twice the float32
   plain G) and at 256² float64 (1e-11), against its plain version, and
   bit for bit against the whole-grid ``swmhd_substage``'s G (the split's
   rows: the probe runs the substage kernel's phases); each
   entry point timed from a CUDA graph of its launches, beside its plain
   version and, for the load probes, the one PyTorch call that computes
   the same (``x_padded[HX:HX+N, HY:HY+N] + 1``). The kernels line has
   one entry a load-probe spec or case for its default plan and one for
   each "cp.async" launch of the probe path, timed on its own 64² input;
   a tile tendency entry also names its design (tile, shared memory,
   registers, blocks an SM), as a substage entry does.

10. the adaptive step, profiling and the movie: ``WIZARD``'s scenario
    (``128x128_two_Gaussians_high_B``) float64 through the kernel stepper
    with a ``TimeStepWizard`` every 5 of 20 steps from a Δt above its
    target CFL, vector-invariant and conservative without a series
    (a multistep call a chunk) and vector-invariant with the energy
    series (graph chunks), against the same runs through the plain stepper
    (the Δt after each adjustment within 1e-12 relative, at least two
    changes, the state within 1e-11 of the field scale; no plain call
    in the kernel runs; exactly 4 resident launches holding 60 substages
    without a series, 20 holding 60 with it, no one-substage launch); ``profiling.benchmark_step`` of the 2048²
    vector-invariant kernel stepper, 20 steps a call, whose step time
    must lie within 15% of phase 6's; in a process of its own (once
    another process has used the card, a process that traced before gets
    no kernel events in its later traces), ``profiling.trace`` of one
    2048² substage of each formulation, which must name the
    formulation's tile kernel, and of 10 steps of the 128² main path
    with the energy series (the second chunk of ten of a 20-step run, a
    replay of the chunk's CUDA graph), whose device-busy share it prints;
    then, on
    WORLD ranks of phase 8's 2048² configuration over gloo, each rank's
    ``profiling.measure_overlap`` of one decomposed step a formulation,
    with exchange and compute events, and the device time of each
    substage's tile launch beside the exchange time it covers; ``cli run
    64x64_two_Gaussians_high_B --stop-time 0.2 --movie`` where
    matplotlib imports (``energy_plot.png`` and a movie), else one line
    saying it does not.

11. the validation slice (``swmhd_tpu_torch.validate.run_case``, the
    stepper ``cli.select_stepper`` picks, the energies of
    ``diagnostics.reference_energy_report`` every step): each of the 12
    scenario × formulation cases in float64 for 200 steps through the
    kernel, its 201 rows within 1e-10 of the JAX package's float64 series
    ``validation/series/<tag>.csv``; then in float32 to their reference
    stop times ``conservative 64x64_two_Gaussians_high_B`` (1000 steps)
    and ``vector_invariant 128x128_low_B_low_U`` (1500 steps, walled in y,
    A gradient −0.05), which must pass the anchors of
    ``swmhd_tpu_torch/validation_anchors.py``; each run one resident
    launch a step holding three substages (graph replays), no one-substage
    launch and no plain call, one line a run with its wall time.

12. the resident kernel (``swmhd_multistep``, one cooperative launch for
    3·n substages) bit for bit against 3·n one-substage launches
    (``swmhd_substage``) in each formulation
    (128² and 2048² float32 periodic, ``128x128_low_B_low_U`` walled,
    float64 256² bounded in x and y), the 2048² vector-invariant model
    with a biharmonic closure and ``128x128_two_Gaussians_high_B`` with
    the CLI's biharmonic closure, each with its grid, blocks an SM, shared
    memory and registers, and its ms a step beside a CUDA graph of
    one-step resident launches, the loop of one-substage launches (with
    the host's cost, and as a CUDA graph) and the bound; then
    ``128x128_two_Gaussians_high_B`` in each formulation,
    GRAPH_CHUNK_STEPS steps, and the 2048² configuration, 10 steps, with
    the CLI's energy series through ``KernelStepper`` (graph replays: of
    resident launches at 128², of one-substage launches at 2048²) against
    the eager chunk (a step's launches, then the series), state and series
    bit for bit, each timed; then the energy series kernel
    (``ops.energies.energy_series``, one launch a state) against its plain
    version on ``128x128_two_Gaussians_high_B``, ``128x128_low_B_low_U``
    (walled in y, A gradient −0.05) and the 2048² configuration, each
    formulation, after 10 steps against the initial height (five values
    within SERIES_F32_TOL of the larger of each and the five's median),
    the kernel and the plain version each timed as a CUDA graph of
    SERIES_REPS calls beside the kernel's bound, 20 B a point over the
    card's device memory rate (``python3 chip_smoke.py --worker series .`` runs this alone).

13. the bench and the scaling sweep: ``python -m swmhd_tpu_torch.bench``
    in a process of its own with ``SWMHD_BENCH_LADDER=128,512``
    (BENCH_LADDER; the default ladder adds 4096² and 8192²), whose last
    line must carry ``bench.py``'s keys in its order (BENCH_KEYS), a
    positive value and fractions of the roofline in (0, 1.05], and whose
    size lines must show the resident kernel alone at 128² and 512² (one
    launch a call: 11) and exactly 3·steps·11 one-substage launches at
    2048², each state finite, and ``nonfinite`` empty; then, each on the
    bench configuration with h = 1 + 0.2·e^{-((x-1)²+y²)} (H_BUMP: with
    h = 1, or a bump at the vortex's centre, the h equation's G is ≈0
    and goes unchecked), K1's substage 0 at 8192²
    float32 (LARGE_N) against its plain version (G by PERF.md §2's rule
    against the float64 plain G, which must lie within 10% of the plain
    float32 G in every field; the state <= 2e-5), timed; K2 at 512²
    float32, 20 steps in one launch against the plain version's 20 steps
    (each field <= 2e-5) and bit for bit against 60 one-substage
    launches, counted; K3 on the two-rank sweep's 512² tiles (a 1x2 mesh
    of a 512x1024 grid), substages 0 and 1 against the plain tile
    version, float64 <= 1e-11 and float32 as K1; and ``python -m
    swmhd_tpu_torch.scaling --mode weak --local 512 --steps 10
    --max-ranks 2`` (one rank, then two ranks sharing the card over
    gloo, each a ``torchrun`` group), whose rows must hold finite
    points/s and rank 0's launches (7 resident launches; 210 tile
    substages), and whose models take the branches held above.

Phases 5 and 6's kernel runs are the main path of one process: the launch
counters are zeroed just before phase 5 and read just after the kernel
runs of phase 6. Phase 8's runs are the decomposed main path: each rank
zeroes its counters just before its run and reports them just after.
Phase 9's probe runs are the probe path: the tile counters are zeroed
just before them and read just after. Phase 10 zeroes the counters just
before its wizard runs through the kernels and reads them just after, and
phase 11 just before its validation runs. In phase 13 the bench zeroes
them just before each size's timed calls and prints them just after, and
each scaling worker just before its timed calls. Comparisons with the
plain versions, and phase 12's, happen outside those windows. The last
two lines are a JSON object of per-kernel findings (one entry per entry
point and branch, or probe shape, each with its bound: the larger of the
bytes it must move over the device memory rate and the plain version's
arithmetic, counted on the CPU, over the float32 rate outside the tensor
cores, both of CARD in ``profiling``'s tables: 3.35 TB/s, 67 TFLOP/s;
a substage entry also names its design: ``"tile"``, one kernel over 2-D
tiles, with its tile shape, shared memory bytes a block, registers a
thread and resident blocks an SM from the CUDA runtime) and the result
line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --worker dd <dir>               (under torchrun)
    python3 chip_smoke.py --worker trace <dir>            (under torchrun)
    python3 chip_smoke.py --worker overlap <dir>          (under torchrun)
    python3 chip_smoke.py --worker cli <dir> <name> <formulation> [flags]

run one rank of phase 8's runs, or of phase 10's traces and
``measure_overlap``, and write its report to ``<dir>``.

    python3 chip_smoke.py --worker time <root>

times the ``swmhd_tpu_torch`` under ``<root>`` (this checkout, or an
unpacked archive of another commit) at phase 6's and 7's shapes, each
formulation, float32, five rounds of each: the default model's 20-step
call of the kernel stepper at 2048² and of the resident entry point
(``multistep``) there, its substage there (a CUDA graph of 20), 20 tile
substages of 2048² in 2×2 tiles (with the host's cost and as a CUDA
graph), the biharmonic model's 20-step call;
``128x128_low_B_low_U``'s substage and one tile of its 4×1 mesh (100
calls, with the host's cost and as a CUDA graph), each formulation's
tile kernel's shared memory, registers and blocks an SM;
``128x128_two_Gaussians_high_B``'s 100-step multistep call (K2) and the
CLI's run loop with its energy series (a steady chunk of 100 steps,
``cli_chunk_ms``); then the tile
tendency probe at ``exp_fused2d``'s default specs at 2048² (a CUDA graph
of 20, and its kernel's design where the tree reports it); prints one
JSON line.
Run it for two trees in turns in one process group on one card to
compare them.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the cases the port's tests hold the kernels to, defined there
sys.path.append(os.path.join(HERE, "tests"))
from port_cases import (BOUNDED_XY, BOUNDED_Y, CONS, PERIODIC,  # noqa: E402
                        TILE_HALO, VI, bench_model, branch_cases, cut_tile,
                        rel_err, tile_layout, wall_model, with_options)

BENCH_N = 2048
SMOKE_N = 256
F64_BOUND = 1e-11
F32_BOUND = 2e-5          # tests/test_fused.py's f32 kernel-vs-XLA bound
TILE_F64_BOUND = 1e-12
WALL_ROWS = 4
BENCH_DT, DD_STEPS = 0.001, 20
WORLD = 4
# the card whose device memory rate and fp32 rate outside the tensor cores
# (profiling.HBM_PEAK_GBPS, VPU_PEAK_GFLOPS) set the kernels' bounds
CARD = "h100sxm"

# the closures of the CLI runs, ν·dt/dx^p ≈ 0.003 (biharmonic) and
# 0.0016 (Laplacian) at 128², dt = 0.01
CLOSURE_FLAGS = {VI: ("--nu", "1e-5", "--kappa", "1e-5", "--biharmonic"),
                 CONS: ("--nu", "1e-3", "--kappa", "1e-3")}
# the CLI runs of the main path: (scenario, formulation, flags); the
# decomposed runs of phase 8 take 128x128_low_B_low_U in both
# formulations and with the vector-invariant closure
CLI_RUNS = [("128x128_two_Gaussians_high_B", VI, ()),
            ("128x128_low_B_low_U", VI, ()),
            ("128x128_two_Gaussians_high_B", CONS, ()),
            ("128x128_low_B_low_U", CONS, ()),
            ("128x128_two_Gaussians_high_B", VI, CLOSURE_FLAGS[VI]),
            ("128x128_low_B_low_U", CONS, CLOSURE_FLAGS[CONS])]
# the scheme and stencil switches on the main path: 128x128_low_B_low_U
# through the kernel stepper in phase 6 (the conservative formulation has
# no mass reconstruction and no vorticity flux)
SCHEME_RUNS = [
    (VI, {"momentum_advection": "upwind3", "mass_advection": "upwind3",
          "tracer_advection": "centered2"}),
    (VI, {"momentum_advection": "centered2"}),
    (VI, {"vector_invariant_stencil": "vorticity",
          "mass_advection": "centered2", "tracer_advection": "upwind3"}),
    (CONS, {"momentum_advection": "upwind3",
            "tracer_advection": "centered2"}),
    (CONS, {"momentum_advection": "centered2",
            "tracer_advection": "upwind3"})]
SOURCES = {VI: "swmhd_tpu_torch/csrc/vi_tile.cuh",
           CONS: "swmhd_tpu_torch/csrc/cons_tile.cuh"}
# the tile kernel each formulation's substage launches
TILE_KERNELS = {VI: "vi_substage", CONS: "cons_substage"}
REPLACES = {"swmhd_substage": "swmhd_tpu/ops/fused_step.py:176",
            "swmhd_multistep": "swmhd_tpu/ops/fused_step.py:458"}
# swmhd_substage's branches with an exchanged axis: the tile substage
TILE_REPLACES = "swmhd_tpu/parallel/decomposition.py:299"


def ptxas_kernels(log):
    """``[(kernel, registers, spill store bytes)]`` from the log of
    ``ptxas -v``, the kernels' names demangled where ``c++filt`` exists
    and cut to ``name<type, mode_x, mode_y[, ...]>``."""
    import re
    found, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name, spill = m.group(1), 0
        elif "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif "Used" in ln and "registers" in ln and name:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            found.append((name, regs, spill))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            n for n, _, _ in found), capture_output=True, text=True,
            timeout=60).stdout.split("\n")
    except OSError:
        names = [n for n, _, _ in found]
    short = []
    for n in names[:len(found)]:
        n = n.replace("(swmhd::Axis)", "")
        short.append((n.split(">(")[0] + ">" if ">(" in n else n)
                     .split("::")[-1].replace(" ", ""))
    return [(n, r, sp) for n, (_, r, sp) in zip(short, found)]


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


def compare_branch(K, dev, cfg, dtype, bound, options=None, dt=0.005):
    """Phase 3 for one configuration with ``options`` (an entry of
    OPTIONS or None)."""
    import torch
    formulation, topology, gamma = cfg
    make = wall_model if "bounded" in topology else bench_model
    model, state = make(SMOKE_N, dtype, dev, *cfg)
    model = with_options(model, options, dt)
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
    label = (f"{formulation} {'/'.join(topology)} gamma {gamma:g}"
             + (f", {options}" if options else ""))
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


def cli_closure(flags):
    """The closure ``swmhd_tpu_torch.cli`` builds from ``flags`` (--nu,
    --kappa, --biharmonic)."""
    import argparse
    from swmhd_tpu_torch import cli
    p = argparse.ArgumentParser()
    p.add_argument("--nu", type=float, default=0.0)
    p.add_argument("--kappa", type=float, default=0.0)
    p.add_argument("--biharmonic", action="store_true")
    return cli.closure_of(p.parse_args(list(flags)))


def scenario_case(name, formulation, device, **kw):
    """``build(dtype)`` for :func:`compare_main_size`: the scenario's model
    with the keywords ``kw``, its stacked initial state and its dt."""
    def build(dtype):
        from swmhd_tpu_torch import scenarios
        from swmhd_tpu_torch.ops.substage import stack
        model, state, sc = scenarios.build(name, formulation, dtype=dtype,
                                           device=device, **kw)
        return model, stack(state), sc.dt
    return build


def compare_main_size(K, label, build):
    """The kernel against the plain version at a size the main path runs,
    for the model, stacked state and dt that ``build(dtype)`` gives: G of
    one substage and 10 RK3 steps, float64 within F64_BOUND and float32
    within F32_BOUND of the plain result's scale, the rows next to each
    wall printed on their own. With a closure, how far it moves the plain
    G is printed beside the bound; in float64 it must exceed 100 ×
    F64_BOUND, so that a kernel that left out ν or κ would fail. Returns
    the float32 max abs errors of G and of the 10-step state."""
    import dataclasses
    import torch
    for dtype, bound in ((torch.float64, F64_BOUND),
                         (torch.float32, F32_BOUND)):
        model, s, dt = build(dtype)
        G_k = K.substage(model, s, dt, 0)[1]
        G_p = K.substage_reference(model, s, dt, 0)[1]
        x10 = K.multistep(model, s, dt, 10)
        y10 = K.multistep_reference(model, s, dt, 10)
        topology = (model.grid.topology_x, model.grid.topology_y)
        g_scale, scale = float(G_p.abs().max()), float(y10.abs().max())
        g_err, err = rel_err(G_k, G_p, g_scale), rel_err(x10, y10, scale)
        line = f"G rel err {g_err:.2e}; 10 steps {err:.2e}"
        if "bounded" in topology:
            line += (f"; next to walls: G "
                     f"{wall_errors(G_k, G_p, g_scale, topology)}; 10 steps "
                     f"{wall_errors(x10, y10, scale, topology)}")
        if model.closure is not None:
            G_0 = K.substage_reference(dataclasses.replace(
                model, closure=None), s, dt, 0)[1]
            moved = rel_err(G_p, G_0, g_scale)
            line += f"; the closure moves G by {moved:.2e}"
            if dtype == torch.float64 and not moved > 100 * bound:
                fail(f"{label}: the closure moves G by only {moved:.3e}, "
                     f"too little for the bound {bound:g} to see it")
        say(6, f"{label} {dtype} kernel vs plain: {line}; bound {bound:g}")
        if not (torch.isfinite(x10).all() and max(g_err, err) <= bound):
            fail(f"kernel disagrees with the plain version, {label}, "
                 f"{dtype}: {max(g_err, err):.3e} > {bound:g}")
    return float((G_k - G_p).abs().max()), float((x10 - y10).abs().max())


# -- bounds ----------------------------------------------------------------------

def ops_per_point(K, branch, per):
    """Arithmetic per grid point of the plain version of one substage 0
    (``per="substage"``) or one RK3 step (``per="step"``) of ``branch``
    (a ``K.Branch``; an exchanged axis counts as periodic), float32,
    counted on the CPU at 64² (``profiling.count_ops``)."""
    import dataclasses
    import torch
    from swmhd_tpu_torch.profiling import count_ops
    b = K.Branch(*branch)
    topology = tuple("bounded" if m == K.BOUNDED_AXIS else "periodic"
                     for m in (b.mode_x, b.mode_y))
    gamma = -0.05 if "bounded" in topology else 0.0
    model, state = bench_model(64, torch.float32, "cpu",
                               CONS if b.conservative else VI, topology,
                               gamma)
    model = dataclasses.replace(
        model, vector_invariant_stencil=K.STENCILS[b.stencil],
        closure=(K.CLOSURES[b.closure](nu=1e-5, kappa=1e-5) if b.closure
                 else None),
        **{f"{name}_advection": K.SCHEMES[getattr(b, name)]
           for name in ("momentum", "mass", "tracer")})
    s = K.stack(state)
    if per == "step":
        n = count_ops(lambda: K.multistep_reference(model, s, BENCH_DT, 1))
    else:
        n = count_ops(lambda: K.substage_reference(model, s, BENCH_DT, 0))
    return n / 64 ** 2


def peak_rates():
    """``(bytes/s, float32 operations/s)`` of CARD."""
    from swmhd_tpu_torch import profiling
    return (profiling.HBM_PEAK_GBPS[CARD] * 1e9,
            profiling.VPU_PEAK_GFLOPS[CARD] * 1e9)


def least_time(nbytes, ops):
    """(ms, "bytes" | "operations"): the least time of the card for work
    that moves ``nbytes`` and does ``ops`` float32 operations."""
    peak_bytes, peak_ops = peak_rates()
    t_bytes, t_ops = nbytes / peak_bytes * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- tiles ---------------------------------------------------------------------------

def tile_branch(K, model, mesh):
    """The kernel branch of ``model``'s tiles in ``mesh``: exchanged along
    each axis that is cut."""
    p = K.kernel_params(model)
    return p.branch._replace(
        mode_x=K.EXCHANGED_AXIS if mesh[0] > 1 else p.wall_x,
        mode_y=K.EXCHANGED_AXIS if mesh[1] > 1 else p.wall_y)


def tile_against_substage(K, model, s, dt, mesh, halo=TILE_HALO):
    """The tile substage on every tile of ``mesh`` (padded by ``halo``)
    against the substage on the whole grid, substages 0 and 1 (taking
    G_prev): the worst error relative to each compared array's scale, and
    whether every value agreed bit for bit."""
    import torch
    s1, g1 = K.substage(model, s, dt, 0)
    s2, g2 = K.substage(model, s1, dt, 1, g1)
    tiles, halo = tile_layout(model.grid.Nx, model.grid.Ny, mesh, halo)
    worst, bitwise = 0.0, True
    for x0, x1, y0, y1 in tiles:
        b = (x0, x1, y0, y1)
        t1, h1 = K.substage(model, cut_tile(s, b, *halo), dt, 0,
                            halo=halo)
        t2, h2 = K.substage(model, cut_tile(s1, b, *halo), dt, 1,
                            g1[:, x0:x1, y0:y1].contiguous(), halo=halo)
        for got, want in ((t1, s1), (h1, g1), (t2, s2), (h2, g2)):
            w = want[:, x0:x1, y0:y1]
            worst = max(worst, rel_err(got, w, float(want.abs().max())))
            bitwise &= bool(torch.equal(got, w))
    return worst, bitwise


def tile_pair(K, model, p, dt, halo, plain0=None):
    """The tile substage on the padded tile ``p`` and its plain version,
    substage 0 (whose plain result ``plain0 = (s_new, G)`` the caller may
    have) and substage 1 taking each side's own G: ``((G, s1, s2) of the
    kernel, (G, s1, s2) of the plain version)``."""
    r1, g_p = plain0 or K.substage_reference(model, p, dt, 0, None, halo)
    s1, g_k = K.substage(model, p, dt, 0, halo=halo)
    s2, _ = K.substage(model, p, dt, 1, g_k, halo=halo)
    r2, _ = K.substage_reference(model, p, dt, 1, g_p, halo)
    return (g_k, s1, s2), (g_p, r1, r2)


def finite(arrays):
    import torch
    return all(bool(torch.isfinite(a).all()) for a in arrays)


# -- several ranks -------------------------------------------------------------------

def run_checked(cmd, env=None, timeout=600, stderr=subprocess.STDOUT):
    """``cmd`` from this checkout through the package's
    ``multihost.run_checked`` (a process group of its own, killed whole on
    a timeout); its standard output. Fails on a timeout or a nonzero
    exit."""
    from swmhd_tpu_torch.parallel import multihost
    try:
        return multihost.run_checked(cmd, env, timeout, HERE, stderr)
    except RuntimeError as e:
        fail(str(e))


def torchrun(nproc, args, timeout=600):
    """``python -m torch.distributed.run --standalone`` of this script's
    worker mode on ``nproc`` ranks; its output (:func:`run_checked`)."""
    # "--" ends the launcher's own options: without it an argument such
    # as --nu is read as an abbreviation of one of them
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "--", os.path.abspath(__file__),
           "--worker", *args]
    return run_checked(cmd, {"OMP_NUM_THREADS": "1"}, timeout)


def tile_launches(K):
    """``swmhd_substage``'s launches on tiles (a branch with an exchanged
    axis), by branch as JSON keys."""
    return {json.dumps(b): n for b, n in K.substage.launches_by_branch.items()
            if K.EXCHANGED_AXIS in b[1:3]}


def other_calls(K):
    """What ran that is not a tile launch: one-substage launches on whole
    grids, resident launches and the substages they hold, plain calls."""
    return (K.substage.launches - sum(tile_launches(K).values())
            + K.multistep.launches + K.multistep.substages
            + K.substage_reference.calls + K.multistep_reference.calls)


def resident_counts(K, before=None):
    """The resident kernel's launches and substages held by branch, and
    the one-substage launches: a snapshot, or with ``before`` (a snapshot)
    ``({branch: (launches, substages)}, one-substage launches)`` since
    it, branches without a launch left out."""
    now = (dict(K.multistep.launches_by_branch),
           dict(K.multistep.substages_by_branch), K.substage.launches)
    if before is None:
        return now
    return ({b: (n - before[0].get(b, 0), now[1][b] - before[1].get(b, 0))
             for b, n in now[0].items() if n != before[0].get(b, 0)},
            now[2] - before[2])


def cli_chunk_ms(K, model, state, dt, steps=100):
    """ms a step of the CLI's run loop through the kernel stepper with the
    CLI's energy series (the tree's own: ``cli.energies`` where it has
    one, else the five names of ``diagnostics.energy_report``): the
    second chunk of ``steps`` of a run of twice as many, by the host's
    clock from the callback after the first chunk to the one after the
    second, each after the chunk's series reached the host."""
    from swmhd_tpu_torch import cli, diagnostics
    from swmhd_tpu_torch.io import ScalarSeriesWriter
    from swmhd_tpu_torch.simulation import (Callback, IterationInterval,
                                            Simulation)
    h0 = state.h.clone()
    if hasattr(cli, "energies"):
        def series(m, st):
            return cli.energies(m, st, h0)
    else:
        def series(m, st):
            rep = diagnostics.energy_report(m, st, h0)
            return {k: rep[k] for k in ENERGY_NAMES}
    stamps = {}
    sim = Simulation(model, dt=dt, stop_iteration=2 * steps,
                     stepper=K.KernelStepper(model))
    sim.callbacks["clock"] = Callback(
        lambda s: stamps.setdefault(s.state.clock.iteration,
                                    time.perf_counter()),
        IterationInterval(steps))
    with tempfile.TemporaryDirectory() as tmp:
        sim.output_writers["energies"] = ScalarSeriesWriter(
            fn=series, schedule=IterationInterval(1),
            path=os.path.join(tmp, "energies.csv"))
        sim.run(state)
    return (stamps[2 * steps] - stamps[steps]) * 1e3 / steps


def time_default(K, root):
    """The ``--worker time`` report of the package under ``root``."""
    import torch
    from swmhd_tpu_torch import scenarios
    from swmhd_tpu_torch.ops import _build
    lib = _build.load()
    report = {"root": root, "build_s": lib.build_seconds,
              "ptxas": ptxas_kernels(lib.log)}
    for formulation in (VI, CONS):
        model, state = bench_model(BENCH_N, torch.float32, "cuda",
                                   formulation)
        run20 = K.KernelStepper(model).step_fn(BENCH_DT, DD_STEPS)
        run20(state)
        report[f"multistep_{formulation}_ms_step"] = [
            timed(lambda: run20(state), 1)[0] / DD_STEPS for _ in range(5)]
        s = K.stack(state)
        # the resident entry point itself (a launch loop in trees before
        # the resident kernel), whichever route the stepper takes here
        K.multistep(model, s, BENCH_DT, 1)
        report[f"resident_{formulation}_ms_step"] = [
            timed(lambda: K.multistep(model, s, BENCH_DT, DD_STEPS),
                  1)[0] / DD_STEPS for _ in range(5)]
        report[f"substage_{formulation}_ms"] = [
            graph_timed(lambda: K.substage(model, s, BENCH_DT, 0), 20)
            for _ in range(5)]
        tiles, halo = tile_layout(BENCH_N, BENCH_N, (2, 2))
        p = cut_tile(s, tiles[0], *halo)
        K.substage(model, p, BENCH_DT, 0, halo=halo)
        report[f"tile_{formulation}_ms"] = [
            timed(lambda: K.substage(model, p, BENCH_DT, 0, halo=halo),
                  20)[0] for _ in range(5)]
        report[f"tile_{formulation}_graph_ms"] = [
            graph_timed(lambda: K.substage(model, p, BENCH_DT, 0,
                                           halo=halo), 20)
            for _ in range(5)]
        # the biharmonic step (with a series for the warm-up, as phase 6)
        bih = with_options(model, "biharmonic", BENCH_DT)
        stepper = K.KernelStepper(bih)
        stepper.step_fn(BENCH_DT, 1, lambda st: {"mass": st.h.sum()})(state)
        run20 = stepper.step_fn(BENCH_DT, DD_STEPS)
        report[f"multistep_{formulation}_biharmonic_ms_step"] = [
            timed(lambda: run20(state), 1)[0] / DD_STEPS for _ in range(5)]
        del s, p, state
        # 128x128_low_B_low_U (walls in y): the substage, and one tile of
        # the decomposed CLI run's 4x1 mesh; host-inclusive (CUDA events
        # around the calls) and device time (a CUDA graph of the calls)
        model, state, sc = scenarios.build("128x128_low_B_low_U",
                                           formulation, dtype=torch.float32,
                                           device="cuda")
        s = K.stack(state)
        tiles, halo = tile_layout(128, 128, (4, 1), model.exchange_halo)
        p = cut_tile(s, tiles[0], *halo)
        for name, fn in (
                ("walled128", lambda: K.substage(model, s, sc.dt, 0)),
                ("tile128", lambda: K.substage(model, p, sc.dt, 0,
                                               halo=halo))):
            fn()
            report[f"{name}_{formulation}_ms"] = [
                timed(fn, 100)[0] for _ in range(5)]
            report[f"{name}_{formulation}_graph_ms"] = [
                graph_timed(fn, 100) for _ in range(5)]
        report[f"design_{formulation}"] = K.tile_info(
            torch.float32, K.Branch(int(formulation == CONS), 0, 0), 32)
        # the 128² main path: K2 alone (100 steps a call), and the CLI's
        # run loop with its energy series, the second chunk of 100 of a
        # 200-step run (host clock around it, its series' host copy and
        # rows included)
        model, state, sc = scenarios.build("128x128_two_Gaussians_high_B",
                                           formulation, dtype=torch.float32,
                                           device="cuda")
        s = K.stack(state)
        K.multistep(model, s, sc.dt, 100)
        report[f"multistep128_{formulation}_ms_step"] = [
            timed(lambda: K.multistep(model, s, sc.dt, 100), 1)[0] / 100
            for _ in range(5)]
        report[f"cli128_{formulation}_ms_step"] = [
            cli_chunk_ms(K, model, state, sc.dt) for _ in range(5)]
    # the tile tendency probe at its default specs, 2048² f32 (a CUDA
    # graph of 20); its design where the tree reports it
    from swmhd_tpu_torch.ops import tile as T
    from swmhd_tpu_torch.probes import build, exp_fused2d
    model, st = build(BENCH_N, torch.float32, "cuda")
    s = torch.stack(st.fields())
    for spec in exp_fused2d.DEFAULT_SPECS.split(";"):
        TX, TY, H, split = spec.split(",")
        tile, halo = (int(TX), int(TY)), int(H)
        fn = lambda: T.tendency_tiles(model, s, tile, halo, split)  # noqa
        fn()
        report[f"tendency_{spec}_ms"] = [graph_timed(fn, 20)
                                         for _ in range(5)]
        if hasattr(T, "tendency_tile_info"):
            report[f"tendency_{spec}_design"] = T.tendency_tile_info(
                torch.float32, tile, halo, split)
    print(json.dumps(report), flush=True)


def design(K, branch, shape, resident=False):
    """The kernels-line fields of a substage branch's design, one kernel
    over 2-D tiles: its tile shape on ``shape`` (the wrapper's rule on
    card 0, float32), shared memory bytes a block, registers a thread and
    resident blocks an SM from the CUDA runtime; for the ``resident``
    kernel (``swmhd_multistep``) those of its own instantiation and its
    grid, the blocks that walk the tiles."""
    import torch
    b = K.Branch(*branch)
    tile = K.tile_shape(CONS if b.conservative else VI, *shape,
                        torch.float32, b.closure == 2, *K.card_limits(0))
    if resident:
        smem, regs, blocks, grid = K.resident_info(
            torch.float32, b, tile[0], K.resident_tiles(*shape, tile[0]),
            K.card_limits(0)[1])
        return {"design": "resident", "tile": list(tile),
                "smem_bytes": smem, "registers": regs,
                "blocks_per_sm": blocks, "grid": grid}
    smem, regs, blocks = K.tile_info(torch.float32, b, tile[0])
    return {"design": "tile", "tile": list(tile), "smem_bytes": smem,
            "registers": regs, "blocks_per_sm": blocks}


def cuda_kernels_of(fn):
    """Names of the CUDA kernels that one call of ``fn`` launched, from a
    torch.profiler trace of it (after a call outside the trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def profile_substages(K, dev, smi):
    """One substage of each formulation on the whole 2048² grid and one on
    a tile of its 2×2 mesh under torch.profiler: each must have launched
    exactly one CUDA kernel, its formulation's tile kernel."""
    import torch
    for formulation in (VI, CONS):
        model, state = bench_model(BENCH_N, torch.float32, dev, formulation)
        s = K.stack(state)
        tiles, halo = tile_layout(BENCH_N, BENCH_N, (2, 2))
        p = cut_tile(s, tiles[0], *halo)
        for label, fn in (
                ("whole grid", lambda: K.substage(model, s, BENCH_DT, 0)),
                ("tile", lambda: K.substage(model, p, BENCH_DT, 0,
                                            halo=halo))):
            names = cuda_kernels_of(fn)
            say("profile", f"{formulation} substage, {label}, on {smi}: "
                f"{len(names)} CUDA kernel(s): "
                + "; ".join(n.split(">(")[0] + ">" if ">(" in n else n
                            for n in names))
            if len(names) != 1 or TILE_KERNELS[formulation] not in names[0]:
                fail(f"the {formulation} substage ({label}) launched "
                     f"{names}, not the one tile kernel "
                     f"{TILE_KERNELS[formulation]}")
        del s, p, state


def worker(args):
    """One rank of phase 8, or the timing of ``--worker time`` (see the
    module's docstring)."""
    import torch
    import numpy as np
    task, outdir = args[0], args[1]
    sys.path.insert(0, os.path.abspath(outdir) if task == "time" else HERE)
    from swmhd_tpu_torch.ops import substage as K
    if task == "time":
        return time_default(K, outdir)
    if task == "series":
        return series_phase(torch.device("cuda", 0), command_output(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]))
    rank = int(os.environ["RANK"])
    report = {}
    if task == "trace":
        report = traces(K, torch.device("cuda", 0))
    elif task == "overlap":
        from swmhd_tpu_torch import profiling
        from swmhd_tpu_torch.parallel import multihost
        from swmhd_tpu_torch.parallel.decomposition import (
            DomainDecomposition)
        dev = multihost.initialize("cuda")
        for formulation in (VI, CONS):
            model, state = bench_model(BENCH_N, torch.float32, dev,
                                       formulation)
            dd = DomainDecomposition(model)
            report[formulation] = profiling.measure_overlap(
                dd.fused_step_fn(BENCH_DT, 1), dd.shard_state(state),
                kernel=first_launch_of(K, dd, formulation))
        multihost.shutdown()
    elif task == "cli":
        from swmhd_tpu_torch import cli
        name, formulation, flags = args[2], args[3], args[4:]
        K.reset_counters()
        t0 = time.perf_counter()
        cli.main(["run", "128x128_low_B_low_U", "--formulation",
                  formulation, "--stop-time", "1.0", "--outdir",
                  os.path.join(outdir, name), *flags])
        report = {"wall_s": time.perf_counter() - t0,
                  "launches": tile_launches(K),
                  "other_calls": other_calls(K)}
    else:
        import torch.distributed as dist
        from swmhd_tpu_torch.parallel import multihost
        from swmhd_tpu_torch.parallel.decomposition import (
            DomainDecomposition)
        dev = multihost.initialize("cuda")
        report["backend"] = dist.get_backend()
        for formulation in (VI, CONS):
            model, state = bench_model(BENCH_N, torch.float32, dev,
                                       formulation)
            dd = DomainDecomposition(model)
            tile = dd.shard_state(state)
            dd.fused_step_fn(BENCH_DT, 1)(tile)                # warm-up
            run = dd.fused_step_fn(BENCH_DT, DD_STEPS)
            torch.cuda.synchronize()
            multihost.sync()
            K.reset_counters()
            t0 = time.perf_counter()
            out = run(tile)
            torch.cuda.synchronize()
            multihost.sync()
            wall = time.perf_counter() - t0
            launches, other = tile_launches(K), other_calls(K)
            # outside the counted window: one substage's exchange, and the
            # host's time to issue one step (without waiting for the card
            # at its end)
            s = K.stack(tile)
            ex_ms, _ = timed(lambda: dd.pad_for_kernel(s), 20)
            one = dd.fused_step_fn(BENCH_DT, 1)
            torch.cuda.synchronize()
            multihost.sync()
            t0 = time.perf_counter()
            one(tile)
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            glob = K.stack(dd.gather_state(out)).cpu().numpy()
            if rank == 0:
                np.save(os.path.join(outdir, f"dd_{formulation}.npy"), glob)
            report[formulation] = {
                "ms_step": wall * 1e3 / DD_STEPS, "exchange_ms": ex_ms,
                "host_ms": host_ms, "launches": launches,
                "other_calls": other, "mesh": [dd.px, dd.py]}
        multihost.shutdown()
    label = args[2] if task == "cli" else task
    with open(os.path.join(outdir, f"{label}_rank{rank}.json"), "w") as f:
        json.dump(report, f)


def first_launch_of(K, dd, formulation):
    """A predicate on a trace's kernel events: the tile launch of each
    substage of ``dd``'s kernel step on the padded tile, known by its grid
    (the wrapper's tiles over its output)."""
    import torch
    tx = K.tile_shape(formulation, dd.nx, dd.ny, torch.float32, False,
                      *K.card_limits(torch.cuda.current_device()))[0]
    grid = [math.ceil(dd.ny / K.TILE_Y), math.ceil(dd.nx / tx), 1]
    return lambda e: (TILE_KERNELS[formulation] in e.get("name", "")
                      and e.get("args", {}).get("grid") == grid)


def decomposed_bench(K, nproc, tmp, smi, tile_launches, backend="gloo"):
    """Phase 8's 2048² runs on ``nproc`` ranks, each formulation, held
    against DD_STEPS single-device multistep steps; their launches go into
    ``tile_launches`` (by branch)."""
    import torch
    import numpy as np
    os.makedirs(tmp, exist_ok=True)
    torchrun(nproc, ["dd", tmp])
    reps = []
    for r in range(nproc):
        with open(os.path.join(tmp, f"dd_rank{r}.json")) as f:
            reps.append(json.load(f))
    if reps[0]["backend"] != backend:
        fail(f"{nproc} ranks chose backend {reps[0]['backend']}, expected "
             f"{backend}")
    for formulation in (VI, CONS):
        model, state = bench_model(BENCH_N, torch.float32, "cuda",
                                   formulation)
        want = K.multistep(model, K.stack(state), BENCH_DT, DD_STEPS).cpu()
        del state
        got = torch.from_numpy(np.load(os.path.join(
            tmp, f"dd_{formulation}.npy")))
        err = rel_err(got, want)
        per = [r[formulation] for r in reps]
        counts, per_rank = {}, []
        for r in per:
            if r["other_calls"]:
                fail(f"a rank ran {r['other_calls']} launches or plain "
                     f"calls other than tile launches on the decomposed "
                     f"path")
            per_rank.append(sum(r["launches"].values()))
            for k, n in r["launches"].items():
                b = tuple(json.loads(k))
                counts[b] = counts.get(b, 0) + n
                tile_launches[b] = tile_launches.get(b, 0) + n
        px, py = per[0]["mesh"]
        # a substage is one tile launch
        if per_rank != [3 * DD_STEPS] * nproc:
            fail(f"expected {3 * DD_STEPS} tile launches a rank (3 a "
                 f"step); got {per_rank}")
        ms_step = max(r["ms_step"] for r in per)
        steps_ms = ", ".join(f"{r['ms_step']:.4f}" for r in per)
        exchange_ms = ", ".join(f"{r['exchange_ms']:.4f}" for r in per)
        host_ms = ", ".join(f"{r['host_ms']:.4f}" for r in per)
        labels = {K.branch_label(b): n for b, n in counts.items()}
        say(8, f"{nproc} ranks over {backend}, {px}x{py} mesh, bench "
               f"{BENCH_N}^2 f32 {formulation}, {DD_STEPS} steps through "
               f"dd.fused_stepper on {smi}: {ms_step:.4f} ms/step "
               f"(slowest rank; ranks {steps_ms}) = "
               f"{BENCH_N ** 2 / (ms_step * 1e-3):.4e} points/s; the "
               f"host's time to issue one step (ranks) {host_ms} ms; "
               f"halo exchange of one substage (ranks) {exchange_ms} "
               f"ms; tile launches {json.dumps(labels)}, a rank "
               f"{per_rank[0]}; vs {DD_STEPS} single-device multistep "
               f"steps: rel err {err:.2e}, bitwise equal "
               f"{bool(torch.equal(got, want))}; bound {F32_BOUND:g}")
        if not (torch.isfinite(got).all() and err <= F32_BOUND):
            fail(f"decomposed 2048^2 run disagrees ({formulation}, "
                 f"{backend}): {err:.3e}")


def decomposed_cli(K, cli, formulation, tmp, tile_launches, flags=()):
    """Phase 8's decomposed CLI run of 128x128_low_B_low_U on WORLD ranks
    with ``flags``, held against the single-rank run."""
    import numpy as np
    name = f"cli_{formulation}" + ("_closure" if flags else "")
    torchrun(WORLD, ["cli", tmp, name, formulation, *flags])
    reps = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"{name}_rank{r}.json")) as f:
            reps.append(json.load(f))
    per_rank = []
    for r in reps:
        if r["other_calls"]:
            fail(f"a rank ran {r['other_calls']} launches or plain calls "
                 f"other than tile launches in the decomposed CLI run")
        per_rank.append(sum(r["launches"].values()))
        for k, n in r["launches"].items():
            b = tuple(json.loads(k))
            tile_launches[b] = tile_launches.get(b, 0) + n
    one = os.path.join(tmp, f"one_{name}")
    cli.main(["run", "128x128_low_B_low_U", "--formulation", formulation,
              "--stop-time", "1.0", "--outdir", one, *flags])
    run = os.path.join(tmp, name)
    rows = np.loadtxt(os.path.join(run, "energies.csv"), delimiter=",",
                      skiprows=1, ndmin=2)
    rows1 = np.loadtxt(os.path.join(one, "energies.csv"), delimiter=",",
                       skiprows=1, ndmin=2)
    with np.load(os.path.join(run, "final.npz")) as x, \
            np.load(os.path.join(one, "final.npz")) as y:
        scale = max(float(np.abs(y[k]).max()) for k in "huvA")
        err = max(float(np.abs(x[k] - y[k]).max()) for k in "huvA") / scale
    e_err = (float(np.abs(rows[:, 2:] - rows1[:, 2:]).max())
             / float(np.abs(rows1[:, 2:]).max())) if rows.shape == \
        rows1.shape else math.inf
    wall = max(r["wall_s"] for r in reps)
    say(8, f"{WORLD} ranks: cli run 128x128_low_B_low_U {formulation} "
           f"{' '.join(flags)} t=1.0 on a 4x1 mesh: {wall:.2f} s wall "
           f"(slowest rank, process "
           f"group set-up included), {len(rows)} energy rows, finite "
           f"{bool(np.isfinite(rows).all())}; final.npz vs the single-rank "
           f"run: rel err {err:.2e}; energies rel err {e_err:.2e}; tile "
           f"launches per rank {per_rank}")
    if not (len(rows) == 101 and np.isfinite(rows).all()):
        fail(f"the decomposed CLI run ({formulation}) did not write 101 "
             f"finite energy rows")
    if not (err <= F32_BOUND and e_err <= F32_BOUND):
        fail(f"the decomposed CLI run ({formulation}) disagrees with the "
             f"single-rank run: {max(err, e_err):.3e}")
    if per_rank != [300] * WORLD:
        fail(f"expected 300 tile launches a rank, got {per_rank}")


# -- phase 9: the 2-D tile probes --------------------------------------------

PROBE_REPLACES = {"swmhd_window_probe": "benchmarks/exp_dma.py:21",
                  "swmhd_wrap_probe": "benchmarks/exp_dma2.py:22",
                  "swmhd_tendency_tile": "benchmarks/exp_fused2d.py:72"}
PROBE_SOURCES = {"swmhd_window_probe": "swmhd_tpu_torch/csrc/tile.cu",
                 "swmhd_wrap_probe": "swmhd_tpu_torch/csrc/tile.cu",
                 "swmhd_tendency_tile":
                 "swmhd_tpu_torch/csrc/tendency_tile.cuh"}
# the tile tendency's comparison sweep: tile shapes, halos (the least, 3,
# and the TPU probe's 8), each split; float32 at BENCH_N, float64 at
# SMOKE_N
SWEEP_TILES, SWEEP_HALOS = ((32, 32), (16, 64), (64, 16)), (3, 8)
# window-probe specs at 64² whose 66-float rows TMA cannot describe: the
# cp.async branch on the probe path
UNALIGNED_SPECS = "32,32,8,1,1;32,32,8,1,0"


def graph_timed(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed, CUDA events: the device's time without the host's
    cost of each launch (a 1024² load probe runs for microseconds)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    return timed(graph.replay, 1)[0] / reps


def tendency_parts(model, st, split):
    """exp_fused2d.py's ``tendency_parts`` with the port's operators: the
    fields of G that ``split`` writes, computed without the others."""
    import torch
    from swmhd_tpu_torch import operators as op
    from swmhd_tpu_torch.advection import upwind_biased_product
    if split == "full":
        return model.tendencies(st).fields()
    g, (h, u, v, A) = model.grid, st.fields()
    if split == "mom":
        zeta = op.vorticity_ff(u, v, g)
        vu, vv = model._weno_vorticity_flux(u, v, zeta, g)
        KB = (op.kinetic_energy_cc(u, v, g)
              + model.gravitational_acceleration * h)
        Gu = vu - op.ddx_f(KB, g) + model.coriolis.tendency_u(v, g)
        Gv = vv - op.ddy_f(KB, g) + model.coriolis.tendency_v(u, g)
        zero = torch.zeros_like(h)
        return model._apply_forcing(st, Gu, Gv, zero, zero)[:2]
    ms = model.mass_advection
    Uf = upwind_biased_product(u, *ms.both_x_f(h, g))
    Vf = upwind_biased_product(v, *ms.both_y_f(h, g))
    divU = op.ddx_c_flux(Uf, g) + op.ddy_c_flux(Vf, g)
    return -divU, model._tracer_tendency(A, h, Uf, Vf, divU)


def split_ops_per_point(split):
    """Arithmetic per point of :func:`tendency_parts`, float32, counted on
    the CPU at 64²."""
    import torch
    from swmhd_tpu_torch.probes import build
    from swmhd_tpu_torch.profiling import count_ops
    model, st = build(64, torch.float32, "cpu")
    return count_ops(lambda: tendency_parts(model, st, split)) / 64 ** 2


def field_errors(a, b):
    """max |a - b| of each field (stacked) over max |b| of that field."""
    return [rel_err(x, y) for x, y in zip(a, b)]


def g_within(got, plain, g64, bound):
    """PERF.md §2's rule for G, field by field: ``got`` within ``bound``
    of the plain version's scale, or (float32 at 2048²) no farther from
    the float64 G than twice the float32 plain G."""
    near = field_errors(got, plain)
    if g64 is None:
        return max(near) <= bound, max(near)
    far, plain_far = field_errors(got, g64), field_errors(plain, g64)
    ok = all(e <= bound or f <= 2 * pf
             for e, f, pf in zip(near, far, plain_far))
    return ok, max(near)


def tile_sweep(T, K, N, dtype, bound, smi):
    """The tile tendency over SWEEP_TILES × SWEEP_HALOS × every split at
    N² against its plain version (in float32 also against the float64 G),
    and bit for bit against the whole-grid substage's G (the split's
    rows): the probe runs the substage kernel's phases. Returns
    ``{(TX, TY, halo, split): (max abs err vs plain, plain ms)}``."""
    import torch
    from swmhd_tpu_torch.models.state import State
    from swmhd_tpu_torch.probes import build
    model, st = build(N, dtype, "cuda")
    s = torch.stack(st.fields())
    G_sub = K.substage(model, s, BENCH_DT, 0)[1]
    g64 = None
    if dtype == torch.float32:
        model64, _ = build(N, torch.float64, "cuda")
        g64 = torch.stack(model64.tendencies(State(*s.double())).fields())
    found = {}
    for tile in SWEEP_TILES:
        for halo in SWEEP_HALOS:
            for split in T.SPLITS:
                rows = list(T.SPLIT_FIELDS[split])
                got = T.tendency_tiles(model, s, tile, halo, split)
                plain_ms, plain = timed(lambda: T.tendency_tiles_reference(
                    model, s, tile, halo, split), 1)
                ref64 = None if g64 is None else g64[rows]
                ok, err = g_within(got, plain, ref64, bound)
                line = (f"{N}^2 {dtype} tile {tile[0]}x{tile[1]} halo "
                        f"{halo} {split}: kernel vs plain rel err {err:.2e}")
                if ref64 is not None:
                    line += (f", from the f64 G kernel "
                             f"{max(field_errors(got, ref64)):.2e} / plain "
                             f"{max(field_errors(plain, ref64)):.2e}")
                bitwise = bool(torch.equal(got, G_sub[rows]))
                line += (f"; vs swmhd_substage's G "
                         f"{max(field_errors(got, G_sub[rows])):.2e}, "
                         f"bitwise {bitwise}")
                say(9, line + f"; bound {bound:g}")
                if not (finite([got]) and ok and bitwise):
                    fail(f"tile tendency disagrees: {line}")
                found[(*tile, halo, split)] = (
                    float((got - plain).abs().max()), plain_ms)
    return found


def off_16_bytes(t):
    """A contiguous copy of ``t`` whose base is 4 bytes past a 16-byte
    boundary: an input TMA cannot describe."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def cold_graph_timed(fn, scratch, reps=20):
    """Mean ms of ``fn`` with the L2 cache cold: a CUDA graph of ``reps``
    × (``scratch.zero_()``, ``fn()``) less one of ``reps`` ×
    ``scratch.zero_()`` alone; ``scratch`` (over twice the 50 MB L2)
    evicts ``fn``'s input between launches."""
    both = graph_timed(lambda: (scratch.zero_(), fn()), reps)
    return both - graph_timed(scratch.zero_, reps)


def load_runs(T, x, specs, wrap_input):
    """``(name, wrapper, key, rest, label, padded input, plain version)``
    of each window spec of ``specs`` and each wrap case on ``x``, the wrap
    probe's input ``wrap_input`` of ``x`` padded by WRAP_H rows."""
    runs = [("swmhd_window_probe", T.window_probe, spec[:4], spec[4:],
             f"{spec[0]}x{spec[1]}, halo {spec[2]}x{spec[3]}, "
             f"{T.LOADS[spec[4]]}", T.wrap_pad(x, *spec[2:4]).contiguous(),
             lambda xp, spec=spec: T.window_probe_reference(xp, *spec))
            for spec in specs]
    xp = wrap_input(T.wrap_pad(x, T.WRAP_H, 0).contiguous())
    runs += [("swmhd_wrap_probe", T.wrap_probe, case, (), case, xp,
              lambda xp, case=case: T.wrap_probe_reference(xp, case))
             for case in T.WRAP_CASES]
    return runs


def probe_calls(T, probe, key, rest, xp, plans):
    """One call a plan of ``plans``, and ``library``: the one PyTorch call
    that computes the same, ``x_padded[HX:HX+N, HY:HY+N] + 1``."""
    h, w = (T.WRAP_H, 0) if isinstance(key, str) else key[2:4]
    n, m = xp.shape[0] - 2 * h, xp.shape[1] - 2 * w
    calls = {k: (lambda plan=plan: call_probe(probe, xp, key, rest, plan))
             for k, plan in plans.items()}
    calls["library"] = lambda: xp[h:h + n, w:w + m] + 1.0
    return calls


def checked_in_turns(name, label, calls, reference, xp, x):
    """Each call of ``calls`` bitwise x + 1 and equal to the plain
    version, then timed from a CUDA graph of 50 in two rounds, the second
    in reverse order. Returns (plain ms, {call: [ms, ms]})."""
    import torch
    plain_ms, ref = timed(lambda: reference(xp), 3)
    for k, fn in calls.items():
        out = fn()
        if not (torch.equal(out, ref) and torch.equal(out, x + 1.0)):
            fail(f"{name} [{label}] {k} differs from x + 1 or from its "
                 f"plain version")
    order = list(calls)
    ms = {k: [] for k in order}
    for keys in (order, order[::-1]):
        for k in keys:
            ms[k].append(graph_timed(calls[k], 50))
    return plain_ms, ms


def mean_of(ms):
    return {k: sum(v) / len(v) for k, v in ms.items()}


def load_probe_entries(T, exp_dma, dma_specs, tma_launched, launched, entry,
                       smi):
    """Each load probe's default spec or case at 1024²: the "tma" kernel
    at every P of LOAD_P the shape allows, the "cp.async" kernel and the
    library call, each output bitwise x + 1 and equal to the plain
    version, timed in turns; the default plan and the library call also
    with a cold L2. One kernels entry a spec or case for the default plan,
    with its launches in ``tma_launched`` (by shape, the default specs'
    run, all through "tma"). Then each "cp.async" launch of the probe path
    (UNALIGNED_SPECS and the four cases on a base off 16 bytes, at 64²)
    timed on its own input beside the library call: one entry each, with
    its launches (``launched`` less ``tma_launched``). Bound: the bytes of
    the interior read and the output written."""
    import torch
    N = 1024
    x = exp_dma.ramp(N, "cuda")
    scratch = torch.empty(32 << 20, device="cuda")        # 128 MB
    specs = [s for s in dma_specs if tma_launched["window_probe"].get(s)]
    for name, probe, key, rest, label, xp, reference in load_runs(
            T, x, specs, lambda t: t):
        plans = {}
        for P in T.LOAD_P:
            try:        # every P the shape allows
                plan = T.load_plan(tuple(xp.shape), key, P)
            except ValueError:
                continue
            plans[plan_label(plan)] = plan
        plan = T.load_plan(tuple(xp.shape), key)
        default = plan_label(plan)
        plans["cp.async"] = T.load_plan(tuple(xp.shape), key,
                                        branch="cp.async")
        calls = probe_calls(T, probe, key, rest, xp, plans)
        plain_ms, ms = checked_in_turns(name, label, calls, reference, xp, x)
        mean = mean_of(ms)
        cold = {k: cold_graph_timed(calls[k], scratch)
                for k in (default, "library")}
        nbytes = 8 * N * N
        bound_ms, _ = least_time(nbytes, N * N)
        say(9, f"{name} [{label}] on {smi}, ms (CUDA graph of 50; rounds "
               f"1 / 2; tma P=p boxes a block x rows x columns): "
               + "; ".join(f"{k} {v[0]:.6f} / {v[1]:.6f}"
                           for k, v in ms.items())
               + f"; cold L2: {default} {cold[default]:.6f}, library "
               f"{cold['library']:.6f}; bound {bound_ms:.6f} (bytes); "
               f"default {default}; default x bound "
               f"{mean[default] / bound_ms:.3f}, x library "
               f"{mean[default] / mean['library']:.3f}, cp.async x bound "
               f"{mean['cp.async'] / bound_ms:.3f}; grid {plan.grid}")
        shape = key if isinstance(key, str) else (*key, *rest)
        entry(name, label, tma_launched[probe.__name__][shape], 0.0,
              mean[default], plain_ms, nbytes, N * N, mean["library"])
    n = 64
    x = exp_dma.ramp(n, "cuda")
    specs = [tuple(int(v) for v in s.split(","))
             for s in UNALIGNED_SPECS.split(";")]
    for name, probe, key, rest, label, xp, reference in load_runs(
            T, x, specs, off_16_bytes):
        plans = {"cp.async": T.load_plan(tuple(xp.shape), key,
                                         branch="cp.async")}
        calls = probe_calls(T, probe, key, rest, xp, plans)
        plain_ms, ms = checked_in_turns(name, label, calls, reference, xp, x)
        mean = mean_of(ms)
        shape = key if isinstance(key, str) else (*key, *rest)
        why = ("base off 16 B" if isinstance(key, str)
               else f"{xp.shape[1]}-float rows")
        entry(name, f"{label}, {n}^2, {why}, cp.async branch",
              launched[probe.__name__][shape]
              - tma_launched[probe.__name__].get(shape, 0), 0.0,
              mean["cp.async"], plain_ms, 8 * n * n, n * n, mean["library"])


def plan_label(plan):
    """'tma P=p n x rows x columns' of a "tma" load plan."""
    return (f"tma P={plan.p} {plan.nr * plan.kc}x{plan.box[0]}x"
            f"{plan.box[1]}")


def call_probe(probe, xp, key, rest, plan):
    """One launch of a load probe's wrapper with ``plan``."""
    if isinstance(key, str):
        return probe(xp, key, plan=plan)
    return probe(xp, *key, *rest, plan=plan)


def tiles_phase(smi):
    """Phase 9; the entries of the kernels line for tile.cu."""
    import torch
    from swmhd_tpu_torch.ops import substage as K
    from swmhd_tpu_torch.ops import tile as T
    from swmhd_tpu_torch.probes import build, exp_dma, exp_dma2, exp_fused2d
    limit = T.smem_limit()
    # the probe path: the three entry points with their default specs,
    # then the load probes on inputs TMA cannot describe; the counters
    # zeroed just before and read just after
    T.reset_counters()
    dma, dma2 = exp_dma.main([]), exp_dma2.main([])
    defaults = {f.__name__: dict(f.launches_by_branch)
                for f in (T.window_probe, T.wrap_probe)}
    tma_launched = {f.__name__: dict(f.launches_by_shape)
                    for f in (T.window_probe, T.wrap_probe)}
    unaligned = exp_dma.main(["--n", "64", "--spec", UNALIGNED_SPECS])
    x64 = exp_dma.ramp(64, "cuda")
    off = [T.wrap_probe(off_16_bytes(T.wrap_pad(x64, T.WRAP_H, 0)), case)
           for case in T.WRAP_CASES]
    fused = exp_fused2d.main([])
    launched = {f.__name__: dict(f.launches_by_shape)
                for f in (T.window_probe, T.wrap_probe, T.tendency_tiles)}
    by_branch = {f.__name__: dict(f.launches_by_branch)
                 for f in (T.window_probe, T.wrap_probe)}
    plain = (T.window_probe_reference.calls + T.wrap_probe_reference.calls
             + T.tendency_tiles_reference.calls)
    say(9, f"probe path launches: {launched}; load probes by branch: "
           f"default specs {defaults}, all {by_branch}; plain calls "
           f"{plain}; opt-in shared memory per block {limit} B")
    if plain:
        fail(f"plain versions ran {plain} times on the probe path")
    dma_specs = [tuple(int(v) for v in r["spec"].split(",")) for r in dma]
    fits = sum(T.window_smem_bytes(*spec[:4]) <= limit for spec in dma_specs)
    if defaults != {"window_probe": {"tma": fits},
                    "wrap_probe": {"tma": len(T.WRAP_CASES)}}:
        fail(f"a default spec or case did not take the tma branch: "
             f"{defaults}")
    if not (all(r["ok"] and r["bitwise"] for r in unaligned)
            and all(torch.equal(o, x64 + 1.0) for o in off)):
        fail(f"the cp.async branch is wrong on unaligned inputs: "
             f"{unaligned}")
    if (by_branch["window_probe"].get("cp.async") != len(unaligned)
            or by_branch["wrap_probe"].get("cp.async") != len(off)):
        fail(f"unaligned inputs did not take the cp.async branch: "
             f"{by_branch}")
    for spec, r in zip(dma_specs, dma):
        # a window over the limit is refused, and only such a window
        if T.window_smem_bytes(*spec[:4]) > limit:
            ok = (not r["ok"] and r["error"] == "ValueError"
                  and "shared memory" in r["why"])
        else:
            ok = (r["ok"] and r["bitwise"]
                  and launched["window_probe"].get(spec))
        if not ok:
            fail(f"window probe {spec}: {r}")
    for r in dma2:
        if not (r["ok"] and r["bitwise"]
                and launched["wrap_probe"].get(r["spec"])):
            fail(f"wrap probe {r['spec']}: {r}")
    for r in fused:
        TX, TY, H, split = r["spec"].split(",")
        key = (int(TX), int(TY), int(H), split)
        if not (r["ok"] and launched["tendency_tiles"].get(key)):
            fail(f"tile tendency probe {r['spec']}: {r}")

    # outside the counted window: timing, bounds and the sweep
    entries = []

    def entry(name, shape, launches, err, ms, plain_ms, nbytes, ops,
              library_ms, **design):
        bound_ms, bound_by = least_time(nbytes, ops)
        entries.append({
            "name": f"{name} [{shape}]", "route": "cuda",
            "source": PROBE_SOURCES[name], "replaces": PROBE_REPLACES[name],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **design})
        say(9, f"{name} [{shape}] on {smi}: {ms:.4f} ms (CUDA graph), plain "
               f"{plain_ms:.4f} ms, library "
               + ("none" if library_ms is None else f"{library_ms:.4f} ms")
               + f"; bound {bound_ms:.4g} ms ({bound_by}); launches "
               f"{launches}; max abs err {err:.3g}"
               + (f"; design {json.dumps(design)}" if design else ""))

    load_probe_entries(T, exp_dma, dma_specs, tma_launched, launched, entry,
                       smi)

    f32 = tile_sweep(T, K, BENCH_N, torch.float32, F32_BOUND, smi)
    tile_sweep(T, K, SMOKE_N, torch.float64, F64_BOUND, smi)
    model, st = build(BENCH_N, torch.float32, "cuda")
    s = torch.stack(st.fields())
    ops = {split: split_ops_per_point(split) for split in T.SPLITS}
    pts = BENCH_N * BENCH_N
    for r in fused:
        TX, TY, H, split = r["spec"].split(",")
        key = (int(TX), int(TY), int(H), split)
        if key not in f32:
            fail(f"the probe's spec {r['spec']} is outside the sweep "
                 f"(SWMHD_PROBE set?)")
        n_out = len(T.SPLIT_FIELDS[split])
        smem, regs, blocks = T.tendency_tile_info(torch.float32, key[:2],
                                                  key[2], split)
        entry("swmhd_tendency_tile", f"{TX}x{TY}, halo {H}, {split}",
              launched["tendency_tiles"][key], f32[key][0],
              graph_timed(lambda: T.tendency_tiles(model, s, key[:2], key[2],
                                                   split), 20),
              f32[key][1], 4 * (4 + n_out) * pts, ops[split] * pts, None,
              design="tile", tile=list(key[:2]), smem_bytes=smem,
              registers=regs, blocks_per_sm=blocks)
    say(9, "float32 operations per point of the plain tendency parts: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ops.items()))
    return entries


# -- phase 10: the adaptive step, profiling and the movie ---------------------

# (scenario, initial dt, target CFL, wizard cadence, steps) of the wizard
# runs: the initial dt is above the target, so the wizard halves it at once
# and then follows the flow
WIZARD = ("128x128_two_Gaussians_high_B", 0.01, 0.4, 5, 20)
MOVIE_SCENARIO = "64x64_two_Gaussians_high_B"
# phase 11: every validation case in float64 to VALIDATION_STOP (200
# steps) against the JAX package's rows, and these float32 cases to their
# reference stop times against the anchors (a periodic one, 1000 steps;
# the walled one with the A gradient, 1500)
VALIDATION_STOP, VALIDATION_BOUND = 2.0, 1e-10
VALIDATION_F32 = [(CONS, "64x64_two_Gaussians_high_B"),
                  (VI, "128x128_low_B_low_U")]
ENERGY_NAMES = ("kinetic_energy", "magnetic_energy", "potential_energy",
                "total_energy", "cross_helicity")


def simulate(model, state, dt, steps, stepper, series=True, wizard=False,
             at=None):
    """``steps`` steps of the CLI's run loop through ``stepper`` (None: the
    plain step), with its energy series (``cli.energies``) every step
    where ``series`` and WIZARD's TimeStepWizard where ``wizard``: (Δt
    after each adjustment, final state). ``at``: ``(every, fn)``, a
    callback ``fn(simulation)`` every ``every`` iterations, which also
    bounds the chunks."""
    from swmhd_tpu_torch import cli
    from swmhd_tpu_torch.io import ScalarSeriesWriter
    from swmhd_tpu_torch.simulation import (Callback, IterationInterval,
                                            Simulation, TimeStepWizard)
    sim = Simulation(model, dt=dt, stop_iteration=steps, stepper=stepper)
    history = []
    if wizard:
        class Recorded(TimeStepWizard):
            # a TimeStepWizard itself, so that the run queues no chunk past
            # it (a discarded chunk's launches would count)
            def __call__(self, s):
                super().__call__(s)
                history.append(s.dt)
        sim.callbacks["wizard"] = Callback(Recorded(cfl=WIZARD[2]),
                                           IterationInterval(WIZARD[3]))
    if at is not None:
        sim.callbacks["at"] = Callback(at[1], IterationInterval(at[0]))
    with tempfile.TemporaryDirectory() as tmp:
        if series:
            h0 = state.h

            def energy_series(m, st):
                return cli.energies(m, st, h0)
            sim.output_writers["energies"] = ScalarSeriesWriter(
                fn=energy_series, schedule=IterationInterval(1),
                path=os.path.join(tmp, "energies.csv"))
        final = sim.run(state)
    return history, final


def launches_by_branch(K):
    return {n: {K.branch_label(b): c for b, c in f.launches_by_branch.items()}
            for n, f in (("swmhd_substage", K.substage),
                         ("swmhd_multistep", K.multistep))}


def trace_kernels(path):
    """The names of the CUDA kernels in a torch.profiler Chrome trace."""
    import gzip
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def wizard_runs(K, dev, smi):
    """The wizard through the kernels against the plain stepper: without a
    series one resident launch a chunk of 5 steps (4 holding 60
    substages), with the energy series one a step replayed from CUDA
    graphs captured anew after each change of Δt (20 holding 60), no
    one-substage launch either way. The counters are zeroed before the
    kernel runs and read after them."""
    import torch
    from swmhd_tpu_torch import scenarios
    name, dt, cfl, every, steps = WIZARD
    runs = [(VI, False), (VI, True), (CONS, False)]
    cases = [scenarios.build(name, f, dtype=torch.float64, device=dev)[:2]
             for f, _ in runs]
    K.reset_counters()
    got = []
    for (formulation, series), (model, state) in zip(runs, cases):
        before = (K.substage.launches, K.multistep.launches,
                  K.multistep.substages)
        hist, final = simulate(model, state, dt, steps,
                               K.KernelStepper(model), series, wizard=True)
        got.append((hist, final, K.substage.launches - before[0],
                    (K.multistep.launches - before[1],
                     K.multistep.substages - before[2])))
    plain_calls = K.substage_reference.calls + K.multistep_reference.calls
    say(10, "wizard runs' launches by branch: "
        + json.dumps(launches_by_branch(K))
        + f"; plain calls {plain_calls}")
    if plain_calls:
        fail(f"plain versions ran {plain_calls} times in the wizard runs")
    for (formulation, series), (model, state), (hist, final, subs, multis) \
            in zip(runs, cases, got):
        want_hist, want = simulate(model, state, dt, steps, None, series,
                                   wizard=True)
        dt_err = max(abs(a - b) / b for a, b in zip(hist, want_hist))
        err = rel_err(K.stack(final), K.stack(want))
        changes = sum(a != b for a, b in zip([dt] + hist, hist))
        say(10, f"wizard {name} {formulation} f64"
               f"{' with the energy series' if series else ''}, cfl {cfl} "
               f"every {every} of {steps} steps, kernel vs plain stepper on "
               f"{smi}: dt history {', '.join(f'{d:.9e}' for d in hist)} "
               f"({changes} changes), rel err {dt_err:.2e} (bound 1e-12); "
               f"state rel err {err:.2e} (bound {F64_BOUND:g}); one-substage "
               f"launches {subs}, resident launches and substages held "
               f"{multis}")
        if not (len(hist) == len(want_hist) == steps // every + 1
                and dt_err <= 1e-12 and changes >= 2 and err <= F64_BOUND):
            fail(f"the wizard's kernel run ({formulation}, series {series}) "
                 f"disagrees with the plain stepper")
        want_multis = (steps if series else steps // every, 3 * steps)
        if subs or multis != want_multis:
            fail(f"the wizard's kernel run ({formulation}, series {series}) "
                 f"made {multis} resident launches and substages held, "
                 f"{subs} one-substage launches; expected {want_multis} and "
                 f"0")


def traces(K, dev):
    """The ``--worker trace`` report: the CUDA kernels in a
    ``profiling.trace`` of one 2048² substage of each formulation, and
    ``profiling.device_busy`` of a trace of ten steps of the 128² main
    path with the energy series: the second chunk of ten of a 20-step run
    (the first captures the chunk's graphs), from the callback after the
    first chunk to the one after the second, with the host copy of the
    chunk's series and its rows between them. A process of its own, alone on the card: once another process
    has used the card, a process that traced before gets no kernel events
    in its later traces, and one that traced before the others trace
    loses some (torch 2.11)."""
    import torch
    from swmhd_tpu_torch import profiling, scenarios
    from swmhd_tpu_torch.ops import _build
    _build.load()
    report = {"kernels": {}}
    with tempfile.TemporaryDirectory() as tmp:
        # thrown away: the first trace of a process came back once with
        # no event of the card at all, though the kernel had run
        model, state = bench_model(64, torch.float32, dev)
        with profiling.trace(os.path.join(tmp, "warm-up")):
            K.substage(model, K.stack(state), BENCH_DT, 0)
            torch.cuda.synchronize()
        for formulation in (VI, CONS):
            model, state = bench_model(BENCH_N, torch.float32, dev,
                                       formulation)
            s = K.stack(state)
            K.substage(model, s, BENCH_DT, 0)
            torch.cuda.synchronize()
            logdir = os.path.join(tmp, formulation)
            with profiling.trace(logdir):
                K.substage(model, s, BENCH_DT, 0)
                torch.cuda.synchronize()
            report["kernels"][formulation] = trace_kernels(
                os.path.join(logdir, profiling.TRACE_FILE))
            del s, state
        model, state, sc = scenarios.build(
            "128x128_two_Gaussians_high_B", VI, dtype=torch.float32,
            device=dev)
        logdir = os.path.join(tmp, "main")
        window = profiling.trace(logdir)

        def second_chunk(sim):
            if sim.state.clock.iteration == 10:
                window.__enter__()
            elif sim.state.clock.iteration == 20:
                window.__exit__(None, None, None)
        simulate(model, state, sc.dt, 20, K.KernelStepper(model),
                 at=(10, second_chunk))
        report["busy"] = profiling.device_busy(
            os.path.join(logdir, profiling.TRACE_FILE))
        report["host"] = host_time(os.path.join(logdir, profiling.TRACE_FILE))
    return report


def host_time(path, top=6):
    """Where a torch.profiler Chrome trace's host time went: for the
    CUDA runtime calls and for the host operators, the ``top`` names by
    their summed duration, ``{category: [[name, ms, count], ...]}``."""
    import gzip
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for cat in ("cuda_runtime", "cpu_op"):
        sums = {}
        for e in events:
            if e.get("cat") == cat and "dur" in e:
                ms, n = sums.get(e["name"], (0.0, 0))
                sums[e["name"]] = (ms + float(e["dur"]) / 1e3, n + 1)
        out[cat] = [[k, ms, n] for k, (ms, n) in sorted(
            sums.items(), key=lambda kv: -kv[1][0])[:top]]
    return out


def adaptive_phase(K, dev, smi, bench_ms_step):
    """Phase 10 (see the module's docstring). ``bench_ms_step`` is phase
    6's 2048² vector-invariant ms a step."""
    import torch
    from swmhd_tpu_torch import cli, profiling
    t10 = time.perf_counter()
    wizard_runs(K, dev, smi)

    # benchmark_step on the 2048² vector-invariant kernel stepper
    model, state = bench_model(BENCH_N, torch.float32, dev, VI)
    run20 = K.KernelStepper(model).step_fn(BENCH_DT, DD_STEPS)
    b = profiling.benchmark_step(run20, state, DD_STEPS)
    ms_step = b.wall_s * 1e3 / b.n_steps
    say(10, f"profiling.benchmark_step, bench {BENCH_N}^2 f32 {VI}, "
           f"{DD_STEPS} steps a call, on {smi}: {b}; points_per_s "
           f"{b.points_per_s:.4e}, hbm_fraction_of_light "
           f"{b.hbm_fraction_of_light:.4f}, rel_spread {b.rel_spread:.3e}; "
           f"{ms_step:.4f} ms/step against phase 6's {bench_ms_step:.4f} "
           f"(CUDA events)")
    if abs(ms_step - bench_ms_step) > 0.15 * bench_ms_step:
        fail(f"benchmark_step's step time {ms_step:.4f} ms is not within "
             f"15% of phase 6's {bench_ms_step:.4f} ms")

    # profiling.trace in a process of its own (see traces), then
    # measure_overlap on four gloo ranks of phase 8's 2048² configuration
    reps = {}
    with tempfile.TemporaryDirectory() as tmp:
        torchrun(1, ["trace", tmp])
        torchrun(WORLD, ["overlap", tmp])
        for task, n in (("trace", 1), ("overlap", WORLD)):
            reps[task] = []
            for r in range(n):
                with open(os.path.join(tmp, f"{task}_rank{r}.json")) as f:
                    reps[task].append(json.load(f))
    for formulation in (VI, CONS):
        names = reps["trace"][0]["kernels"][formulation]
        say(10, f"profiling.trace of one {BENCH_N}^2 {formulation} "
               f"substage on {smi}: kernels "
               + "; ".join(n.split(">(")[0] + ">" for n in names))
        if not any(TILE_KERNELS[formulation] in n for n in names):
            fail(f"the trace of a {formulation} substage does not name "
                 f"{TILE_KERNELS[formulation]}")
    busy = reps["trace"][0]["busy"]
    say(10, f"profiling.trace of 10 steps of the 128^2 main path "
           f"(128x128_two_Gaussians_high_B {VI} f32, KernelStepper, "
           f"energy series every step; the second chunk of ten of a "
           f"20-step run, replayed from CUDA graphs) on {smi}: device busy "
           f"{busy['busy_ms']:.4f} of {busy['window_ms']:.4f} ms = "
           f"{busy['busy_share']:.4f} of the window, "
           f"{busy['n_kernels']} kernels; host time by name [name, ms, "
           f"calls]: {json.dumps(reps['trace'][0]['host'])}")
    for formulation in (VI, CONS):
        per = [r[formulation] for r in reps["overlap"]]
        say(10, f"profiling.measure_overlap of one decomposed {BENCH_N}^2 "
               f"{formulation} step, {WORLD} ranks over gloo on {smi}: "
               + "; ".join(
                   f"rank {r}: comm_ms {o['comm_ms']:.4f}, compute_ms "
                   f"{o['compute_ms']:.4f}, hidden_ms {o['hidden_ms']:.4f}, "
                   f"overlap_pct {o['overlap_pct']}; the tile launch: "
                   f"{o['n_kernel_events']} kernels, {o['kernel_ms']:.4f} "
                   f"ms on the card, covering {o['kernel_hidden_ms']:.4f} "
                   f"ms of the exchange ({o['n_comm_events']} comm, "
                   f"{o['n_compute_events']} compute events)"
                   for r, o in enumerate(per)))
        if not all(o["n_comm_events"] > 0 and o["n_compute_events"] > 0
                   for o in per):
            fail(f"measure_overlap found no exchange or no compute "
                 f"({formulation}): {per}")

    # --movie: host post-processing, on no device path
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        say(10, f"--movie not run: matplotlib does not import here ({e})")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            cli.main(["run", MOVIE_SCENARIO, "--stop-time", "0.2",
                      "--outdir", tmp, "--movie"])
            made = sorted(os.listdir(tmp))
            say(10, f"cli run {MOVIE_SCENARIO} --stop-time 0.2 --movie: "
                   f"{', '.join(made)}")
            if not ("energy_plot.png" in made
                    and {"movie.mp4", "movie.mp4.frames"} & set(made)):
                fail("--movie wrote no energy_plot.png or no movie")
    say(10, "phase 10 launches by branch: "
        + json.dumps(launches_by_branch(K))
        + f"; phase 10 took {time.perf_counter() - t10:.1f} s")


def validation_phase(K, dev, smi):
    """Phase 11 (see the module's docstring)."""
    import torch
    from swmhd_tpu_torch import scenarios, validate
    from swmhd_tpu_torch.validation_anchors import (
        CASES, ENERGIES, REFERENCE, compare_series, judge, summarize)
    t11 = time.perf_counter()
    runs = [(f, name, VALIDATION_STOP, torch.float64) for f, name in CASES]
    runs += [(f, name, REFERENCE[(f, name)]["stop"], torch.float32)
             for f, name in VALIDATION_F32]
    K.reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        for formulation, name, stop, dtype in runs:
            tag = validate.case_tag(formulation, name)
            before = (K.multistep.launches, K.multistep.substages,
                      K.substage.launches, K.substage_reference.calls
                      + K.multistep_reference.calls)
            try:
                csv, path, wall = validate.run_case(
                    formulation, name, stop, dtype, dev, True, tmp)
            except (RuntimeError, ValueError) as e:
                fail(f"validation run {tag} {dtype}: {e}")
            resident, held, subs, plain = (
                n - n0 for n, n0 in zip(
                    (K.multistep.launches, K.multistep.substages,
                     K.substage.launches, K.substage_reference.calls
                     + K.multistep_reference.calls), before))
            steps = int(round(stop / scenarios.get(name).dt))
            line = (f"{tag} {path} t={stop:g} on {smi}: {wall:.3f} s wall, "
                    f"resident launches {resident} holding {held} "
                    f"substages, one-substage launches {subs}, plain calls "
                    f"{plain}")
            ok = (resident, held, subs, plain) == (steps, 3 * steps, 0, 0)
            if dtype == torch.float64:
                jax_csv = os.path.join(validate.JAX_SERIES, f"{tag}.csv")
                try:
                    d = compare_series(csv, jax_csv, prefix=True)
                except ValueError as e:
                    fail(f"validation run {tag}: {e}")
                worst = max(d[n]["all_max"] for n in ENERGIES)
                line += (f"; {d[ENERGIES[0]]['rows']} rows, max |dE| vs the "
                         f"JAX f64 rows {worst:.3e} (bound "
                         f"{VALIDATION_BOUND:g})")
                ok &= (d[ENERGIES[0]]["rows"] == steps + 1
                       and worst <= VALIDATION_BOUND)
            else:
                got = summarize(csv)
                checks = judge(REFERENCE[(formulation, name)], got)
                line += "; anchors " + ", ".join(
                    f"{k} {got[k]:.5g} {'ok' if v else 'MISS'}"
                    for k, v in checks.items())
                ok &= all(checks.values())
            say(11, line)
            if not ok:
                fail(f"validation run {tag} {dtype} failed: {line}")
    labels = {K.branch_label(b): n
              for b, n in K.multistep.launches_by_branch.items()}
    for b in [K.Branch(c, 0, wall_y) for c in (0, 1) for wall_y in (0, 1)]:
        if not K.multistep.launches_by_branch.get(b):
            fail(f"swmhd_multistep [{K.branch_label(b)}] was not launched "
                 f"by the validation runs")
    say(11, f"validation resident launches by branch: "
            f"{json.dumps(labels)}; one-substage launches "
            f"{K.substage.launches}; phase 11 took "
            f"{time.perf_counter() - t11:.1f} s")


# -- phase 12: the resident kernel and the graph chunk -----------------------

# the chunk with a series held against the eager chunk: steps (one
# GRAPH_STEPS replay and a remainder)
GRAPH_CHUNK_STEPS = 150


# the energy series kernel against its plain version: float32 values
# within this share of the larger of each and the five values' median
# (sums in double against torch.mean's float32), and the calls a timing
# graph holds
SERIES_F32_TOL, SERIES_REPS = 1e-5, 200


def series_phase(dev, smi):
    """Phase 12's energy series lines (see the module's docstring)."""
    import torch
    from swmhd_tpu_torch.ops import energies as E
    from swmhd_tpu_torch.ops import substage as K
    cases = [("128x128_two_Gaussians_high_B", 0.01, lambda f: _scenario_state(
                 "128x128_two_Gaussians_high_B", f, dev)),
             ("128x128_low_B_low_U", 0.01, lambda f: _scenario_state(
                 "128x128_low_B_low_U", f, dev)),
             (f"{BENCH_N}^2", BENCH_DT, lambda f: bench_model(
                 BENCH_N, torch.float32, dev, f))]
    for label, dt, build in cases:
        for formulation in (VI, CONS):
            model, state = build(formulation)
            h0 = state.h
            state = K.unstack(K.multistep(model, K.stack(state), dt, 10),
                              state.clock)
            before = E.energy_series.launches
            got = E.energy_series(model, state, h0)
            launched = E.energy_series.launches - before
            want = E.energy_series_reference(model, state, h0)
            g = torch.stack(list(got.values())).double()
            w = torch.stack([want[n] for n in got]).double()
            scale = torch.maximum(w.abs(), w.abs().median())
            err = float(((g - w).abs() / scale).max())
            ms = graph_timed(lambda: E.energy_series(model, state, h0),
                             SERIES_REPS)
            plain_ms = graph_timed(
                lambda: E.energy_series_reference(model, state, h0),
                SERIES_REPS)
            points = model.grid.Nx * model.grid.Ny
            bound_ms = least_time(20 * points, 0)[0]
            say(12, f"energy series {label} {formulation} f32 on {smi}: "
                   f"{launched} launch, max error {err:.3e} of the larger "
                   f"of each value and the median (limit "
                   f"{SERIES_F32_TOL:g}); ms a state (CUDA graph of "
                   f"{SERIES_REPS}): kernel {ms:.5f}, bound {bound_ms:.5f} "
                   f"(20 B a point, bytes), plain {plain_ms:.5f}")
            if launched != 1 or not err <= SERIES_F32_TOL:
                fail(f"the energy series kernel ({label}, {formulation}) "
                     f"launched {launched} times, error {err:.3e}")


def _scenario_state(name, formulation, dev, **kw):
    import torch
    from swmhd_tpu_torch import scenarios
    return scenarios.build(name, formulation, dtype=torch.float32,
                           device=dev, **kw)[:2]


def resident_phase(K, dev, smi):
    """Phase 12 (see the module's docstring)."""
    import torch
    from swmhd_tpu_torch import cli
    from swmhd_tpu_torch.models.shallow_water import run_steps
    t12 = time.perf_counter()
    # (label, build, dt, steps compared, steps timed): the shapes the
    # resident kernel is held at against its one-substage launches
    shapes = [
        ("128^2", lambda f: bench_model(128, torch.float32, dev, f),
         BENCH_DT, 10, 100),
        (f"{BENCH_N}^2", lambda f: bench_model(BENCH_N, torch.float32, dev,
                                                f), BENCH_DT, 3, DD_STEPS),
        ("128x128_low_B_low_U",
         lambda f: _scenario_state("128x128_low_B_low_U", f, dev), 0.01, 10,
         100),
        (f"f64 {SMOKE_N}^2 bounded xy", lambda f: wall_model(
            SMOKE_N, torch.float64, dev, f, BOUNDED_XY, -0.05), 0.005, 5,
         20)]
    checks = [(f"{label} {f}", lambda f=f, build=build: build(f), dt, n,
               reps, None)
              for label, build, dt, n, reps in shapes for f in (VI, CONS)]
    checks.append((f"{BENCH_N}^2 {VI} biharmonic",
                   lambda: bench_model(BENCH_N, torch.float32, dev, VI),
                   BENCH_DT, 3, DD_STEPS, "biharmonic"))
    checks.append((f"128x128_two_Gaussians_high_B {VI} CLI biharmonic",
                   lambda: _scenario_state(
                       "128x128_two_Gaussians_high_B", VI, dev,
                       closure=cli_closure(CLOSURE_FLAGS[VI])),
                   0.01, 10, 100, None))
    ops = {}
    for label, build, dt, n, reps, options in checks:
        model, state = build()
        if options:
            model = with_options(model, options, dt)
        s = K.stack(state)
        del state
        x = K.multistep(model, s, dt, n)
        y = K.windowed_steps(model, s, dt, n)
        bitwise = bool(torch.equal(x, y))
        err = float((x - y).abs().max())
        smem, regs, blocks, grid = K.ready(model, s)

        def one_step_launches(k=reps):
            x = s
            for _ in range(k):
                x = K.multistep(model, x, dt, 1)
            return x
        # times a step: one resident launch of `reps` steps; a CUDA graph
        # of `reps` one-step resident launches (a graph chunk's steps on
        # the resident route); the loop of 3·reps one-substage launches
        # with the host's cost, and as a CUDA graph of them (a graph
        # chunk's steps on the other route)
        ms = timed(lambda: K.multistep(model, s, dt, reps), 1)[0] / reps
        res_graph_ms = graph_timed(one_step_launches, 1) / reps
        loop_ms = timed(lambda: K.windowed_steps(model, s, dt, reps),
                        1)[0] / reps
        loop_graph_ms = graph_timed(
            lambda: K.windowed_steps(model, s, dt, reps), 1) / reps
        b = K.kernel_params(model).branch
        bound = "not computed (float64)"
        if s.dtype == torch.float32:
            if b not in ops:
                ops[b] = ops_per_point(K, b, "step")
            pts = s.shape[1] * s.shape[2]
            bound = "{:.4f} ({})".format(*least_time(
                2 * 4 * s.element_size() * pts / reps, ops[b] * pts))
        tiles = K.resident_tiles(s.shape[1], s.shape[2],
                                 K._tile_x(model, *s.shape[1:], s))
        say(12, f"resident {label} {s.dtype} on {smi}: {n} steps in one "
               f"launch vs {3 * n} one-substage launches: bitwise equal "
               f"{bitwise}, max abs diff {err:.3e}; grid {grid} blocks of "
               f"{blocks} an SM over {tiles} tiles, {smem} B shared "
               f"memory, {regs} registers; ms/step (launches of {reps} "
               f"steps): resident {ms:.4f}, a CUDA graph of one-step "
               f"resident launches {res_graph_ms:.4f}, loop of one-substage "
               f"launches {loop_ms:.4f}, the loop as a CUDA graph "
               f"{loop_graph_ms:.4f}, bound {bound}; the stepper takes "
               f"{'resident' if K.takes_resident(model, s) else 'one-substage'}"
               f" launches here")
        if not (bitwise and torch.isfinite(x).all()):
            fail(f"the resident kernel ({label}) differs from "
                 f"{3 * n} one-substage launches: {err:.3e}")
        del s, x, y
    # the chunk with the CLI's series as graph replays against the eager
    # chunk (a step's launches, then the series): at 128² on the resident
    # route, at 2048² on the one-substage route
    chunks = [(f, "128x128_two_Gaussians_high_B", 0.01, GRAPH_CHUNK_STEPS,
               lambda f: _scenario_state("128x128_two_Gaussians_high_B", f,
                                         dev)) for f in (VI, CONS)]
    chunks += [(f, f"{BENCH_N}^2", BENCH_DT, 10, lambda f: bench_model(
        BENCH_N, torch.float32, dev, f)) for f in (VI, CONS)]
    for formulation, label, dt, n, build in chunks:
        model, state = build(formulation)
        h0 = state.h.clone()

        def series(st):
            return cli.energies(model, st, h0)
        stepper = K.KernelStepper(model)
        chunk = stepper.step_fn(dt, n, series)
        got, gs = chunk(state)
        want, ws = run_steps(stepper.one_step(dt), dt, n, series)(state)
        same = (all(torch.equal(a, b)
                    for a, b in zip(got.fields(), want.fields()))
                and all(torch.equal(gs[k], ws[k]) for k in ws))
        graph_ms = timed(lambda: chunk(state), 1)[0] / n
        eager_ms = timed(lambda: run_steps(
            stepper.one_step(dt), dt, n, series)(state), 1)[0] / n
        route = ("resident" if K.takes_resident(model, state.h)
                 else "one-substage")
        say(12, f"graph chunk {label} {formulation} f32, {n} steps with the "
               f"CLI's series, {route} launches (graphs of "
               f"{sorted(chunk.graphs)} steps) vs the eager chunk on {smi}: "
               f"state and series bitwise equal {same}; ms/step graph "
               f"{graph_ms:.4f}, eager {eager_ms:.4f}")
        if not same:
            fail(f"the graph chunk ({label}, {formulation}) differs from "
                 f"the eager chunk")
        del state, got, want
    series_phase(dev, smi)
    say(12, f"phase 12 took {time.perf_counter() - t12:.1f} s")


# -- phase 13: the bench and the scaling sweep ------------------------------

# the ladder of the bench run here (the default 128,512,4096,8192 runs
# outside chip_smoke); the sweep: two ranks sharing the card over gloo
BENCH_LADDER = "128,512"
SWEEP = ("--mode", "weak", "--local", "512", "--steps", "10",
         "--max-ranks", "2")
# bench.py's keys, in its order, as the bench prints them on the card,
# and the bench's own "nonfinite"
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline",
              "fraction_of_roofline", "binding_limit",
              "hbm_fraction_of_light", "vpu_fraction_of_peak",
              "hbm_gbps_at_min_traffic", "flops_per_point_measured",
              "flops_per_point_analytic", "rel_spread", "ladder",
              "nonfinite"]
LARGE_N, K2_N, K2_STEPS = 8192, 512, 20
# the bump on h of the states that phase 13 holds against the plain
# versions, and how near the float32 plain G must lie to the float64 G,
# each field, for the latter to hold the kernel's G (PERF.md §2)
H_BUMP, G_F64_REACH = 0.2, 0.1


def module_run(module, args=(), env=None, timeout=600):
    """``python -m <module> <args>`` in a fresh process (:func:`run_checked`,
    its errors kept apart); its standard output's lines."""
    return run_checked([sys.executable, "-m", module, *args], env, timeout,
                       subprocess.PIPE).strip().splitlines()


def check_bench(smi):
    """``python -m swmhd_tpu_torch.bench`` with the BENCH_LADDER: its JSON
    line (bench.py's keys, a positive value, fractions in (0, 1.05]) and
    its size lines (the resident kernel alone at 128² and 512², exactly
    3·steps·11 one-substage launches at 2048², every state finite)."""
    lines = module_run("swmhd_tpu_torch.bench",
                       env={"SWMHD_BENCH_LADDER": BENCH_LADDER})
    out = json.loads(lines[-1])
    sizes = {s["N"]: s for s in (json.loads(ln[len("size "):])
                                 for ln in lines if ln.startswith("size "))}
    for N, s in sorted(sizes.items()):
        say(13, f"bench {N}^2 on {smi}: {json.dumps(s)}")
    say(13, f"bench line: {lines[-1]}")
    if list(out) != BENCH_KEYS or not out["value"] > 0:
        fail(f"the bench line's keys are {list(out)}, not {BENCH_KEYS}, or "
             f"its value is not positive")
    if out["nonfinite"]:
        fail(f"the bench's state ended non-finite at {out['nonfinite']}")
    fractions = ("fraction_of_roofline", "hbm_fraction_of_light",
                 "vpu_fraction_of_peak")
    if not all(0 < out[k] <= 1.05 for k in fractions):
        fail(f"a fraction of the bench line lies outside (0, 1.05]: "
             f"{ {k: out[k] for k in fractions} }")
    if (sorted(sizes) != [128, 512, BENCH_N]
            or list(out["ladder"]) != BENCH_LADDER.split(",")):
        fail(f"the bench ran sizes {sorted(sizes)}, ladder "
             f"{list(out['ladder'])}")
    calls = 5 * 2 + 1      # n_calls a repetition, two repetitions, warm-up
    for N, s in sizes.items():
        n = s["launches"]
        if N == BENCH_N:
            ok = (s["path"] == "substage-cuda" and n["multistep"] == 0
                  and n["substage"] == 3 * s["steps_per_call"] * calls)
        else:
            ok = (s["path"] == "resident-cuda" and n["substage"] == 0
                  and n["multistep"] == calls and n["multistep_substages"]
                  == 3 * s["steps_per_call"] * calls)
        if not (ok and s["finite"]):
            fail(f"the bench at {N}^2 took {s['path']} with launches {n}, "
                 f"finite {s['finite']}")
    return out


def g_against_f64(g_k, g_p, g64, what):
    """PERF.md §2's float32 rule for G (:func:`g_within`), each field,
    after checking that the float64 G is a reference for every field: the
    plain float32 G within G_F64_REACH of it, so that a kernel that
    zeroed or negated a field (1 or 2 away) could not pass by being no
    farther from it than twice the plain G. ``(ok, G's worst rel err
    against the plain G, line)``."""
    plain_far = field_errors(g_p, g64)
    if max(plain_far) > G_F64_REACH:
        fail(f"{what}: the plain float32 G lies {plain_far} from the "
             f"float64 G, which then holds no field of the kernel's G")
    ok, g_err = g_within(g_k, g_p, g64, F32_BOUND)
    return ok, g_err, (f"G rel err by field {field_errors(g_k, g_p)}, from "
                       f"the f64 plain G kernel {field_errors(g_k, g64)} / "
                       f"plain {plain_far}")


def check_large_substage(K, dev, smi):
    """K1's substage 0 at LARGE_N² float32 against its plain version under
    PERF.md §2's rule (:func:`g_against_f64`; the state within F32_BOUND),
    timed beside the plain version, on the bench configuration with a
    bump of H_BUMP on h (:func:`bench_model`): with the bench's h = 1 the
    float64 G of h is ≈0, and the float32 G of h rounding noise that no
    rule can hold. Returns the max abs error of G."""
    import torch
    model, state = bench_model(LARGE_N, torch.float32, dev, h_bump=H_BUMP)
    s = K.stack(state)
    del state
    K.substage(model, s, BENCH_DT, 0)
    ms, (s_k, g_k) = timed(lambda: K.substage(model, s, BENCH_DT, 0), 5)
    plain_ms, (s_p, g_p) = timed(
        lambda: K.substage_reference(model, s, BENCH_DT, 0), 1)
    peak = torch.cuda.max_memory_allocated(dev)
    s_err = rel_err(s_k, s_p)
    del s, s_k, s_p
    torch.cuda.empty_cache()
    model64, state64 = bench_model(LARGE_N, torch.float64, dev,
                                   h_bump=H_BUMP)
    s64 = K.stack(state64)
    del state64
    g64 = K.substage_reference(model64, s64, BENCH_DT, 0)[1]
    del s64
    torch.cuda.empty_cache()
    what = f"K1 at {LARGE_N}^2"
    ok, g_err, line = g_against_f64(g_k, g_p, g64, what)
    abs_err = float((g_k - g_p).abs().max())
    pts = LARGE_N ** 2
    bound = least_time(48 * pts, ops_per_point(
        K, K.kernel_params(model).branch, "substage") * pts)
    say(13, f"K1 substage {LARGE_N}^2 f32 VI, h bump {H_BUMP}, on {smi}: "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}); {line}; state rel err {s_err:.2e}; max abs err "
            f"of G {abs_err:.3e}; peak device memory {peak / 2**30:.2f} GiB")
    if not (ok and s_err <= F32_BOUND and finite([g_k])):
        fail(f"{what} disagrees with its plain version: G {g_err:.3e}, "
             f"state {s_err:.3e}")
    return abs_err


def check_resident_512(K, dev, smi):
    """K2 at K2_N² float32, with a bump of H_BUMP on h so that the h
    equation moves the state: K2_STEPS steps in one launch against the
    plain version's K2_STEPS steps (each field within F32_BOUND of its
    scale) and bit for bit against 3·K2_STEPS one-substage launches,
    counted; then timed (ms a step of one K2_STEPS-step launch) beside the
    bound."""
    import torch
    model, state = bench_model(K2_N, torch.float32, dev, h_bump=H_BUMP)
    s = K.stack(state)
    if not K.takes_resident(model, s):
        fail(f"the {K2_N}^2 float32 state does not fit the card's L2: the "
             f"stepper would not take the resident kernel")
    before = resident_counts(K)
    x = K.multistep(model, s, BENCH_DT, K2_STEPS)
    y = K.windowed_steps(model, s, BENCH_DT, K2_STEPS)
    launches, subs = resident_counts(K, before)
    held = list(launches.values())
    bitwise = bool(torch.equal(x, y))
    plain = field_errors(x, K.multistep_reference(model, s, BENCH_DT,
                                                  K2_STEPS))
    say(13, f"K2 {K2_N}^2 f32, h bump {H_BUMP}, on {smi}: {K2_STEPS} steps "
            f"in one launch vs the plain version: rel err by field {plain} "
            f"(bound {F32_BOUND:g}); vs {subs} one-substage launches: "
            f"bitwise equal {bitwise}, max abs diff "
            f"{float((x - y).abs().max()):.3e}; resident [launches, "
            f"substages held] {held}")
    if not (max(plain) <= F32_BOUND and bitwise and torch.isfinite(x).all()
            and held == [(1, 3 * K2_STEPS)] and subs == 3 * K2_STEPS):
        fail(f"K2 at {K2_N}^2 differs from its plain version or from "
             f"{3 * K2_STEPS} one-substage launches, or the launches were "
             f"{held}, {subs}")
    pts = K2_N ** 2
    ms = timed(lambda: K.multistep(model, s, BENCH_DT, K2_STEPS),
               1)[0] / K2_STEPS
    bound = least_time(32 * pts / K2_STEPS, ops_per_point(
        K, K.kernel_params(model).branch, "step") * pts)
    say(13, f"K2 {K2_N}^2 f32 on {smi}: {ms:.4f} ms a step in a "
            f"{K2_STEPS}-step launch; bound {bound[0]:.5f} ms ({bound[1]})")


def check_sweep_tiles(K, dev, smi):
    """K3 at the two-rank sweep's tiles: the sweep's grid and mesh for two
    ranks (``scaling.grid_for``, ``make_mesh``), each tile padded by the
    halo, substages 0 and 1 against the plain tile version, with a bump of
    H_BUMP on h: float64 within F64_BOUND, float32 states within
    F32_BOUND and G by :func:`g_against_f64`. The sweep's one-rank model
    must take the branch that check_resident_512 holds, and its two-rank
    model the branch held here."""
    import torch
    from swmhd_tpu_torch import scaling
    from swmhd_tpu_torch.parallel import make_mesh
    local = int(SWEEP[SWEEP.index("--local") + 1])
    Nx, Ny = scaling.grid_for("weak", 2, local, None)
    mesh = make_mesh(2)
    mesh = (mesh.px, mesh.py)
    cases = [bench_model(Nx, dtype, dev, M=Ny, h_bump=H_BUMP)
             for dtype in (torch.float32, torch.float64)]
    for n, (X, Y) in ((1, (local, local)), (2, (Nx, Ny))):
        sweep_model = scaling.build_model(X, Y, dev)[0]
        want = (K.kernel_params(bench_model(K2_N, torch.float32, dev)[0])
                .branch if n == 1 else tile_branch(K, cases[0][0], mesh))
        got = (K.kernel_params(sweep_model).branch if n == 1
               else tile_branch(K, sweep_model, mesh))
        if got != want:
            fail(f"the sweep's {n}-rank model takes [{K.branch_label(got)}]"
                 f", not the branch held here [{K.branch_label(want)}]")
    tiles, halo = tile_layout(Nx, Ny, mesh, cases[0][0].exchange_halo)
    what = f"K3 at the sweep's {Nx // mesh[0]}x{Ny // mesh[1]} tiles"
    for b in tiles:
        (m32, st32), (m64, st64) = cases
        p = cut_tile(K.stack(st32), b, *halo)
        got, want = tile_pair(K, m32, p, BENCH_DT, halo)
        got64, want64 = tile_pair(K, m64, cut_tile(K.stack(st64), b, *halo),
                                  BENCH_DT, halo)
        ok, g_err, line = g_against_f64(got[0], want[0], want64[0], what)
        s_err = max(rel_err(x, y) for x, y in zip(got[1:], want[1:]))
        f64_err = max(rel_err(x, y) for x, y in zip(got64, want64))
        say(13, f"{what} f32 [{K.branch_label(tile_branch(K, m32, mesh))}],"
                f" tile {b} of {Nx}x{Ny} ({tuple(p.shape[1:])} read), h bump "
                f"{H_BUMP}, on {smi}: tile kernel vs plain (substages 0 and "
                f"1): {line}; f32 state {s_err:.2e} (bound {F32_BOUND:g}); "
                f"f64 G and state {f64_err:.2e} (bound {F64_BOUND:g})")
        if not (ok and finite(got) and s_err <= F32_BOUND
                and f64_err <= F64_BOUND):
            fail(f"{what} disagree with the plain tile version: G "
                 f"{g_err:.3e}, f32 state {s_err:.3e}, f64 {f64_err:.3e}")


def check_sweep(smi):
    """``python -m swmhd_tpu_torch.scaling`` over SWEEP: a finite
    points/s row for one rank (the resident kernel at 512²) and for two
    ranks (tile substages on 512² tiles)."""
    lines = module_run("swmhd_tpu_torch.scaling", SWEEP)
    out = json.loads(lines[-1])
    rows = {r["devices"]: r for r in out["results"]}
    say(13, f"scaling {' '.join(SWEEP)} on {smi}: " + json.dumps(out))
    # a 1x2 mesh of 512² tiles: a tile launch a substage
    want = {1: {"substage": 0, "multistep": 7},
            2: {"substage": 3 * 10 * 7, "multistep": 0}}
    ok = (sorted(rows) == sorted(want)
          and all(math.isfinite(r["points_per_s"]) and r["points_per_s"] > 0
                  and r["launches"] == want[k] for k, r in rows.items()))
    if not ok:
        fail(f"the scaling sweep gave {out}")


def bench_phase(K, dev, smi):
    """Phase 13 (see the module's docstring)."""
    import torch
    t13 = time.perf_counter()
    torch.cuda.empty_cache()
    out = check_bench(smi)
    t_bench = time.perf_counter() - t13
    abs_err = check_large_substage(K, dev, smi)
    check_resident_512(K, dev, smi)
    check_sweep_tiles(K, dev, smi)
    t_kernels = time.perf_counter() - t13 - t_bench
    check_sweep(smi)
    say(13, f"bench {BENCH_N}^2: {out['value']} points/s; K1 at {LARGE_N}^2 "
            f"max abs err {abs_err:.3e}; phase 13 took "
            f"{time.perf_counter() - t13:.1f} s (the bench {t_bench:.1f}, "
            f"K1, K2 and K3 {t_kernels:.1f}, the sweep the rest)")


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
    t_start = time.perf_counter()
    nvcc = command_output([_build._nvcc(), "--version"]).splitlines()[-1]
    smi = command_output(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).splitlines()[0]
    say(1, f"python {sys.version.split()[0]} torch {torch.__version__} "
           f"cuda {torch.version.cuda}; nvcc: {nvcc}; card: {smi}")

    # 2 -------------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    kernels = ptxas_kernels(lib.log)
    say(2, f"built {os.path.relpath(lib.path, HERE)} in "
           f"{lib.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f} "
           f"s); {len(kernels)} kernels, ptxas registers: "
           + "; ".join(f"{n} {r}" for n, r, _ in kernels)
           + "; nonzero spill stores: "
           + ("; ".join(f"{n} {sp} B" for n, _, sp in kernels if sp)
              or "none"))

    # 3 -------------------------------------------------------------------
    for cfg, options in branch_cases():
        for dtype, bound in ((torch.float64, F64_BOUND),
                             (torch.float32, F32_BOUND)):
            compare_branch(K, dev, cfg, dtype, bound, options)

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
        """(wall s, energy rows, final.npz written) of a CLI run to t =
        1.0 with ``flags``."""
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
        return (K.substage_reference.calls + K.multistep_reference.calls
                + K.energy_series_reference.calls)

    K.reset_counters()
    cli_walls = {}
    for scenario, formulation, flags in CLI_RUNS:
        before = resident_counts(K)
        series_before = K.energy_series.launches
        wall, rows, has_final = cli_run(scenario, formulation, *flags)
        launches, subs = resident_counts(K, before)
        series = K.energy_series.launches - series_before
        cli_walls[(scenario, formulation, flags)] = wall
        labels = {K.branch_label(b): list(n) for b, n in launches.items()}
        say(5, f"cli run {scenario} {formulation} {' '.join(flags)} f32 "
               f"t=1.0: {wall:.2f} s wall, {len(rows)} energy rows, finite "
               f"{bool(np.isfinite(rows).all())}, final.npz {has_final}, "
               f"resident launches [launches, substages held] "
               f"{json.dumps(labels)}, one-substage launches {subs}, energy "
               f"series launches {series}, plain calls {plain_calls()}")
        if not (len(rows) == 101 and np.isfinite(rows).all()
                and has_final):
            fail(f"the CLI run of {scenario} ({formulation}) did not write "
                 f"101 finite rows and final.npz")
        ((b, n),) = (launches.items() if len(launches) == 1
                     else ((None, (0, 0)),))
        if (n != (100, 300) or subs or plain_calls()
                or (b.closure != 0) != bool(flags) or series != 102):
            fail(f"expected 100 resident launches holding 300 substages in "
                 f"one branch, with a closure where the run has one, 102 "
                 f"energy series launches (the first row, the capture's "
                 f"warm-up, one a step) and no one-substage launch or plain "
                 f"call; got {labels}, {subs}, {series}, {plain_calls()}")

    # 6 -------------------------------------------------------------------
    bench_dt, steps = BENCH_DT, DD_STEPS
    # the bench configuration without and with a biharmonic closure, whose
    # state exceeds the card's L2, so the stepper takes one-substage
    # launches; the closure's warm-up step carries a series, so it runs a
    # graph chunk
    bench = {}            # (formulation, options) -> (model, state, ms/step)
    for formulation, options in ((VI, None), (CONS, None),
                                 (VI, "biharmonic"), (CONS, "biharmonic")):
        model, state = bench_model(BENCH_N, torch.float32, dev, formulation)
        model = with_options(model, options, bench_dt)
        if K.takes_resident(model, state.h):
            fail(f"the {BENCH_N}^2 float32 state fits the card's L2 "
                 f"({K.l2_bytes(0)} B): the stepper would take the "
                 f"resident kernel")
        stepper = K.KernelStepper(model)
        series = (lambda st: {"mass": st.h.sum()}) if options else None
        stepper.step_fn(bench_dt, 1, series)(state)           # warm-up
        run20 = stepper.step_fn(bench_dt, steps)
        ms_call, _ = timed(lambda: run20(state), 1)
        bench[(formulation, options)] = (model, state, ms_call / steps)
    # 128x128_low_B_low_U, with the conservative CLI run's closure, and
    # with the SCHEME_RUNS (their warm-up step carries a series)
    walled = []           # (formulation, options, model, state, dt, ms)
    runs = [(VI, {}), (CONS, {}),
            (CONS, {"closure": cli_closure(CLOSURE_FLAGS[CONS])})]
    for formulation, kw in runs + SCHEME_RUNS:
        model, state, sc = scenarios.build("128x128_low_B_low_U",
                                           formulation, dtype=torch.float32,
                                           device=dev, **kw)
        stepper = K.KernelStepper(model)
        if kw and "closure" not in kw:
            stepper.step_fn(sc.dt, 1, lambda st: {"mass": st.h.sum()})(state)
        run100 = stepper.step_fn(sc.dt, 100)
        ms_call, out = timed(lambda: run100(state), 1)
        if not all(torch.isfinite(f).all() for f in out.fields()):
            fail(f"128x128_low_B_low_U ({formulation}, {kw}) went "
                 f"non-finite")
        walled.append((formulation, kw, model, state, sc.dt, ms_call / 100))
    # the conservative formulation with the CLI's biharmonic closure at
    # 128², 100 steps (the resident kernel's branch phase 5 leaves out)
    model, state, sc = scenarios.build(
        "128x128_two_Gaussians_high_B", CONS, dtype=torch.float32,
        device=dev, closure=cli_closure(CLOSURE_FLAGS[VI]))
    out = K.KernelStepper(model).step_fn(sc.dt, 100)(state)
    if not all(torch.isfinite(f).all() for f in out.fields()):
        fail("128x128_two_Gaussians_high_B (conservative, biharmonic) went "
             "non-finite")
    launches = {"swmhd_substage": dict(K.substage.launches_by_branch),
                "swmhd_multistep": dict(K.multistep.launches_by_branch)}
    if plain_calls():
        fail(f"plain versions ran {plain_calls()} times on the main path")
    # the branches each kernel ran on the main path: the one-substage
    # kernel the 2048² runs' (each formulation periodic, without and with
    # a biharmonic closure), exactly three launches for each of their
    # 1 + DD_STEPS steps and none elsewhere; the resident kernel the 128²
    # runs' (each formulation periodic and bounded in y; with a biharmonic
    # closure periodic; the conservative formulation with a Laplacian
    # closure bounded in y; the SCHEME_RUNS)
    bench_branches = [K.Branch(c, 0, 0, closure=closure) for c in (0, 1)
                      for closure in (0, 2)]
    if launches["swmhd_substage"] != {b: 3 * (1 + steps)
                                      for b in bench_branches}:
        fail(f"expected {3 * (1 + steps)} one-substage launches in each "
             f"{BENCH_N}^2 branch and none elsewhere; got "
             f"{launches['swmhd_substage']}")
    main_branches = {
        "swmhd_substage": bench_branches,
        "swmhd_multistep": ([K.Branch(c, 0, wall_y) for c in (0, 1)
                             for wall_y in (0, 1)]
                            + [K.Branch(c, 0, 0, closure=2) for c in (0, 1)]
                            + [K.Branch(1, 0, 1, closure=1)]
                            + [K.kernel_params(w[2]).branch
                               for w in walled[3:]])}
    for name, counts in launches.items():
        for b in main_branches[name]:
            if not counts.get(b):
                fail(f"{name} [{K.branch_label(b)}] was not launched on the "
                     f"main path")
    say(6, "main-path launches by branch: " + json.dumps(
        {name: {K.branch_label(b): n for b, n in counts.items()}
         for name, counts in launches.items()})
        + "; substages the resident launches held: " + json.dumps(
            {K.branch_label(b): n
             for b, n in K.multistep.substages_by_branch.items()}))

    # outside the counted window: plain timings and comparisons
    # branch -> {entry point: {ms, plain_ms, nbytes, points, per}}: the
    # time of one call and, for its bound, the bytes it must move and the
    # points whose arithmetic it does (per substage 0 or per RK3 step)
    timings = {}
    errors = {}           # branch -> (substage G, multistep) f32 abs err
    pts = BENCH_N * BENCH_N
    for (formulation, options), (model, state, ms_step) in bench.items():
        s = K.stack(state)
        K.multistep_reference(model, s, bench_dt, 1)          # warm-up
        plain_ms_step, y = timed(
            lambda: K.multistep_reference(model, s, bench_dt, 3), 1)
        plain_ms_step /= 3
        x = K.KernelStepper(model).advance(s, bench_dt, 3)
        err3 = rel_err(x, y)
        sub_ms, _ = timed(lambda: K.substage(model, s, bench_dt, 0), 10)
        sub_plain_ms, _ = timed(
            lambda: K.substage_reference(model, s, bench_dt, 0), 3)
        # the resident kernel at this size, off the main path
        K.multistep(model, s, bench_dt, 1)
        res_ms, _ = timed(lambda: K.multistep(model, s, bench_dt, steps), 1)
        rate, plain_rate = pts / (ms_step * 1e-3), pts / (plain_ms_step * 1e-3)
        say(6, f"bench {BENCH_N}^2 f32 {formulation} periodic "
               f"{options or ''} on {smi}: "
               f"stepper (one-substage launches) {ms_step:.4f} ms/step = "
               f"{rate:.4e} points/s; resident kernel "
               f"{res_ms / steps:.4f} ms/step; plain "
               f"{plain_ms_step:.4f} ms/step = {plain_rate:.4e} points/s; "
               f"substage kernel {sub_ms:.4f} ms, plain {sub_plain_ms:.4f} "
               f"ms; 3-step rel err {err3:.2e}")
        if not (math.isfinite(err3) and err3 <= F32_BOUND):
            fail(f"bench state after 3 steps disagrees ({formulation}, "
                 f"{options}): {err3:.3e}")
        timings[K.kernel_params(model).branch] = {
            "swmhd_substage": dict(ms=sub_ms, plain_ms=sub_plain_ms,
                                   nbytes=48 * pts, points=pts,
                                   per="substage",
                                   shape=(BENCH_N, BENCH_N))}
    for formulation, kw, model, state, dt, ms_step in walled:
        s = K.stack(state)
        b = K.kernel_params(model).branch
        label = f"128x128_low_B_low_U [{K.branch_label(b)}]"
        K.multistep_reference(model, s, dt, 1)
        plain_ms_step, _ = timed(
            lambda: K.multistep_reference(model, s, dt, 10), 1)
        plain_ms_step /= 10
        K.substage(model, s, dt, 0)
        sub_ms, _ = timed(lambda: K.substage(model, s, dt, 0), 100)
        sub_plain_ms, _ = timed(
            lambda: K.substage_reference(model, s, dt, 0), 10)
        errors[b] = compare_main_size(K, label, scenario_case(
            "128x128_low_B_low_U", formulation, dev, **kw))
        n = model.grid.Nx * model.grid.Ny
        say(6, f"{label} f32 on {smi}: "
               f"multistep kernel {ms_step:.4f} ms/step = "
               f"{n / (ms_step * 1e-3):.4e} points/s; plain "
               f"{plain_ms_step:.4f} ms/step = "
               f"{n / (plain_ms_step * 1e-3):.4e} points/s; substage kernel "
               f"(off the main path here) {sub_ms:.4f} ms, plain "
               f"{sub_plain_ms:.4f} ms")
        timings[b] = {
            "swmhd_multistep": dict(ms=ms_step, plain_ms=plain_ms_step,
                                    nbytes=32 * n / 100, points=n,
                                    per="step",
                                    shape=(model.grid.Nx, model.grid.Ny))}

    # the 128² periodic CLI configuration per step, without and with the
    # biharmonic closure of the CLI run, checked against the plain version
    # (the max abs errors of the periodic branches timed at 2048²); then
    # the CLI runs end to end with the kernel and with --no-fused, in turns
    pts = 128 * 128
    biharmonic = cli_closure(CLOSURE_FLAGS[VI])
    for formulation, closure in ((VI, None), (CONS, None), (VI, biharmonic),
                                 (CONS, biharmonic)):
        build = scenario_case("128x128_two_Gaussians_high_B", formulation,
                              dev, closure=closure)
        model, s, dt = build(torch.float32)
        label = (f"128x128_two_Gaussians_high_B "
                 f"[{K.branch_label(K.kernel_params(model).branch)}]")
        K.multistep(model, s, dt, 1)
        k128, _ = timed(lambda: K.multistep(model, s, dt, 100), 1)
        K.multistep_reference(model, s, dt, 1)
        p128, _ = timed(lambda: K.multistep_reference(model, s, dt, 10), 1)
        k128, p128 = k128 / 100, p128 / 10
        say(6, f"{label} f32 on {smi}: multistep kernel {k128:.4f} ms/step "
               f"= {pts / (k128 * 1e-3):.4e} points/s; plain {p128:.4f} "
               f"ms/step = {pts / (p128 * 1e-3):.4e} points/s")
        timings.setdefault(K.kernel_params(model).branch, {})[
            "swmhd_multistep"] = dict(ms=k128, plain_ms=p128,
                                      nbytes=32 * pts / 100, points=pts,
                                      per="step", shape=(128, 128))
        errors[K.kernel_params(model).branch] = compare_main_size(
            K, label, build)
    for scenario, formulation, flags in CLI_RUNS[:4]:
        walls = {"--fused": [], "--no-fused": []}
        for flag in ("--fused", "--no-fused", "--fused"):
            walls[flag].append(cli_run(scenario, formulation, flag)[0])
        say(6, f"cli {scenario} {formulation} t=1.0 wall s on {smi}: "
               f"main path {cli_walls[(scenario, formulation, flags)]:.3f}; "
               f"kernel "
               f"{', '.join(f'{w:.3f}' for w in walls['--fused'])}; "
               f"--no-fused "
               f"{', '.join(f'{w:.3f}' for w in walls['--no-fused'])}")

    # 7 -------------------------------------------------------------------
    E, B = K.EXCHANGED_AXIS, K.BOUNDED_AXIS
    for formulation in (VI, CONS):
        for dtype, bnd in ((torch.float32, F32_BOUND),
                           (torch.float64, TILE_F64_BOUND)):
            model, state = bench_model(BENCH_N, dtype, dev, formulation)
            cases = [(f"bench {BENCH_N}^2", model, K.stack(state), BENCH_DT,
                      mesh) for mesh in ((2, 2), (4, 1), (1, 4))]
            model, state, sc = scenarios.build("128x128_low_B_low_U",
                                               formulation, dtype=dtype,
                                               device=dev)
            cases.append(("128x128_low_B_low_U", model, K.stack(state),
                          sc.dt, (4, 1)))
            for label, model, s, dt, mesh in cases:
                worst, bitwise = tile_against_substage(K, model, s, dt, mesh)
                b = K.branch_label(tile_branch(K, model, mesh))
                say(7, f"{label} {dtype} in {mesh[0]}x{mesh[1]} tiles "
                       f"[{b}]: tile kernel vs single-device kernel, G and "
                       f"state of substages 0 and 1: rel err {worst:.2e} "
                       f"(bound {bnd:g}); bitwise equal {bitwise}")
                if not worst <= bnd:
                    fail(f"tile kernel disagrees with the single-device "
                         f"kernel ({label}, {formulation}, {dtype}): "
                         f"{worst:.3e}")
            del cases, s
    # a biharmonic closure: the halo grows to model.exchange_halo = 7,
    # where the tiles must agree bit for bit; printed too, the narrower
    # halos 6 and 3 (the kernels' own composed radius is 3 for the
    # vector-invariant substage and 4 for the conservative one)
    for formulation in (VI, CONS):
        for dtype in (torch.float32, torch.float64):
            model, state = bench_model(BENCH_N, dtype, dev, formulation)
            model = with_options(model, "biharmonic", BENCH_DT)
            s = K.stack(state)
            halos = {}
            for H in (model.exchange_halo, 6, 3):
                halos[H] = tile_against_substage(K, model, s, BENCH_DT,
                                                 (2, 2), H)
            b = K.branch_label(tile_branch(K, model, (2, 2)))
            say(7, f"bench {BENCH_N}^2 {dtype} in 2x2 tiles [{b}]: tile "
                   f"kernel vs single-device kernel, G and state of "
                   f"substages 0 and 1, by halo: " + "; ".join(
                       f"{H}: rel err {w:.2e}, bitwise equal {bit}"
                       for H, (w, bit) in halos.items()))
            if not halos[model.exchange_halo][1]:
                fail(f"biharmonic tiles with a halo of "
                     f"{model.exchange_halo} differ from the single-device "
                     f"kernel ({formulation}, {dtype})")
            del s, state
    # the tile kernel against its plain version: wall-reaching fields at
    # 256², then one tile of each main-path layout (timed there too)
    for formulation in (VI, CONS):
        for topology, mesh in ((PERIODIC, (2, 2)), (BOUNDED_Y, (4, 1)),
                               (PERIODIC, (4, 1)), (PERIODIC, (1, 4))):
            gamma = -0.05 if "bounded" in topology else 0.0
            for dtype, bnd in ((torch.float64, TILE_F64_BOUND),
                               (torch.float32, F32_BOUND)):
                model, state = wall_model(SMOKE_N, dtype, dev, formulation,
                                          topology, gamma)
                tiles, halo = tile_layout(SMOKE_N, SMOKE_N, mesh)
                p = cut_tile(K.stack(state), tiles[-1], *halo)
                got, want = tile_pair(K, model, p, 0.005, halo)
                rel = max(rel_err(x, y) for x, y in zip(got, want))
                b = tile_branch(K, model, mesh)
                say(7, f"{SMOKE_N}^2 {dtype} [{K.branch_label(b)}] walls "
                       f"reached: tile kernel vs plain tile version, G and "
                       f"state of substages 0 and 1: rel err {rel:.2e}; "
                       f"bound {bnd:g}")
                if not (finite(got) and rel <= bnd):
                    fail(f"tile kernel disagrees with its plain version "
                         f"[{K.branch_label(b)}], {dtype}: {rel:.3e}")
    # At the main path's tiles G is held two ways. In float64 the kernel
    # must match the plain version (<= F64_BOUND): the arithmetic is the
    # same. In float32 it must match within F32_BOUND or be no farther
    # from the float64 plain G than twice the float32 plain G is: at 2048²
    # the differences that make G lose digits to float32 rounding ~8x as
    # fast as at 256², so two float32 evaluations in another order differ
    # by more than F32_BOUND of G's scale. The states hold F32_BOUND.
    tile_errors = {}      # branch -> f32 max abs err at the main path's tile
    for formulation in (VI, CONS):
        c = int(formulation == CONS)
        cases = []
        for dtype in (torch.float32, torch.float64):
            model, state = bench_model(BENCH_N, dtype, dev, formulation)
            tiles, halo = tile_layout(BENCH_N, BENCH_N, (2, 2))
            cases.append((model, cut_tile(K.stack(state), tiles[0], *halo)))
        del state
        main_tiles = [(f"{BENCH_N}^2 in 2x2 tiles", *cases[0], cases[1][0],
                       halo, BENCH_DT, K.Branch(c, E, E), 20)]
        # 128x128_low_B_low_U in 4x1 tiles, and with the closure of the
        # decomposed CLI run (vector-invariant: biharmonic, halo 7)
        closures = [None] + ([cli_closure(CLOSURE_FLAGS[VI])]
                             if formulation == VI else [])
        for closure in closures:
            cases = []
            for dtype in (torch.float32, torch.float64):
                model, state, sc = scenarios.build(
                    "128x128_low_B_low_U", formulation, dtype=dtype,
                    device=dev, closure=closure)
                tiles, halo = tile_layout(128, 128, (4, 1),
                                          model.exchange_halo)
                cases.append((model,
                              cut_tile(K.stack(state), tiles[0], *halo)))
            main_tiles.append((
                "128x128_low_B_low_U in 4x1 tiles" + (
                    " biharmonic" if closure else ""),
                *cases[0], cases[1][0], halo, sc.dt,
                tile_branch(K, cases[0][0], (4, 1)), 100))
        del cases
        for label, model, p, model64, halo, dt, b, reps in main_tiles:
            K.substage(model, p, dt, 0, halo=halo)
            ms, _ = timed(lambda: K.substage(model, p, dt, 0, halo=halo),
                          reps)
            plain_ms, plain0 = timed(lambda: K.substage_reference(
                model, p, dt, 0, None, halo), max(reps // 10, 3))
            got, want = tile_pair(K, model, p, dt, halo, plain0)
            got64, want64 = tile_pair(K, model64, p.double(), dt, halo)
            g_err = rel_err(got[0], want[0])
            g_kernel, g_plain = (rel_err(got[0], want64[0]),
                                 rel_err(want[0], want64[0]))
            s_err = max(rel_err(x, y) for x, y in zip(got[1:], want[1:]))
            f64_err = max(rel_err(x, y) for x, y in zip(got64, want64))
            tile_errors[b] = max(float((x - y).abs().max())
                                 for x, y in zip(got, want))
            nx, ny = p.shape[1] - 2 * halo[0], p.shape[2] - 2 * halo[1]
            line = (f"tile substage f32 {formulation}, {label} "
                    f"({tuple(p.shape[1:])} read, ({nx}, {ny}) written) on "
                    f"{smi}: {ms:.4f} ms; plain tile version {plain_ms:.4f} "
                    f"ms; kernel vs plain (substages 0 and 1): f32 G rel "
                    f"err {g_err:.2e}, against the f64 plain G kernel "
                    f"{g_kernel:.2e} / plain {g_plain:.2e}; f32 state "
                    f"{s_err:.2e} (bound {F32_BOUND:g}); f64 G and state "
                    f"{f64_err:.2e} (bound {F64_BOUND:g}); f32 max abs err "
                    f"{tile_errors[b]:.3e}")
            if b[2] == E:
                # the whole-domain substage on a grid of the tile's size
                half, hstate = bench_model(nx, torch.float32, dev,
                                           formulation)
                hs = K.stack(hstate)
                K.substage(half, hs, dt, 0)
                single_ms, _ = timed(lambda: K.substage(half, hs, dt, 0),
                                     reps)
                line += (f"; single-device substage on a {nx}^2 grid "
                         f"{single_ms:.4f} ms (ratio {ms / single_ms:.3f})")
            say(7, line)
            if not (finite(got) and s_err <= F32_BOUND
                    and f64_err <= F64_BOUND
                    and (g_err <= F32_BOUND or g_kernel <= 2 * g_plain)):
                fail(f"tile kernel disagrees with its plain version at the "
                     f"main path's shape ({label}, {formulation})")
            timings[b] = {"swmhd_substage": dict(
                ms=ms, plain_ms=plain_ms,
                nbytes=4 * (4 * p.shape[1] * p.shape[2] + 8 * nx * ny),
                points=nx * ny, per="substage", shape=(nx, ny))}
        del main_tiles, p, got, want, got64, want64
    profile_substages(K, dev, smi)

    # 8 -------------------------------------------------------------------
    tile_launches = {}    # branch -> launches over all ranks of phase 8
    with tempfile.TemporaryDirectory() as tmp:
        decomposed_bench(K, WORLD, tmp, smi, tile_launches)
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            decomposed_bench(K, n_cards, os.path.join(tmp, "nccl"), smi,
                             tile_launches, backend="nccl")
        else:
            say(8, f"NCCL not exercised: this machine has {n_cards} card; "
                   f"the {WORLD} ranks above shared it over gloo")
        for formulation in (VI, CONS):
            decomposed_cli(K, cli, formulation, tmp, tile_launches)
        decomposed_cli(K, cli, VI, tmp, tile_launches, CLOSURE_FLAGS[VI])
    dd_branches = ([K.Branch(c, E, y) for c in (0, 1) for y in (E, B)]
                   + [K.Branch(0, E, B, closure=2)])
    for b in dd_branches:
        if not tile_launches.get(b):
            fail(f"swmhd_substage [{K.branch_label(b)}] was not "
                 f"launched on the decomposed main path")
    say(8, "decomposed main-path launches by branch: " + json.dumps(
        {K.branch_label(b): n for b, n in tile_launches.items()}))

    # 9 -------------------------------------------------------------------
    t9 = time.perf_counter()
    tile_entries = tiles_phase(smi)
    say(9, f"phase 9 took {time.perf_counter() - t9:.1f} s; the script "
           f"{time.perf_counter() - t_start:.1f} s so far")

    # 10 ------------------------------------------------------------------
    adaptive_phase(K, dev, smi, bench[(VI, None)][2])
    say(10, f"the script {time.perf_counter() - t_start:.1f} s so far")

    # 11 ------------------------------------------------------------------
    validation_phase(K, dev, smi)
    say(11, f"the script {time.perf_counter() - t_start:.1f} s so far")

    # 12 ------------------------------------------------------------------
    resident_phase(K, dev, smi)
    say(12, f"the script {time.perf_counter() - t_start:.1f} s so far")

    # 13 ------------------------------------------------------------------
    bench_phase(K, dev, smi)
    say(13, f"the script {time.perf_counter() - t_start:.1f} s so far")

    if "jax" in sys.modules:
        fail("jax was imported")
    ops = {}              # (branch, per) -> operations per point
    kernels = []
    for b, entries in sorted(timings.items()):
        for name, t in sorted(entries.items()):
            if (b, t["per"]) not in ops:
                ops[(b, t["per"])] = ops_per_point(K, b, t["per"])
            bound_ms, bound_by = least_time(t["nbytes"],
                                       ops[(b, t["per"])] * t["points"])
            tile = E in b[1:3]
            n_launches = (tile_launches if tile else launches[name]).get(b)
            if not n_launches:
                fail(f"{name} [{K.branch_label(b)}] was timed but not "
                     f"launched on the main path")
            kernels.append({
                "name": f"{name} [{K.branch_label(b)}]", "route": "cuda",
                "source": SOURCES[CONS if b[0] else VI],
                "replaces": TILE_REPLACES if tile else REPLACES[name],
                "launches": n_launches,
                "max_abs_err": (tile_errors[b] if tile else
                                errors[b][name == "swmhd_multistep"]),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                **design(K, b, t["shape"], name == "swmhd_multistep")})
            say("kernels", f"{kernels[-1]['name']} at {t['shape']}: "
                + json.dumps({k: v for k, v in kernels[-1].items()
                              if k not in ("name", "route", "source",
                                           "replaces", "library_ms")}))
    kernels += tile_entries
    say("bounds", "float32 operations per point of the plain versions "
        "(substage 0 / RK3 step): " + "; ".join(
            f"[{K.branch_label(b)}] {per} {n:.1f}"
            for (b, per), n in sorted(ops.items())))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2:])
    else:
        main()
