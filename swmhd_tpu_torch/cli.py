"""Command-line runner for named scenarios, port of :mod:`swmhd_tpu.cli`:

    python -m swmhd_tpu_torch.cli list
    python -m swmhd_tpu_torch.cli run 128x128_two_Gaussians_high_B \
        --outdir runs/high_B                  # on the GPU, CUDA kernel
    python -m swmhd_tpu_torch.cli run 64x64_two_Gaussians_high_B \
        --device cpu --dtype float64          # plain PyTorch on the CPU
    torchrun --nproc-per-node 4 -m swmhd_tpu_torch.cli run \
        128x128_low_B_low_U                   # decomposed, one tile a rank
    python -m swmhd_tpu_torch.cli run 128x128_two_Gaussians_high_B \
        --nu 1e-5 --kappa 1e-5 --biharmonic   # with a closure
    torchrun --nproc-per-node 4 -m -- swmhd_tpu_torch.cli run \
        128x128_low_B_low_U --nu 1e-5 --biharmonic
                                          # "--": torchrun would read --nu
                                          # as its --numa-binding

On one card the run steps through the resident kernel where the state
fits the card's L2, else through one-substage launches, each chunk with
the energy series replayed from CUDA graphs
(:class:`~swmhd_tpu_torch.ops.substage.KernelStepper`). Under
``torchrun`` (``WORLD_SIZE`` > 1) the run is decomposed over the ranks: the process group's backend follows the device layout
(``parallel.multihost.initialize``), the mesh is the squarest
factorisation of the world, or ``(world, 1)`` when y is bounded (as in
the JAX package's CLI), and each substage runs the CUDA tile substage on
the exchanged tile (the plain step on tiles with ``--no-fused`` or on the
CPU). Fields are written as per-rank slabs and checkpoints as sharded
directories; rank 0 writes ``energies.csv`` and the gathered
``final.npz``, and with ``--movie`` renders after every rank has closed
its writers.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch


def _add_run_args(p):
    p.add_argument("scenario")
    p.add_argument("--formulation", default="vector_invariant",
                   choices=["vector_invariant", "conservative"])
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--stop-time", type=float, default=None)
    p.add_argument("--outdir", default=None)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--fields-interval", type=float, default=0.1,
                   help="TimeInterval for field snapshots (reference: 0.1)")
    p.add_argument("--energies-every", type=int, default=1,
                   help="IterationInterval for energy series (reference: 1)")
    p.add_argument("--progress-every", type=int, default=100)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="iterations between checkpoints (0 = off)")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from: a file, or the "
                        "directory of a sharded checkpoint")
    p.add_argument("--movie", action="store_true",
                   help="render the A/speed movie and the energy plot "
                        "after the run (needs matplotlib; the movie is an "
                        "mp4 through ffmpeg or cv2, else .png frames)")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on CUDA, step through the hand-written kernels "
                        "(default: the resident kernel where the state fits "
                        "the card's L2, chunks with a series as CUDA "
                        "graphs); --no-fused runs the plain "
                        "PyTorch step")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--nu", type=float, default=0.0,
                   help="momentum diffusivity (Laplacian; biharmonic with "
                        "--biharmonic)")
    p.add_argument("--kappa", type=float, default=0.0,
                   help="tracer diffusivity")
    p.add_argument("--biharmonic", action="store_true",
                   help="use -nu grad^4 / -kappa grad^4 instead of "
                        "Laplacian diffusion")


def closure_of(args):
    """The closure the flags ask for: none unless ``--nu`` or ``--kappa``
    is nonzero."""
    if not (args.nu or args.kappa):
        return None
    from .physics.diffusion import LaplacianDiffusion, BiharmonicDiffusion
    cls = BiharmonicDiffusion if args.biharmonic else LaplacianDiffusion
    return cls(nu=args.nu, kappa=args.kappa)


def cmd_list(_args):
    from . import scenarios
    for name in scenarios.names():
        sc = scenarios.get(name)
        print(f"{name:34s} N={sc.N:<5d} stop_time={sc.stop_time:<6g} "
              f"{sc.description}")


ENERGY_NAMES = ("kinetic_energy", "magnetic_energy", "potential_energy",
                "total_energy", "cross_helicity")


def energies(model, state, h0):
    """The run's energy series: the :data:`ENERGY_NAMES` of
    :func:`~swmhd_tpu_torch.diagnostics.energy_report`, computed alone
    from one evaluation of the velocities (the JAX CLI keeps the same five
    of the report under ``jax.jit``, which never computes the rest)."""
    from . import diagnostics
    g = model.grid
    gamma = model.A_background_gradient_y
    u, v = model.velocities(state)
    ke = diagnostics.kinetic_energy(u, v, state.h, g)
    me = diagnostics.magnetic_energy(state.A, state.h, g, gamma)
    pe = diagnostics.potential_energy(state.h, h0,
                                      model.gravitational_acceleration, g)
    return {"kinetic_energy": ke, "magnetic_energy": me,
            "potential_energy": pe, "total_energy": ke + me + pe,
            "cross_helicity": diagnostics.cross_helicity(
                u, v, state.A, state.h, g, gamma)}


def select_stepper(model, fused: bool = True, dd=None):
    """``(stepper, label)``; ``stepper=None`` is the plain PyTorch step.
    With a domain decomposition ``dd`` the plain step is ``dd`` and the
    kernel its ``fused_stepper()``.

    On CUDA with ``fused`` the run goes through the CUDA kernel, and a
    configuration the kernel does not cover raises ``ValueError`` (no
    silent plain run). On the CPU there is no kernel to select."""
    if not fused:
        return dd, "plain"
    if torch.device(model.grid.device).type != "cuda":
        logging.info("no CUDA kernel on %s; plain PyTorch step",
                     model.grid.device)
        return dd, "plain"
    if dd is not None:
        return dd.fused_stepper(), "kernel"
    from .ops.substage import KernelStepper
    return KernelStepper(model), "kernel"


def _decomposition(model):
    """The domain decomposition of a run under ``torchrun``: one tile per
    rank, y unsharded when it is bounded."""
    from .grid import PERIODIC
    from .parallel import multihost
    from .parallel.decomposition import DomainDecomposition, make_mesh
    world = multihost.world_size()
    shape = (world, 1) if model.grid.topology_y != PERIODIC else None
    dd = DomainDecomposition(model, make_mesh(shape=shape))
    logging.info("decomposed over a %dx%d mesh of ranks, halo %d", dd.px,
                 dd.py, dd.halo)
    return dd


def cmd_run(args):
    from . import scenarios, checkpoint
    from . import operators as op
    from .simulation import (
        Simulation, IterationInterval, TimeInterval, Callback,
        progress_callback)
    from .io import FieldWriter, ScalarSeriesWriter

    from .parallel import multihost
    from .parallel.decomposition import make_mesh

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    if args.movie:
        import matplotlib  # noqa: F401  (raises before the run, not after)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available "
                           "(use --device cpu for the plain CPU path)")
    device = args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = multihost.initialize(args.device)
        if multihost.rank() != 0:
            logging.getLogger().setLevel(logging.WARNING)

    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    model, state, sc = scenarios.build(args.scenario, args.formulation,
                                       dtype=dtype, device=device,
                                       closure=closure_of(args))
    dt = args.dt if args.dt is not None else sc.dt
    stop_time = args.stop_time if args.stop_time is not None else sc.stop_time
    dd = _decomposition(model) if multihost.world_size() > 1 else None
    mesh = dd.mesh if dd is not None else make_mesh(shape=(1, 1))

    # potential energy is measured against the scenario's t = 0 height,
    # captured before a resume replaces the state; a decomposed run holds
    # it as the tile its diagnostics see
    if dd is not None:
        state = dd.shard_state(state)
        h0 = dd.diagnostic_view(state).h
    else:
        h0 = state.h
    if args.resume and os.path.isdir(args.resume):
        state = checkpoint.restore_sharded(args.resume, model.grid, mesh)
    elif args.resume:
        state = checkpoint.restore(args.resume, model.grid)
        if dd is not None:
            state = dd.shard_state(state)

    outdir = args.outdir or os.path.join(
        "runs", f"{args.scenario}_{args.formulation}")
    os.makedirs(outdir, exist_ok=True)

    stepper, path = select_stepper(model, args.fused, dd)
    logging.info("stepper: %s", path)
    sim = Simulation(model, dt=dt, stop_time=stop_time, stepper=stepper)
    sim.callbacks["progress"] = Callback(
        progress_callback(), IterationInterval(args.progress_every))

    def field_outputs():
        # one evaluation per snapshot shared by all five outputs
        cache = {}

        def compute(st):
            u, v = model.velocities(st)
            g = model.grid
            s = torch.sqrt(op.ix_c(u, g) ** 2 + op.iy_c(v, g) ** 2)
            return {"A": st.A, "h": st.h, "u": u, "v": v, "s": s}

        if dd is not None:
            compute = dd.tile_fields(compute)

        def getter(name):
            def fn(sim):
                if cache.get("key") is not sim.state:
                    cache["key"] = sim.state
                    cache["val"] = compute(sim.state)
                return cache["val"][name]
            return fn
        return {name: getter(name) for name in ("A", "h", "u", "v", "s")}

    sim.output_writers["fields"] = FieldWriter(
        outputs=field_outputs(),
        schedule=TimeInterval(args.fields_interval),
        path=os.path.join(outdir, "fields"), decomposition=dd)

    def energy_series(model, state):
        return energies(model, state, h0)

    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=energy_series,
        schedule=IterationInterval(args.energies_every),
        path=os.path.join(outdir, "energies.csv"))

    if args.checkpoint_every:
        def ckpt(s):
            if dd is None:
                checkpoint.save(os.path.join(outdir, "checkpoint.npz"),
                                s.state, s.model.grid)
            else:
                checkpoint.save_sharded(os.path.join(outdir, "checkpoint"),
                                        s.state, s.model.grid, dd.mesh)
        sim.callbacks["checkpoint"] = Callback(
            ckpt, IterationInterval(args.checkpoint_every))

    final = sim.run(state)
    if dd is not None:
        final = dd.gather_state(final)
    if multihost.rank() == 0:
        checkpoint.save(os.path.join(outdir, "final.npz"), final, model.grid)
        print(f"done: {outdir} ({sim.run_wall_time:.1f}s wall, {path})")
    if args.movie:
        multihost.sync("movie")
        if multihost.rank() == 0:
            from .viz import render_scenario_outputs
            made = render_scenario_outputs(outdir, title=args.scenario)
            print(f"rendered: {', '.join(made)}")
    multihost.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="swmhd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list").set_defaults(func=cmd_list)
    runp = sub.add_parser("run")
    _add_run_args(runp)
    runp.set_defaults(func=cmd_run)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
