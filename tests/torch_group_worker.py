"""One rank of a gloo group on the CPU for tests/test_torch_wizard.py and
tests/test_torch_profiling.py:

    python tests/torch_group_worker.py <task> <rank> <world> <port> <workdir>

``wizard`` (4 ranks, a 2×2 mesh): a Simulation of WIZARD_SCENARIO through
the decomposed kernel stepper (its plain tile version on the CPU) with a
TimeStepWizard and a ScalarWriter whose outputs reduce over ranks; writes
each rank's Δt history and CFL numbers (``wizard_rank<r>.json``), and
rank 0 the gathered final state (``wizard.npz``) and the CSV.

``overlap`` (2 ranks, a 2×1 mesh): ``profiling.measure_overlap`` of one
decomposed step; writes ``overlap_rank<r>.json``.

``order`` (2 ranks, a 2×1 mesh): a Simulation through the decomposed
kernel stepper with the energy series and a progress report every
ORDER_EVERY steps; writes the order of the stepper's calls and the
reports (``("step" | "fire", iteration)``) and the run's counts of chunks
queued ahead, kept and discarded (``order_rank<r>.json``).

Prints TORCH-GROUP-OK at the end. :func:`run_group` starts a group and
returns the ranks' reports.
"""

import json
import os
import socket
import subprocess
import sys

WIZARD_SCENARIO = "64x64_two_Gaussians_high_B"
# (initial dt, wizard cfl, wizard cadence, steps): the initial dt is above
# the target CFL, so the wizard shrinks it at once and then follows the flow
WIZARD_RUN = (0.03, 0.2, 5, 15)
OVERLAP_N, OVERLAP_DT = 32, 0.005
ORDER_STEPS, ORDER_EVERY = 6, 2


def wizard_simulation(model, stepper, csv_path, record):
    """The Simulation both the decomposed run and the single-process run
    of the test drive: the wizard (recording ``sim.dt`` into ``record``
    after each adjustment) and a ScalarWriter of the total energy and
    the CFL numbers, read through ``sim.diagnose``."""
    from swmhd_tpu_torch import diagnostics
    from swmhd_tpu_torch.io import ScalarWriter
    from swmhd_tpu_torch.simulation import (Callback, IterationInterval,
                                            Simulation, TimeStepWizard)
    dt, cfl, every, steps = WIZARD_RUN
    sim = Simulation(model, dt=dt, stop_iteration=steps, stepper=stepper)
    wizard = TimeStepWizard(cfl=cfl)

    def adjust(s):
        wizard(s)
        record.append(s.dt)
    sim.callbacks["wizard"] = Callback(adjust, IterationInterval(every))

    def report(s):
        def fn(st):
            u, v = model.velocities(st)
            h0 = st.h.new_ones(())
            adv, wave = diagnostics.cfl_numbers(model, st, s.dt)
            return {"total_energy": diagnostics.total_energy(
                u, v, st.h, st.A, h0, model.gravitational_acceleration,
                model.grid, model.A_background_gradient_y),
                "advective_cfl": adv, "wave_cfl": wave}
        return s.diagnose(fn)

    sim.output_writers["scalars"] = ScalarWriter(
        {name: (lambda n: lambda s: report(s)[n])(name)
         for name in ("total_energy", "advective_cfl", "wave_cfl")},
        IterationInterval(every), csv_path)
    return sim


def run_group(task, world, workdir, timeout=300):
    """Runs ``world`` ranks of this worker's ``task`` in ``workdir``; the
    ranks' reports."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         port, str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "TORCH-GROUP-OK" in out, \
            f"rank {r}:\n{out}"
    reports = []
    for r in range(world):
        with open(os.path.join(workdir, f"{task}_rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def main():
    task, rank, world, port, workdir = (sys.argv[1], int(sys.argv[2]),
                                        int(sys.argv[3]), sys.argv[4],
                                        sys.argv[5])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from swmhd_tpu_torch import diagnostics, profiling, scenarios
    from swmhd_tpu_torch.convert import state_to_numpy
    from swmhd_tpu_torch.parallel import (DomainDecomposition, initialize,
                                          make_mesh)
    from swmhd_tpu_torch.parallel import multihost

    initialize("cpu")
    report = {}
    if task == "wizard":
        model, state, _ = scenarios.build(WIZARD_SCENARIO,
                                          dtype=torch.float64, device="cpu")
        dd = DomainDecomposition(model, make_mesh(shape=(2, 2)))
        history = []
        sim = wizard_simulation(model, dd.fused_stepper(),
                                os.path.join(workdir, "wizard.csv"),
                                history)
        tile = sim.run(dd.shard_state(state))
        final = dd.gather_state(tile)
        sim.state = tile
        tiled = sim.diagnose(lambda s: dict(zip(
            ("advective", "wave"), diagnostics.cfl_numbers(model, s,
                                                           sim.dt))))
        report = {"dt_history": history,
                  "tiled_cfl": [float(tiled["advective"]),
                                float(tiled["wave"])],
                  "global_cfl": [float(c) for c in diagnostics.cfl_numbers(
                      model, final, sim.dt)]}
        if rank == 0:
            import numpy as np
            np.savez(os.path.join(workdir, "wizard.npz"),
                     **state_to_numpy(final))
    elif task == "overlap":
        from port_cases import bench_model
        model, state = bench_model(OVERLAP_N, torch.float64, "cpu")
        dd = DomainDecomposition(model, make_mesh(shape=(world, 1)))
        report = profiling.measure_overlap(
            dd.fused_step_fn(OVERLAP_DT, 1), dd.shard_state(state))
    elif task == "order":
        from port_cases import bench_model
        from swmhd_tpu_torch.io import ScalarSeriesWriter
        from swmhd_tpu_torch.simulation import (
            Callback, IterationInterval, Simulation, progress_callback)
        model, state = bench_model(OVERLAP_N, torch.float64, "cpu")
        dd = DomainDecomposition(model, make_mesh(shape=(world, 1)))
        tile = dd.shard_state(state)
        h0 = dd.diagnostic_view(tile).h
        log = []

        class Logged:
            def __init__(self, inner):
                self.inner = inner
                self.tile_diagnostics = inner.tile_diagnostics

            def step_fn(self, dt, n_steps=1, diagnostics=None):
                fn = self.inner.step_fn(dt, n_steps, diagnostics)

                def logged(st):
                    log.append(("step", st.clock.iteration))
                    return fn(st)
                return logged
        sim = Simulation(model, dt=OVERLAP_DT, stop_iteration=ORDER_STEPS,
                         stepper=Logged(dd.fused_stepper()))
        progress = progress_callback()

        def report(s):
            progress(s)
            log.append(("fire", s.state.clock.iteration))
        sim.callbacks["progress"] = Callback(report,
                                             IterationInterval(ORDER_EVERY))
        sim.output_writers["energies"] = ScalarSeriesWriter(
            fn=lambda m, s: diagnostics.energy_report(m, s, h0),
            schedule=IterationInterval(1),
            path=os.path.join(workdir, f"order_rank{rank}.csv"))
        sim.run(tile)
        report = {"log": log, "kept": sim.ahead_kept,
                  "discarded": sim.ahead_discarded}
    else:
        raise SystemExit(f"unknown task {task!r}")
    with open(os.path.join(workdir, f"{task}_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    multihost.shutdown()
    print("TORCH-GROUP-OK", flush=True)


if __name__ == "__main__":
    main()
