"""One rank of the gloo group of tests/test_torch_parallel.py, on the CPU:

    python tests/torch_dist_worker.py <rank> <world> <port> <workdir>

Joins the group through the environment ``torchrun`` would set, reads the
global initial states the test made with the JAX package
(``<workdir>/inputs.npz``), runs every decomposed check below on 64²
float64 tiles and writes what rank 0 gathered to ``<workdir>`` for the
test to hold against the JAX package. Checks that need no reference
assert here. Prints TORCH-DIST-OK at the end.
"""

import os
import sys

import numpy as np

N, DT, STEPS = 64, 0.005, 3
TOPOLOGIES = {"PP": ("periodic", "periodic"), "PB": ("periodic", "bounded"),
              "BB": ("bounded", "bounded")}
FORMULATIONS = ("vector_invariant", "conservative")
# (formulation, topology key, mesh) of the plain decomposed step
PLAIN = [(f, t, m) for f in FORMULATIONS for t in ("PB", "BB")
         for m in ((2, 2), (4, 1))] + [("vector_invariant", "PP", (2, 2))]
# (formulation, topology key, mesh) of the kernel stepper (plain tile
# version on the CPU); the low_B_low_U scenario runs at (4, 1) besides
FUSED = [(f, "PP", (2, 2)) for f in FORMULATIONS] + [
    ("vector_invariant", "PP", (1, 4))]
# (formulation, topology key, mesh) with a biharmonic closure, by the
# plain step and the kernel stepper: the halo grows to 7
BIHARMONIC = [("vector_invariant", "PP", (2, 2)),
              ("conservative", "PB", (4, 1))]
BIHARMONIC_NU = 5e-4       # ν·dt/dx⁴ ≈ 0.004 at 64²
# (kind, formulation, topology key, options) of the overlap split on a 2x2
# mesh (32² tiles: 3·halo <= 32 at halo 6 and 7): the plain step ("plain")
# and the kernel stepper ("fused", its plain tile version here)
OVERLAP = [("plain", "vector_invariant", "PP", None),
           ("plain", "vector_invariant", "PB", None),
           ("plain", "vector_invariant", "BB", None),
           ("plain", "conservative", "PP", None),
           ("fused", "vector_invariant", "PP", None),
           ("fused", "conservative", "PP", None),
           ("fused", "vector_invariant", "PP", "biharmonic")]
SCENARIO = "64x64_low_B_low_U"
SERIES_STEPS = 4
FIELD_STEPS, FIELD_EVERY = 2 * STEPS, STEPS


def gamma(topo):
    return -0.05 if "B" in topo else 0.0


def key(formulation, topo):
    return f"{formulation}_{topo}"


def name(kind, formulation, topo, mesh):
    return f"{kind}_{formulation}_{topo}_{mesh[0]}x{mesh[1]}"


def overlap_name(kind, formulation, topo, options, overlap=True):
    return (f"{'overlap' if overlap else 'ordinary'}_{kind}_{formulation}_"
            f"{topo}" + (f"_{options}" if options else ""))


def main():
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import dataclasses
    import torch
    torch.set_num_threads(1)
    import swmhd_tpu_torch
    from chip_smoke import bench_model, option_kwargs
    from swmhd_tpu_torch import checkpoint, diagnostics, scenarios
    from swmhd_tpu_torch.convert import state_from_numpy, state_to_numpy
    from swmhd_tpu_torch.io import FieldWriter, ScalarSeriesWriter
    from swmhd_tpu_torch.ops import substage as K
    from swmhd_tpu_torch.parallel import multihost
    from swmhd_tpu_torch.parallel.decomposition import (
        DomainDecomposition, make_mesh)
    from swmhd_tpu_torch.simulation import Simulation, IterationInterval

    multihost.initialize("cpu")
    assert multihost.world_size() == world
    inputs = np.load(os.path.join(workdir, "inputs.npz"))

    def case(formulation, topo):
        model = bench_model(N, torch.float64, "cpu", formulation,
                            TOPOLOGIES[topo], gamma(topo))[0]
        k = key(formulation, topo)
        state = state_from_numpy({f: inputs[f"{k}_{f}"] for f in "huvA"},
                                 device="cpu", dtype=torch.float64)
        return model, state

    def save(label, state):
        if rank == 0:
            np.savez(os.path.join(workdir, label + ".npz"),
                     **state_to_numpy(state))

    # -- the padded tile is the global wrap (periodic) or clamp (bounded)
    # slice, corners included
    rng = np.random.default_rng(3)
    glob = rng.standard_normal((4, N, N))
    for topo, mesh, H in (("PP", (2, 2), 6), ("BB", (2, 2), 6),
                          ("PB", (4, 1), 2)):
        model = bench_model(N, torch.float64, "cpu", topology=TOPOLOGIES[topo],
                            gamma=gamma(topo))[0]
        dd = DomainDecomposition(model, make_mesh(shape=mesh), halo=H)
        x0, x1, y0, y1 = dd.bounds
        got = dd.pad(torch.as_tensor(glob[:, x0:x1, y0:y1]).contiguous())
        want = glob
        for axis, (lo, hi), t in ((1, (x0, x1), TOPOLOGIES[topo][0]),
                                  (2, (y0, y1), TOPOLOGIES[topo][1])):
            want = np.take(want, np.arange(lo - H, hi + H), axis=axis,
                           mode="wrap" if t == "periodic" else "clip")
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"pad {topo} {mesh}")
        np.testing.assert_array_equal(dd.crop(got).numpy(),
                                      glob[:, x0:x1, y0:y1])

    # -- the plain decomposed step, every topology
    for formulation, topo, mesh in PLAIN:
        model, state = case(formulation, topo)
        dd = DomainDecomposition(model, make_mesh(shape=mesh))
        out = dd.step_fn(DT, STEPS)(dd.shard_state(state))
        save(name("plain", formulation, topo, mesh), dd.gather_state(out))
        if (formulation, topo, mesh) == ("vector_invariant", "PP", (2, 2)):
            # sharded checkpoint of the 3-step state; restored under
            # another layout it resumes to the 6-step state
            ck = os.path.join(workdir, "ck_port")
            checkpoint.save_sharded(ck, out, model.grid, dd.mesh)
            dd41 = DomainDecomposition(model, make_mesh(shape=(4, 1)))
            back = checkpoint.restore_sharded(ck, model.grid, dd41.mesh)
            assert back.clock.iteration == STEPS, back.clock
            assert torch.equal(K.stack(dd41.gather_state(back)),
                               K.stack(dd.gather_state(out)))
            save("resumed_4x1", dd41.gather_state(
                dd41.step_fn(DT, STEPS)(back)))

    # -- the kernel stepper (its plain tile version here) and its rules
    K.reset_counters()
    for formulation, topo, mesh in FUSED:
        model, state = case(formulation, topo)
        dd = DomainDecomposition(model, make_mesh(shape=mesh))
        # an unsharded axis is not padded: the kernel wraps it in place
        assert dd.kernel_halo() == tuple(6 if n > 1 else 0 for n in mesh)
        out = dd.fused_step_fn(DT, STEPS)(dd.shard_state(state))
        save(name("fused", formulation, topo, mesh), dd.gather_state(out))
    model, state, sc = scenarios.build(SCENARIO, dtype=torch.float64,
                                       device="cpu")
    dd = DomainDecomposition(model, make_mesh(shape=(4, 1)))
    out = dd.fused_stepper().step_fn(sc.dt, STEPS)(dd.shard_state(state))
    save("fused_scenario_4x1", dd.gather_state(out))
    assert K.substage_reference.calls == 3 * STEPS * (len(FUSED) + 1), \
        K.substage_reference.calls
    assert K.substage.launches == 0
    try:
        DomainDecomposition(model, make_mesh(shape=(2, 2))).fused_stepper()
    except ValueError as e:
        assert "py == 1" in str(e), e
    else:
        raise AssertionError("bounded y on a sharded y axis was accepted")

    # -- both steppers with a biharmonic closure, on a halo of 7
    for formulation, topo, mesh in BIHARMONIC:
        model, state = case(formulation, topo)
        model = dataclasses.replace(model, **option_kwargs(
            "biharmonic", swmhd_tpu_torch, BIHARMONIC_NU))
        dd = DomainDecomposition(model, make_mesh(shape=mesh))
        assert dd.halo == 7, dd.halo
        assert dd.kernel_halo() == tuple(7 if n > 1 else 0 for n in mesh)
        for kind, fn in (("plain", dd.step_fn), ("fused", dd.fused_step_fn)):
            out = fn(DT, STEPS)(dd.shard_state(state))
            save(name(f"biharmonic_{kind}", formulation, topo, mesh),
                 dd.gather_state(out))

    # -- the overlap split (2x2 mesh) beside the ordinary step; on a 4x1
    # mesh (16-row tiles, 3·6 > 16) the rule refuses it
    for kind, formulation, topo, options in OVERLAP:
        model, state = case(formulation, topo)
        if options:
            model = dataclasses.replace(model, **option_kwargs(
                options, swmhd_tpu_torch, BIHARMONIC_NU))
        for overlap in (False, True):
            dd = DomainDecomposition(model, make_mesh(shape=(2, 2)),
                                     overlap=overlap)
            assert dd.split == overlap, (overlap, dd.split)
            fn = dd.step_fn if kind == "plain" else dd.fused_step_fn
            K.reset_counters()
            out = fn(DT, STEPS)(dd.shard_state(state))
            if kind == "fused":
                # a substage: the interior and four bands, or one launch
                assert K.substage_reference.calls == (
                    (5 if overlap else 1) * 3 * STEPS), \
                    K.substage_reference.calls
            save(overlap_name(kind, formulation, topo, options, overlap),
                 dd.gather_state(out))
    model, state = case("vector_invariant", "PP")
    refused = {}
    for overlap in (False, True):
        dd = DomainDecomposition(model, make_mesh(shape=(4, 1)),
                                 overlap=overlap)
        assert not dd.split and dd.overlap == overlap
        tile = dd.shard_state(state)
        K.reset_counters()
        refused[overlap] = [K.stack(fn(DT, STEPS)(tile))
                            for fn in (dd.step_fn, dd.fused_step_fn)]
        assert K.substage_reference.calls == 3 * STEPS
    assert all(torch.equal(a, b) for a, b in zip(*refused.values()))

    # -- a Simulation with an energy series through both steppers
    model, state = case("vector_invariant", "PP")
    dd = DomainDecomposition(model, make_mesh(shape=(2, 2)))
    tile = dd.shard_state(state)
    h0 = dd.diagnostic_view(tile).h
    for label, stepper in (("plain", dd), ("fused", dd.fused_stepper())):
        sim = Simulation(model, dt=DT, stop_iteration=SERIES_STEPS,
                         stepper=stepper)
        sim.output_writers["energies"] = ScalarSeriesWriter(
            fn=lambda m, s: diagnostics.energy_report(m, s, h0),
            schedule=IterationInterval(1),
            path=os.path.join(workdir, f"series_{label}.csv"))
        save(f"series_{label}", dd.gather_state(sim.run(tile)))

    # -- FieldWriter slabs of a decomposed run
    sim = Simulation(model, dt=DT, stop_iteration=FIELD_STEPS, stepper=dd)
    sim.output_writers["fields"] = FieldWriter(
        outputs={"A": lambda s: s.state.A, "h": lambda s: s.state.h},
        schedule=IterationInterval(FIELD_EVERY),
        path=os.path.join(workdir, "fields"), decomposition=dd)
    sim.run(tile)

    # -- a sharded checkpoint the JAX package wrote (one slab), restored
    # under a 4x1 layout
    dd41 = DomainDecomposition(model, make_mesh(shape=(4, 1)))
    back = checkpoint.restore_sharded(os.path.join(workdir, "ck_jax"),
                                      model.grid, dd41.mesh)
    save("jax_restored_4x1", dd41.gather_state(back))

    multihost.shutdown()
    print("TORCH-DIST-OK", flush=True)


if __name__ == "__main__":
    main()
