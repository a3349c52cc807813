"""``Simulation.run``'s run-ahead: chunk n+1 queued before chunk n's rows
and callbacks, held against the loop that takes chunks in order (a
stepper with ``tile_diagnostics``, as a decomposed run's has).

- A series run gives the same CSV bytes, the same final state, and the
  same state and clock at each callback; every chunk is queued ahead and
  kept; the stepper is called for chunk n+1 before chunk n's callbacks
  fire, and for the first chunk before the run's opening callbacks.
- A callback that sets the stop, replaces the state, edits it in place,
  changes Δt or changes a schedule, at a chunk's end or at the opening,
  gives the in-order result; the queued chunk is counted as discarded.
- No chunk is queued past a chunk end where a ``TimeStepWizard`` is due;
  none under ``torch.inference_mode``.
- A decomposed run over gloo (``tests/torch_group_worker.py``) takes its
  chunks in order, none queued.
- On the card (``cuda``): a 128² run of 21 chunks on two streams, the
  caching allocator reusing blocks, gives the in-order loop's rows and
  per-chunk snapshots bit for bit.
"""

import pytest
import torch

import torch_group_worker as G
from port_cases import bench_model
from swmhd_tpu_torch import (Callback, IterationInterval, Simulation,
                             TimeInterval, TimeStepWizard, cli, scenarios)
from swmhd_tpu_torch.io import ScalarSeriesWriter
from swmhd_tpu_torch.ops import substage as K

torch.set_num_threads(1)

DT, STEPS = 1e-3, 20


def case():
    """``(model, state)``: the bench configuration (WENO, the jacobian
    Lorentz force) at 16², float64, which the kernel stepper takes too."""
    return bench_model(16, torch.float64, "cpu")


class InOrder:
    """``inner``'s chunks with the identity as ``tile_diagnostics``: a
    ``Simulation`` then launches each chunk after the previous one's
    callbacks, as a decomposed run does."""

    def __init__(self, inner):
        self.inner = inner

    def step_fn(self, dt, n_steps=1, diagnostics=None):
        return self.inner.step_fn(dt, n_steps, diagnostics=diagnostics)

    def tile_diagnostics(self, fn):
        return fn


class Logged:
    """``inner``'s chunks, logging each call as ``("step", iteration)``."""

    def __init__(self, inner, log):
        self.inner, self.log = inner, log

    def step_fn(self, dt, n_steps=1, diagnostics=None):
        fn = self.inner.step_fn(dt, n_steps, diagnostics=diagnostics)

        def logged(state):
            self.log.append(("step", state.clock.iteration))
            return fn(state)
        return logged


def simulate(stepper_of, path, edit=None, at=6):
    """A run of ``STEPS`` steps through ``stepper_of(model)`` with the
    CLI's energies every step, a report every 3 steps and a callback every
    0.005 time units (chunks of 3, 2 and 1 steps), recording at each
    report the clock and a copy of the state, and calling ``edit(sim)``
    at iteration ``at``: ``(final, seen, sim)``."""
    model, state = case()
    h0 = state.h.clone()
    sim = Simulation(model, dt=DT, stop_iteration=STEPS,
                     stepper=stepper_of(model))
    seen = []

    def record(s):
        seen.append((s.state.clock.iteration, s.state.clock.time,
                     torch.stack(s.state.fields()).clone()))
        if edit is not None and s.state.clock.iteration == at:
            edit(s)
    sim.callbacks["report"] = Callback(record, IterationInterval(3))
    sim.callbacks["timed"] = Callback(lambda s: None, TimeInterval(0.005))
    sim.output_writers["energies"] = ScalarSeriesWriter(
        lambda m, s: cli.energies(m, s, h0), IterationInterval(1),
        str(path))
    return sim.run(state), seen, sim


def assert_same(a, b, tmp_path):
    """Runs ``a`` and ``b`` of :func:`simulate` agree bit for bit, their
    CSVs (``ahead.csv``, ``order.csv``) byte for byte."""
    (final_a, seen_a, _), (final_b, seen_b, _) = a, b
    for x, y in zip(final_a.fields(), final_b.fields()):
        assert torch.equal(x, y)
    assert final_a.clock == final_b.clock
    assert [s[:2] for s in seen_a] == [s[:2] for s in seen_b]
    for (_, _, x), (_, _, y) in zip(seen_a, seen_b):
        assert torch.equal(x, y)
    assert ((tmp_path / "ahead.csv").read_bytes()
            == (tmp_path / "order.csv").read_bytes())


def plain(model):
    return model


@pytest.mark.parametrize("inner", [plain, K.KernelStepper],
                         ids=["plain", "kernel"])
def test_series_run_matches_the_loop_in_order(tmp_path, inner):
    log = []
    ahead = simulate(lambda m: Logged(inner(m), log), tmp_path / "ahead.csv")
    order = simulate(lambda m: InOrder(inner(m)), tmp_path / "order.csv")
    assert_same(ahead, order, tmp_path)
    # chunks of 3, 2, 1, 3, 1, 2, 3, 3, 2 steps, each queued ahead of the
    # callbacks before it and kept
    assert [it for _, it in log] == [0, 3, 5, 6, 9, 10, 12, 15, 18]
    assert (ahead[2].ahead_kept, ahead[2].ahead_discarded) == (9, 0)
    assert (order[2].ahead_kept, order[2].ahead_discarded) == (0, 0)


def test_next_chunk_is_called_before_the_callbacks():
    """The order of the stepper's calls and the reports: the first chunk's
    call before the opening report, the second's before the report at the
    first chunk's end, and so on; in order, each call after the report
    before it."""
    model, state = case()
    for stepper, want in ((Logged, [("step", 0), ("fire", 0), ("step", 3),
                                    ("fire", 3), ("step", 6),
                                    ("fire", 6), ("fire", 9)]),
                          (lambda m, log: InOrder(Logged(m, log)),
                           [("fire", 0), ("step", 0), ("fire", 3),
                            ("step", 3), ("fire", 6), ("step", 6),
                            ("fire", 9)])):
        log = []
        sim = Simulation(model, dt=DT, stop_iteration=9,
                         stepper=stepper(model, log))
        sim.callbacks["report"] = Callback(
            lambda s: log.append(("fire", s.state.clock.iteration)),
            IterationInterval(3))
        sim.run(state)
        assert log == want


def stop_here(sim):
    sim.stop_iteration = sim.state.clock.iteration


def replace_state(sim):
    sim.state = sim.state.replace(h=sim.state.h * 1.001)


def edit_in_place(sim):
    sim.state.A.mul_(1.001)


def halve_dt(sim):
    sim.dt *= 0.5


def halve_dt_as_the_wizard_does(sim):
    sim.dt *= 0.5
    sim._steppers.clear()


def reschedule(sim):
    sim.callbacks["timed"] = Callback(lambda s: None, IterationInterval(2))


@pytest.mark.parametrize("at", [0, 6])
@pytest.mark.parametrize("edit", [stop_here, replace_state, edit_in_place,
                                  halve_dt, halve_dt_as_the_wizard_does,
                                  reschedule])
def test_a_callback_that_changes_the_run_discards_the_queued_chunk(
        tmp_path, edit, at):
    """``edit`` at iteration 6, or at the opening."""
    ahead = simulate(plain, tmp_path / "ahead.csv", edit, at)
    order = simulate(InOrder, tmp_path / "order.csv", edit, at)
    assert_same(ahead, order, tmp_path)
    assert ahead[2].ahead_discarded == 1
    if edit is stop_here:
        assert ahead[0].clock.iteration == at
        assert torch.equal(torch.stack(ahead[0].fields()), ahead[1][-1][2])


@pytest.mark.parametrize("every", [3, 6])
def test_no_chunk_is_queued_past_a_due_wizard(every):
    """Δt 0.05 (CFL ≈0.24) and a wizard toward 0.1: due at every report,
    nothing is queued ahead; due at every other report, the chunks after
    the other three are queued and kept, and none ahead of the opening,
    where the wizard fires. Either way the in-order result."""
    model, state = case()
    runs = []
    for stepper in (model, InOrder(model)):
        sim = Simulation(model, dt=0.05, stop_iteration=18, stepper=stepper)
        sim.callbacks["report"] = Callback(lambda s: None,
                                           IterationInterval(3))
        sim.callbacks["wizard"] = Callback(
            TimeStepWizard(cfl=0.1, min_change=0.2),
            IterationInterval(every))
        runs.append((sim.run(state), sim))
    (ahead, sim), (order, _) = runs
    assert sim.dt < 0.05
    for x, y in zip(ahead.fields(), order.fields()):
        assert torch.equal(x, y)
    assert ahead.clock == order.clock
    assert (sim.ahead_kept, sim.ahead_discarded) == (
        (0, 0) if every == 3 else (3, 0))


def test_inference_mode_takes_chunks_in_order(tmp_path):
    with torch.inference_mode():
        ahead = simulate(plain, tmp_path / "ahead.csv")
    order = simulate(InOrder, tmp_path / "order.csv")
    assert_same(ahead, order, tmp_path)
    assert (ahead[2].ahead_kept, ahead[2].ahead_discarded) == (0, 0)


def test_decomposed_run_takes_chunks_in_order(tmp_path):
    """Two gloo ranks, a 2×1 mesh: on each rank every stepper call comes
    after the previous chunk's report, and nothing is queued."""
    for rep in G.run_group("order", 2, tmp_path):
        log = [tuple(e) for e in rep["log"]]
        want = [("fire", 0)]
        for it in range(0, G.ORDER_STEPS, G.ORDER_EVERY):
            want += [("step", it), ("fire", it + G.ORDER_EVERY)]
        assert log == want
        assert (rep["kept"], rep["discarded"]) == (0, 0)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the run-ahead's streams and the "
                    "kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["series", "plain", "stopped"])
def test_two_streams_match_the_loop_in_order(cuda, tmp_path, case):
    """128² high_B through the kernel stepper, 21 chunks of 100 steps
    (with the CLI's series every step as CUDA graphs, without it, or with
    it and the stop set by a callback at the 11th chunk's end). A
    callback on the current stream falls behind the chunks at every
    third chunk's end (``torch.cuda._sleep`` of about 6 ms, two to three
    chunks' work: without the series nothing waits for it), churns the
    caching allocator with state-sized blocks and takes a snapshot of the
    state, none of it waited for. The run-ahead gives the in-order loop's
    rows and snapshots bit for bit, keeps every chunk (but the one after
    the stop, discarded), and the allocator hands the state's blocks out
    again once the current stream has read them."""
    model, state, sc = scenarios.build("128x128_two_Gaussians_high_B",
                                       device=cuda)
    h0 = state.h.clone()
    stepper = K.KernelStepper(model)
    chunks, every = 21, 100
    stop = 11 if case == "stopped" else None

    def run(stp, path):
        sim = Simulation(model, dt=sc.dt, stop_iteration=chunks * every,
                         stepper=stp)
        snaps, where = [], []

        def snapshot(s):
            if len(snaps) % 3 == 0:
                torch.cuda._sleep(10_000_000)
            for _ in range(4):
                torch.empty_like(torch.stack(s.state.fields())).fill_(1.0)
            snaps.append(torch.stack(s.state.fields()).clone())
            where.append(s.state.h.data_ptr())
            if stop is not None and s.state.clock.iteration == stop * every:
                s.stop_iteration = stop * every
        sim.callbacks["snapshot"] = Callback(snapshot,
                                             IterationInterval(every))
        if case != "plain":
            sim.output_writers["energies"] = ScalarSeriesWriter(
                lambda m, s: cli.energies(m, s, h0), IterationInterval(1),
                str(path))
        sim.run(state)
        return sim, [x.cpu() for x in snaps], where

    sim, ahead, where = run(stepper, tmp_path / "ahead.csv")
    _, order, _ = run(InOrder(stepper), tmp_path / "order.csv")
    n = stop or chunks
    assert (sim.ahead_kept, sim.ahead_discarded) == (n, int(stop is not None))
    assert len(ahead) == len(order) == n + 1
    for k, (a, b) in enumerate(zip(ahead, order)):
        assert torch.equal(a, b), k
    assert len(set(where[1:])) < n
    if case != "plain":
        assert ((tmp_path / "ahead.csv").read_bytes()
                == (tmp_path / "order.csv").read_bytes())
