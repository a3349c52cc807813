"""The 2-D tile probes, counterparts of ``benchmarks/exp_dma.py``,
``exp_dma2.py`` and ``exp_fused2d.py``: each module runs its kernel of
:mod:`swmhd_tpu_torch.ops.tile` over a list of specs and prints one line
per spec (``python -m swmhd_tpu_torch.probes.exp_fused2d``; ``--device
cpu`` runs the plain versions). ``build`` is
:func:`swmhd_tpu_torch.bench.build`, the model and state the tendency
probe runs on.
"""

from __future__ import annotations

import time

import torch

from ..bench import build  # noqa: F401  (the probes' model)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, reps, device):
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def spec_list(text):
    """``"a;b;c"`` -> ``["a", "b", "c"]``, empty entries dropped."""
    return [s for s in text.split(";") if s.strip()]
