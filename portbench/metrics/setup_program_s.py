"""The program's own set-up, s: the seconds of its set-up spans
(``swmhd_tpu_torch.tracing.setup_totals``: the kernel library's load,
the readying of kernels, stepper builds, graph warm-ups and captures,
each second counted once), read from the program after the run; a graph
captured again in the window raises it. None where the program has no
such totals."""

from __future__ import annotations


def read(ctx):
    try:
        from swmhd_tpu_torch.tracing import setup_totals
    except ImportError:
        return None
    totals = setup_totals()
    return sum(s for _, s in totals.values()) if totals else None
