"""The one generator of the benchmark's traffic: what a traffic file's
parameters and ``--seed`` make.

A traffic file (``portbench/traffic/<name>.json``) names a scenario of
the program's registry (its initial fields and topology, which the
program builds), states the same initial fields for the reference
(``initial``), and sets the grid, the step, the stop time, the cadences
of the CLI's callbacks and the seeded perturbation. The seed changes
where the perturbation's bumps sit and their signs, never their number,
width or size range, so every seed gives the same work.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, salt: int = 0) -> np.random.Generator:
    """A generator of ``seed`` (any whole number, 64 bits kept)."""
    return np.random.default_rng([int(seed) % 2 ** 64, salt])


def perturbation(spec: dict, seed: int) -> dict:
    """``{"h": [(x0, y0, a, w)], "A": [...]}``: ``spec["bumps"]`` Gaussian
    bumps of width ``spec["width"]`` on each of h and A, centred inside
    ``[-extent, extent]²``, each of amplitude ``spec[field]`` times a
    random sign and a factor drawn from [0.5, 1]."""
    g = rng(seed, 1)
    out = {}
    for field in ("h", "A"):
        n = int(spec["bumps"])
        xy = g.uniform(-spec["extent"], spec["extent"], size=(n, 2))
        amp = (spec[field] * g.choice((-1.0, 1.0), size=n)
               * g.uniform(0.5, 1.0, size=n))
        out[field] = [(float(x), float(y), float(a), float(spec["width"]))
                      for (x, y), a in zip(xy, amp)]
    return out


def checked_chunks(check: dict, seed: int) -> list:
    """The window's chunks whose output is compared with the reference:
    chunk 0, which starts from the initial state, and ``chunks - 1`` more
    drawn from the seed among chunks 1 to ``within - 1``."""
    n = int(check["chunks"]) - 1
    drawn = rng(seed, 2).choice(np.arange(1, int(check["within"])), size=n,
                                replace=False) if n > 0 else []
    return sorted({0, *(int(k) for k in drawn)})
