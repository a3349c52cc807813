"""The 2-D tile tendency probe, counterpart of
``benchmarks/exp_fused2d.py``.

    python -m swmhd_tpu_torch.probes.exp_fused2d [--spec S] [--n N]
        [--reps R] [--device D]

Builds the ``bench.py`` model at N² float32 (``--n`` or
``SWMHD_BENCH_N``, else 2048) and, for each spec ``TX,TY,HALO,SPLIT``
(``;``-separated; ``--spec`` or ``SWMHD_PROBE``, else DEFAULT_SPECS),
evaluates G of the split (``full``: h, u, v, A; ``mom``: u, v; ``mt``: h,
A) with :func:`~swmhd_tpu_torch.ops.tile.tendency_tiles`, one block per
(TX, TY) tile reading a window HALO points wide. It prints one line per
spec: ``OK`` with the kernel library's build seconds (where the JAX probe
printed Mosaic's compile seconds), ms per evaluation over R calls (CUDA
events) and points/s, and each field's error relative to its scale
against ``model.tendencies`` of the whole grid; or ``FAILED: <why>``.
``--device cpu`` runs the plain version.

The default specs are tile shapes for Hopper (the JAX probe's were
128-lane TPU shapes): 32×32, 16×64 and 64×16 tiles at the least halo (3)
in the full split, 32×32 in the two others, and 32×32 with the TPU
probe's 8-row halo.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..ops.tile import SPLIT_FIELDS, tendency_tiles
from . import build, spec_list, sync, timed_ms

DEFAULT_SPECS = ("32,32,3,full;16,64,3,full;64,16,3,full;32,32,3,mom;"
                 "32,32,3,mt;32,32,8,full")
FIELDS = ("h", "u", "v", "A")


def library_build_seconds(device):
    """Seconds the kernel library's build took in this process (0 when it
    was already built); None on the CPU, where nothing is built."""
    if torch.device(device).type != "cuda":
        return None
    from ..ops import _build
    return _build.load().build_seconds


def run(spec, model, s, G, reps, device):
    """One spec against the whole-grid tendencies ``G`` (stacked); its
    line printed and a dict of what it found returned."""
    TX, TY, halo, split = spec.split(",")
    tile, halo = (int(TX), int(TY)), int(halo)
    tag = f"TX={TX} TY={TY} H={halo} {split}"
    fn = lambda: tendency_tiles(model, s, tile, halo, split)  # noqa: E731
    try:
        out = fn()
        sync(device)
        build_s = library_build_seconds(device)
        ms = timed_ms(fn, reps, device)
    except ValueError as e:
        print(f"[{tag}] FAILED: {type(e).__name__}: {e}", flush=True)
        return {"spec": spec, "ok": False, "error": type(e).__name__,
                "why": str(e)}
    errs = {}
    for n, k in enumerate(SPLIT_FIELDS[split]):
        ref = G[k].double()
        errs[FIELDS[k]] = float((out[n].double() - ref).abs().max()
                                / max(float(ref.abs().max()), 1e-300))
    N = s.shape[1] * s.shape[2]
    built = ("no build (plain version)" if build_s is None
             else f"build {build_s:.1f}s")
    print(f"[{tag}] OK {built}, {ms:.4f} ms/eval ({N / (ms * 1e-3):.3e} "
          f"pts/s), G rel err "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()), flush=True)
    return {"spec": spec, "ok": True, "ms": ms, "points_per_s":
            N / (ms * 1e-3), "rel_err": errs, "build_s": build_s}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m swmhd_tpu_torch.probes."
                                "exp_fused2d",
                                description=__doc__.split("\n")[0])
    p.add_argument("--spec", default=None,
                   help="TX,TY,HALO,SPLIT;... (default $SWMHD_PROBE or "
                   "DEFAULT_SPECS)")
    p.add_argument("--n", type=int, default=None,
                   help="grid size (default $SWMHD_BENCH_N or 2048)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    N = args.n or int(os.environ.get("SWMHD_BENCH_N", "2048"))
    specs = args.spec or os.environ.get("SWMHD_PROBE", DEFAULT_SPECS)
    model, state = build(N, device=args.device)
    s = torch.stack(state.fields())
    G = torch.stack(model.tendencies(state).fields())
    return [run(spec, model, s, G, args.reps, args.device)
            for spec in spec_list(specs)]


if __name__ == "__main__":
    main()
