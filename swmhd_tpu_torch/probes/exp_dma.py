"""The window-load probe, counterpart of ``benchmarks/exp_dma.py``.

    python -m swmhd_tpu_torch.probes.exp_dma [--spec S] [--n N] [--device D]

For each spec ``TX,TY,HX,HY,LOAD`` (``;``-separated; ``--spec`` or
``SWMHD_DMA_PROBE``, else the JAX probe's six) it wrap-pads an N×N float32
ramp (N = 1024) by (HX, HY), runs :func:`~swmhd_tpu_torch.ops.tile.
window_probe` (LOAD 1: asynchronous copies, 0: through registers) and
prints ``OK`` with the first call's seconds and the error against the
ramp + 1, or ``FAILED: <why>``: a window over the card's shared memory per
block is refused. ``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..ops.tile import LOADS, window_probe, wrap_pad
from . import spec_list, sync

DEFAULT_SPECS = ("128,128,8,8,1;128,128,8,8,0;128,128,8,64,1;128,128,8,128,1;"
                 "128,1024,8,0,1;128,128,0,8,1")


def ramp(N, device):
    """The probes' input: 0, 1e-6, 2e-6, … over an N×N float32 array."""
    return torch.arange(N * N, dtype=torch.float32,
                        device=device).reshape(N, N) * 1e-6


def run(spec, N, device):
    """One spec; its line printed and a dict of what it found returned."""
    TX, TY, HX, HY, load = (int(v) for v in spec.split(","))
    tag = f"TX={TX} TY={TY} HX={HX} HY={HY} load={LOADS.get(load, load)}"
    x = ramp(N, device)
    try:
        t0 = time.perf_counter()
        out = window_probe(wrap_pad(x, HX, HY), TX, TY, HX, HY, load)
        sync(device)
        seconds = time.perf_counter() - t0
    except ValueError as e:
        print(f"[{tag}] FAILED: {type(e).__name__}: {e}", flush=True)
        return {"spec": spec, "ok": False, "error": type(e).__name__,
                "why": str(e)}
    want = x + 1.0
    err = float((out - want).abs().max())
    print(f"[{tag}] OK first call {seconds:.3f}s err {err:.1e}", flush=True)
    return {"spec": spec, "ok": True, "err": err,
            "bitwise": bool(torch.equal(out, want)), "seconds": seconds}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m swmhd_tpu_torch.probes."
                                "exp_dma", description=__doc__.split("\n")[0])
    p.add_argument("--spec", default=None,
                   help="TX,TY,HX,HY,LOAD;... (default $SWMHD_DMA_PROBE or "
                   "the JAX probe's specs)")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    specs = args.spec or os.environ.get("SWMHD_DMA_PROBE", DEFAULT_SPECS)
    return [run(s, args.n, args.device) for s in spec_list(specs)]


if __name__ == "__main__":
    main()
