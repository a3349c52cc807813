"""The wrap-load probe, counterpart of ``benchmarks/exp_dma2.py``.

    python -m swmhd_tpu_torch.probes.exp_dma2 [--spec C] [--n N] [--device D]

For each case of ``window,dst3d,src8,when`` (``,``-separated; ``--spec``
or ``SWMHD_DMA2``) it pads an N×N float32 ramp (N = 1024) by 8 rows at
each end with wrap, runs :func:`~swmhd_tpu_torch.ops.tile.wrap_probe` (row
tiles of 32 from 48-row windows of whole rows) and prints ``OK`` with the
first call's seconds and the error against the ramp + 1, or ``FAILED:
<why>``. ``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..ops.tile import WRAP_CASES, WRAP_H, wrap_pad, wrap_probe
from . import sync
from .exp_dma import ramp


def run(case, N, device):
    """One case; its line printed and a dict of what it found returned."""
    x = ramp(N, device)
    try:
        t0 = time.perf_counter()
        out = wrap_probe(wrap_pad(x, WRAP_H, 0), case)
        sync(device)
        seconds = time.perf_counter() - t0
    except ValueError as e:
        print(f"[{case}] FAILED: {type(e).__name__}: {e}", flush=True)
        return {"spec": case, "ok": False, "error": type(e).__name__,
                "why": str(e)}
    want = x + 1.0
    err = float((out - want).abs().max())
    print(f"[{case}] OK first call {seconds:.3f}s err {err:.1e}", flush=True)
    return {"spec": case, "ok": True, "err": err,
            "bitwise": bool(torch.equal(out, want)), "seconds": seconds}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m swmhd_tpu_torch.probes."
                                "exp_dma2", description=__doc__.split("\n")[0])
    p.add_argument("--spec", default=None,
                   help="case,case,... (default $SWMHD_DMA2 or all four)")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cases = args.spec or os.environ.get("SWMHD_DMA2", ",".join(WRAP_CASES))
    return [run(c, args.n, args.device) for c in cases.split(",") if c]


if __name__ == "__main__":
    main()
