"""The yardstick of the kernel and step metrics: the card's peaks, the
bytes and the frozen operations of one RK3 step a grid point.

The peak and the bytes follow the configuration's dtype (float32 or
float64: :func:`yardstick`). The operations are float32 elementwise
operations of one step of the plain reference
(:mod:`portbench.reference.swmhd`), counted by :func:`count_ops` at 32²
and frozen here, per formulation, y topology and whether A has a
background gradient. They count the scheme, not its precision, so they
stay the same whatever implements the step and in whichever dtype: a
share of the peak reads the same work.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# NVIDIA's H100 data sheet: device memory GB/s and float32 GFLOP/s outside
# the tensor cores, keyed by torch.cuda.get_device_name() lower-cased
# without spaces; the longest key found in the name wins.
HBM_PEAK_GBPS = {"h10080gbhbm3": 3350.0, "h100sxm": 3350.0,
                 "h100pcie": 2000.0, "h100nvl": 3900.0}
FP32_PEAK_GFLOPS = {"h10080gbhbm3": 67000.0, "h100sxm": 67000.0,
                    "h100pcie": 51000.0, "h100nvl": 60000.0}
# and float64 GFLOP/s outside the tensor cores
FP64_PEAK_GFLOPS = {"h10080gbhbm3": 34000.0, "h100sxm": 34000.0,
                    "h100pcie": 26000.0, "h100nvl": 30000.0}

# a configuration's dtype -> (its peak table, the bytes of a value)
DTYPES = {"float32": (FP32_PEAK_GFLOPS, 4), "float64": (FP64_PEAK_GFLOPS, 8)}

# operations a point of one float32 step of the reference, by
# "<formulation>/<y topology>/<'bg' if A has a background gradient else
# 'nobg'>": count_ops at 32² over 32² (portbench/tests/
# test_portbench_roofline.py recounts them). A walled axis adds index
# arithmetic of 32 elements a call, a few hundredths of an operation a
# point at 32² and less on larger grids.
OPS_PER_POINT_STEP = {
    "vector_invariant/periodic/nobg": 3336.0,
    "vector_invariant/periodic/bg": 3351.0,
    "vector_invariant/bounded/nobg": 3417.1875,
    "vector_invariant/bounded/bg": 3432.375,
    "conservative/periodic/nobg": 3306.0,
    "conservative/periodic/bg": 3321.0,
    "conservative/bounded/nobg": 3422.25,
    "conservative/bounded/bg": 3437.4375,
}

# elementwise arithmetic counted (shifts, selects and copies count none)
ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "pow",
             "clamp", "bitwise_and", "maximum", "minimum"}


def ops_key(formulation: str, topology_y: str, gamma: float) -> str:
    return f"{formulation}/{topology_y}/{'bg' if gamma else 'nobg'}"


def peak(table: dict, kind: str) -> Optional[float]:
    """``table``'s value for the card named ``kind``, or None."""
    k = kind.lower().replace(" ", "")
    for key in sorted(table, key=len, reverse=True):
        if key in k:
            return table[key]
    return None


def yardstick(cell, kind: str) -> tuple:
    """``(peak GFLOP/s, bytes a point-step)`` of ``cell``'s configuration's
    dtype on the card named ``kind`` (the peak None for a card not in the
    tables). The bytes are the least device-memory traffic of one step a
    point: 3 substages × (read the 4 fields + write them) × the bytes of a
    value, 96 for float32 and 192 for float64."""
    table, size = DTYPES[cell.config["dtype"]]
    return peak(table, kind), 3.0 * 8 * size


def count_ops(fn: Callable) -> int:
    """Elementwise arithmetic operations that ``fn()`` runs through
    PyTorch: one per output element of each operation in
    :data:`ARITH_OPS` (its in-place form too), counted by a dispatch
    mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket.__name__.rstrip("_") in ARITH_OPS
                    and isinstance(out, torch.Tensor)):
                Count.n += out.numel()
            return out

    with Count():
        fn()
    return Count.n


def ops_per_point_step(cell) -> float:
    """The frozen operations a point-step of ``cell``'s configuration and
    traffic."""
    ini = cell.traffic["initial"]
    return OPS_PER_POINT_STEP[ops_key(cell.config["formulation"],
                                      ini["topology_y"],
                                      float(ini["A_bg_grad_y"]))]
