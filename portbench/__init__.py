"""The benchmark of the PyTorch and CUDA port ``swmhd_tpu_torch``:
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see :mod:`portbench.run`)."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "swmhd_tpu")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that must not load: JAX, its
    companions and the JAX package (compared whole: the port's name
    begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
