"""swmhd_tpu_torch — the shallow-water MHD framework on PyTorch and CUDA.

A port of :mod:`swmhd_tpu` (which stays the reference) with the same
module and function names: the C-grid operators, WENO5-Z advection, the
vector-invariant model with jacobian-form Lorentz forcing and the
conservative model with divergence-form Lorentz forcing, Le–Moin RK3,
the simulation driver with its adaptive time step, writers, checkpoints,
scenarios, CLI, profiling and plots. The RK3 substage runs through a
CUDA C++ kernel written for Hopper (:mod:`swmhd_tpu_torch.ops.substage`).
This package never imports JAX.
"""

from .grid import Grid, PERIODIC, BOUNDED
from .models import (State, Clock, ShallowWaterModel, VECTOR_INVARIANT,
                     CONSERVATIVE)
from .advection import Centered2, UpwindBiased3, WENO5, get_scheme
from .physics import (FPlane, LaplacianDiffusion, BiharmonicDiffusion,
                      magnetic_field_cc, magnetic_field_faces,
                      lorentz_force_jacobian, lorentz_force_divergence)
from .forcing import jacobian_lorentz_forcing, divergence_lorentz_forcing
from .simulation import (Simulation, IterationInterval, TimeInterval,
                         Callback, TimeStepWizard)
from . import diagnostics
from . import profiling

__version__ = "0.1.0"

__all__ = [
    "Grid", "PERIODIC", "BOUNDED",
    "State", "Clock", "ShallowWaterModel", "VECTOR_INVARIANT", "CONSERVATIVE",
    "Centered2", "UpwindBiased3", "WENO5", "get_scheme",
    "FPlane", "LaplacianDiffusion", "BiharmonicDiffusion",
    "magnetic_field_cc", "magnetic_field_faces",
    "lorentz_force_jacobian", "lorentz_force_divergence",
    "jacobian_lorentz_forcing", "divergence_lorentz_forcing",
    "Simulation", "IterationInterval", "TimeInterval", "Callback",
    "TimeStepWizard", "diagnostics", "profiling",
]
