from .coriolis import FPlane
from .diffusion import LaplacianDiffusion, BiharmonicDiffusion
from .lorentz import (magnetic_field_cc, magnetic_field_faces,
                      lorentz_force_jacobian, lorentz_force_divergence)

__all__ = ["FPlane", "LaplacianDiffusion", "BiharmonicDiffusion",
           "magnetic_field_cc", "magnetic_field_faces",
           "lorentz_force_jacobian", "lorentz_force_divergence"]
