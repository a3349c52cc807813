from .coriolis import FPlane
from .lorentz import magnetic_field_cc, lorentz_force_jacobian

__all__ = ["FPlane", "magnetic_field_cc", "lorentz_force_jacobian"]
