from .state import State, Clock
from .shallow_water import ShallowWaterModel, VECTOR_INVARIANT, CONSERVATIVE

__all__ = ["State", "Clock", "ShallowWaterModel", "VECTOR_INVARIANT",
           "CONSERVATIVE"]
