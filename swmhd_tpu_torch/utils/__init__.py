from .prettytime import prettytime

__all__ = ["prettytime"]
