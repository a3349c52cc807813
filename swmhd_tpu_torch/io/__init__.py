"""Output writers."""

from .writers import FieldWriter, ScalarSeriesWriter

__all__ = ["FieldWriter", "ScalarSeriesWriter"]
