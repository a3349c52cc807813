"""Output writers and their readers."""

from .writers import FieldWriter, ScalarSeriesWriter
from .readers import FieldTimeSeries, ScalarTimeSeries

__all__ = ["FieldWriter", "ScalarSeriesWriter", "FieldTimeSeries",
           "ScalarTimeSeries"]
