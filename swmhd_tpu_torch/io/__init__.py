"""Output writers and their readers."""

from .writers import FieldWriter, ScalarWriter, ScalarSeriesWriter
from .readers import FieldTimeSeries, ScalarTimeSeries

__all__ = ["FieldWriter", "ScalarWriter", "ScalarSeriesWriter",
           "FieldTimeSeries", "ScalarTimeSeries"]
