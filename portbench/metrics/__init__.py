"""Per-layer metric readers, one module a metric, each with ``read(ctx)``
(``ctx`` a :class:`portbench.harness.Context`) returning the metric's
value, or None where its run gives it nothing to read."""
