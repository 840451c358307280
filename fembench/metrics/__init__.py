"""Metric readers, one file a quantity, found by the metric's name in
``BENCHMARK.json`` (``spec.module``).  Each has ``read(run)``
(``harness.Run``) and returns the metric, or None where the run has
nothing to read."""
