"""Metric readers, one module a metric, found by the part of the metric's
name before the first dot; the part after it names the end-to-end metric
it moves. Each defines ``read(run, scope)``, which returns a number or
None when the run holds nothing to read. Modules whose name starts with
an underscore are helpers, not metrics."""
