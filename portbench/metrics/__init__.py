"""One reader a metric, named as the metric: ``read(ctx)`` takes a
``bench.Context`` and returns the number, or None where the run holds
nothing to read it from (the metric is then left out of the line)."""
