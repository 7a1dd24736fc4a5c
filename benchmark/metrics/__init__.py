"""One reader a metric, in a file named after the metric: ``read(run)`` returns the
metric's value from a :class:`benchmark.run.Run`, or None where the run holds nothing
to read. The harness loads a reader by its metric's name in ``BENCHMARK.json``."""
