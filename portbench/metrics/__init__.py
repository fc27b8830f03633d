"""Metric readers: ``<name>.py`` for the metric of that name in
``BENCHMARK.json``.  Each has ``read(run) -> float | None`` (None: the
run has nothing to read, and the metric is left out of the line) and
may have ``prepare(run)``, which the traced run calls before its
window."""
