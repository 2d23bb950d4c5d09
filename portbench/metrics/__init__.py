"""One reader a metric: ``read(run)`` gives the metric's value from the
run's requests, the program's phase clock or the device trace, or ``None``
when there is nothing to read. ``UNIT`` and ``SOURCE`` (and ``LAYER`` for a
per-layer metric) declare it as ``BENCHMARK.json`` lists it; the end-to-end
metric it moves is ``BENCHMARK.json``'s alone. A reader of a name with a
dot (``device_idle.refit``) serves every metric of that quantity that has
no file of its own."""
