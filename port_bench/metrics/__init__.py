"""Per-layer metric readers, one module a metric, named as the metric.

``run.py`` loads ``metrics/<name>.py`` for each per-layer metric of a
cell and calls its ``read(ctx)`` after a traced run; ``ctx`` is a
``run.LayerContext`` (the device trace of the window, the cell's
configuration and traffic, and the window's steps, paths and host-clock
seconds).  A reader returns the metric's value, or None where the run
gives it nothing to read: the metric is then left out of the line.
"""
