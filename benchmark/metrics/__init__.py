"""One reader a metric, found by the metric's name: ``read(run)`` returns the
metric's value from what a run measured, or None where the run has nothing
to read (the harness then leaves the metric out of the result).

``run`` holds the configuration and traffic (``config``, ``traffic``), the
set-up seconds (``setup_s``), the window (``window``: ``window_s``,
``steps``, ``clips``, ``intervals_ms``, ``data_wait_s``, ``data_waits``)
and, in a traced run, the profiled stretch (``trace``: a
:class:`benchmark.trace.Trace`).
"""
