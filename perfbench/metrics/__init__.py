"""Metric readers, one file each, found by the metric's name.

Each module gives ``LAYER`` (the layer as PERF.md names it), ``MOVES``
(the end-to-end metric it should move) and ``read(ctx)``
(session.Context), which returns a number, or None where it finds nothing
to read; a run in which a metric of its cell reads nothing fails with no
result (session.NothingToRead), so a device-trace metric is read in the
traced run alone and listed under ``workloads`` where it reads in some
cells only.
"""
