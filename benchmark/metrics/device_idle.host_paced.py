"""Percent of the traced sweeps' wall time of a cell whose host paces
the step in which no device operation ran."""

from benchmark.work.readers import device_idle as read  # noqa: F401
