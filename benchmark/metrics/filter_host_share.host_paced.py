"""Percent of the host time of the MC steps (the ``mc.step`` spans) inside
the ``mc.filter`` spans (the distance filter's call) in the traced sweeps
of a cell whose host paces the step."""

from benchmark.work.spans import host_share


def read(ctx):
    return host_share(ctx, "mc.filter")
