"""Percent of the host time of the MC steps (the ``mc.step`` spans) inside
the ``mc.energy`` spans (the trial's evaluation by the model) in the
traced sweeps of a cell whose host paces the step."""

from benchmark.work.spans import host_share


def read(ctx):
    return host_share(ctx, "mc.energy")
