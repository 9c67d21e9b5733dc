"""Host milliseconds per MC step inside the ``mc.energy`` spans (the
trial's evaluation by the model) in the traced sweeps of a cell whose host
paces the step."""

from benchmark.work.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "mc.energy")
