"""Host milliseconds of one MC step (the ``mc.step`` span: the step's
draws and its step function) in the traced sweeps of a cell whose host
paces the step."""

from benchmark.work.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "mc.step")
