"""Host milliseconds per MC step inside the ``mc.filter`` spans (the
distance filter's call) in the traced sweeps of a cell whose host paces
the step."""

from benchmark.work.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "mc.filter")
