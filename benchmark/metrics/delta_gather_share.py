"""Percent of the traced sweeps' device time (every device operation,
copies included) inside the delta's ``delta.gather`` spans: the block
gathers of each layer's operands and the halo concatenations."""

from benchmark.work.spans import device_share


def read(ctx):
    return device_share(ctx, "delta.gather")
