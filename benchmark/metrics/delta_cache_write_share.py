"""Percent of the traced sweeps' device time (every device operation,
copies included) inside the ``delta.cache_write`` spans: the delta's block
writes into the caches (a copy of each table and its scatter) and the
step's select of the accepted chains' caches."""

from benchmark.work.spans import device_share


def read(ctx):
    return device_share(ctx, "delta.cache_write")
