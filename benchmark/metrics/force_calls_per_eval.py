"""Calls into the potential's force function (``energy_with_edges``, one
for all chains) per MC step of the traced sweeps: the FIRE loop's
iterations plus its first force call, until the slowest chain stops."""


def read(ctx):
    steps = ctx["trace"].steps
    return ctx["force_calls"] / steps if steps and ctx["force_calls"] else None
