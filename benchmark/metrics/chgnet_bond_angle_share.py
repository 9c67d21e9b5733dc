"""Percent of the traced sweeps' kernel time spent inside the model's
``chgnet.bond_angle`` ranges (the plain bond conv and angle update)."""

from benchmark.work.readers import kernels


def read(ctx):
    inside = ctx["trace"].ranges.get("chgnet.bond_angle")
    total = 1e-6 * sum(d for _, _, d in kernels(ctx))
    if not inside or total <= 0:
        return None
    return 100.0 * inside / total
