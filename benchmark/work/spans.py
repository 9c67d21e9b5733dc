"""Helpers of the per-layer metrics that read the program's spans and
counters (``surface_sampling_tpu_torch.utils.tracing``): each returns None
where the traced window holds no such span or counter, as a program
without them leaves it."""

from __future__ import annotations


def device_share(ctx, name: str) -> float | None:
    """Percent of the device seconds of every device operation of the
    traced sweeps (copies included) that ran inside the spans ``name``."""
    tr = ctx["trace"]
    total = 1e-6 * sum(d for _, _, d in tr.kernels)
    if name not in tr.ranges or total <= 0:
        return None
    return 100.0 * tr.ranges[name] / total


def _host_us(trace, name: str) -> list:
    return [end - start for n, start, end in trace.host_ops if n == name]


def host_ms_per_step(ctx, name: str) -> float | None:
    """Host milliseconds inside the spans ``name`` per MC step of the
    traced sweeps."""
    tr = ctx["trace"]
    spans = _host_us(tr, name)
    if not spans or not tr.steps:
        return None
    return 1e-3 * sum(spans) / tr.steps


def host_share(ctx, name: str) -> float | None:
    """Percent of the host time of the traced sweeps' ``mc.step`` spans
    spent inside the spans ``name``: unlike the milliseconds, it does not
    move with the speed of the shared host."""
    tr = ctx["trace"]
    inside, steps = _host_us(tr, name), _host_us(tr, "mc.step")
    if not inside or not steps:
        return None
    return 100.0 * sum(inside) / sum(steps)


def counted(name: str) -> list:
    """The values the program counted under ``name`` in the traced sweeps
    (the process traces one window); [] where it counts none."""
    from surface_sampling_tpu_torch.utils import tracing

    read = getattr(tracing, "counters", None)
    return list(read().get(name, [])) if read is not None else []
