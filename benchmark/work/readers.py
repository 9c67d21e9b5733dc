"""Helpers the per-layer metric readers share: the device kernels of a
traced window by name, and the work counts of the states it evaluated
(computed once a run)."""

from __future__ import annotations

import re

from benchmark.reference.common import load_lattice
from benchmark.work.kernels import state_counts

NOT_KERNELS = ("Memcpy", "Memset")


def kernels(ctx) -> list:
    """(name, start us, duration us) of the device kernels (no copies)."""
    return [k for k in ctx["trace"].kernels if not k[0].startswith(NOT_KERNELS)]


def kernel_seconds(ctx, pattern: str) -> float:
    """Device seconds of the kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return 1e-6 * sum(d for name, _, d in kernels(ctx) if rx.search(name))


def counts(ctx, chunk: int = 16) -> list:
    """StateCounts of every evaluation in the traced window (one per MC
    step), from the occupancies the program was handed."""
    if "_counts" not in ctx:
        cfg = ctx["config"]
        cutoff = cfg.get("cutoff", cfg.get("atom_graph_cutoff"))
        lat = load_lattice(ctx["lattice"], ctx["device"])
        out = []
        for ss in ctx["trace"].states:
            parts = [state_counts(lat, ss[lo:lo + chunk], cutoff)
                     for lo in range(0, ss.shape[0], chunk)]
            out.append(type(parts[0])(*(sum(p[i] for p in parts) if i != 1 else parts[0][1]
                                        for i in range(len(parts[0])))))
        ctx["_counts"] = out
    return ctx["_counts"]


def roofline(ctx, wrapper: str, pattern: str, bound_s) -> float | None:
    """Percent of the least time over the device time of one kernel: the
    least seconds ``bound_s(counts)`` of each evaluation's launch, times
    the launches the program counted per evaluation, over the device
    seconds of the kernels matching ``pattern``. None where the window ran
    no such kernel or evaluated no state."""
    cs = counts(ctx)
    t = kernel_seconds(ctx, pattern)
    n = ctx["trace"].launches.get(wrapper, 0)
    if not cs or t <= 0 or n <= 0:
        return None
    return 100.0 * sum(bound_s(c) for c in cs) * (n / len(cs)) / t


def launches_per_step(ctx) -> float | None:
    """Device kernels (no copies) per MC step of the traced sweeps."""
    steps, ks = ctx["trace"].steps, kernels(ctx)
    return len(ks) / steps if steps and ks else None


def device_idle(ctx) -> float | None:
    """Percent of the traced sweeps' wall time with no device operation."""
    from benchmark.harness import busy_seconds

    tr = ctx["trace"]
    if not tr.kernels:
        return None
    return 100.0 * (1.0 - busy_seconds(tr.kernels) / tr.window_s)


def mfu(ctx) -> float | None:
    """Percent of the H100's dense TF32 peak (495 TFLOP/s at 700 W) that
    the model's operations over the traced sweeps' wall time reach: an
    evaluation's operations from ``eval_flops(counts, config)`` of
    ``work/<config["model"]>.py``. None for a family without that file."""
    from benchmark import family_module
    from benchmark.work.kernels import PEAK_TF32_FLOPS

    c, tr = ctx["config"], ctx["trace"]
    family = family_module("work", c["model"])
    cs = counts(ctx)
    if family is None or not cs or not tr.kernels or tr.window_s <= 0:
        return None
    flops = sum(family.eval_flops(s, c) for s in cs)
    return 100.0 * flops / (tr.window_s * PEAK_TF32_FLOPS)
