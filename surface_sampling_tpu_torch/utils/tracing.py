"""Phase timing, and the spans and counters of the MC step.

* ``PhaseTimer``: named wall-clock phases with a one-line report (the run
  driver logs its first chunk against the later ones).
* ``span(name)``: a ``torch.profiler.record_function`` range while a
  ``torch.profiler`` runs, else one shared no-op context. Spans are on
  exactly while a profiler runs, so they appear in any trace an operator
  opens, on the profiler's clock (on the card, with their device mirror
  over the kernels launched inside them), and cost one check otherwise.
* ``count(name, value)``: while a profiler runs, keeps a reference to
  ``value`` (a tensor the step has already made, or an int) under
  ``name``; launches nothing. ``counters()`` returns what was kept and
  ``reset_counters()`` clears it; readers reduce the values after the
  traced window, so any synchronisation happens outside it. The values
  kept are those of the last profiled stretch of counted steps: the first
  count with the profiler on after one with it off drops the older ones.
  They hold their memory until then (the delta's counter: one (C, NB)
  int64 tensor a layer a step, about 190 KB a step at 128 chains on
  campaign A).

The port's spans: ``mc.step`` (``core/engine.run_sweeps``: one step's
draws and step function), ``mc.energy`` (every step builder: the trial's
evaluation), ``mc.filter`` (``core/events``: the distance filter),
``delta.gather`` and ``delta.cache_write`` (``core/incremental``: the
delta's block gathers and halo copies, its block writes into the caches
and the step's select of them), and ``chgnet.bases`` / ``.atom_conv`` /
``.readout`` (``models/chgnet.chgnet_apply``'s stages).
Its counter: ``delta.blocks``, the delta's (C, NB) block list of each
layer. The benchmark's per-layer metrics (``benchmark/metrics/``) read
them.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import torch

_OFF = contextlib.nullcontext()
_COUNTERS: dict[str, list] = {}
_stale = False           # a count ran with the profiler off since the last one kept


def span(name: str):
    """A profiler range named ``name`` while a ``torch.profiler`` runs,
    else one shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, value) -> None:
    """Keep ``value`` under ``name`` while a ``torch.profiler`` runs; the
    first value kept after a count with the profiler off drops every value
    kept before it."""
    global _stale
    if torch.autograd._profiler_enabled():
        if _stale:
            _COUNTERS.clear()
            _stale = False
        _COUNTERS.setdefault(name, []).append(value)
    else:
        _stale = True


def counters() -> dict[str, list]:
    """``{name: [values]}`` kept by :func:`count` in the last profiled
    stretch of counted steps (or since the last reset)."""
    return {k: list(v) for k, v in _COUNTERS.items()}


def reset_counters() -> None:
    _COUNTERS.clear()


class PhaseTimer:
    """Accumulates named phase durations; re-entered phases accumulate."""

    def __init__(self):
        self.phases: "OrderedDict[str, float]" = OrderedDict()
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"total {total:.3f}s"]
        for name, dt in self.phases.items():
            lines.append(
                f"  {name}: {dt:.3f}s ({100 * dt / max(total, 1e-12):.1f}%, "
                f"n={self.counts[name]})"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return dict(self.phases)
