"""Phase timing and device tracing (the counterpart of
``surface_sampling_tpu/utils/tracing.py``).

* ``PhaseTimer``: named wall-clock phases with a one-line report (the run
  driver logs its first chunk against the later ones).
* ``device_trace``: ``torch.profiler`` around a block, a Chrome trace of
  the host and, on the card, of the kernels, written to a folder.
* ``block_and_time``: time a call whose outputs live on the card (ends in
  ``torch.cuda.synchronize()`` there).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from pathlib import Path

import torch


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


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA when a card is present) and write ``trace.json`` (Chrome trace
    format) into ``log_dir``. Yields the profiler, whose
    ``key_averages()`` gives the per-kernel table."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _on_card(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_card(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_on_card(v) for v in tree)
    return False


def block_and_time(fn, *args, **kwargs):
    """Run ``fn`` and wait for its outputs; returns (outputs, seconds). The
    wait is ``torch.cuda.synchronize()`` when an output lies on the card
    (kernels run asynchronously there); CPU tensors are ready on return."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if _on_card(out):
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
