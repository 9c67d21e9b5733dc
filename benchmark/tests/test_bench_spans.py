"""The readers of the program's spans and counter (``metrics/delta_*``,
``metrics/*_host_ms.host_paced``, ``metrics/*_host_share.host_paced``) on a synthetic traced window, and None
where the window holds no such span or counter."""

import pytest
import torch

from benchmark.harness import TraceSummary, metric_reader
from surface_sampling_tpu_torch.utils import tracing

# device operations (name, start us, duration us): 10 s in all, 2 s of them
# inside delta.gather, 1.5 s inside delta.cache_write
KERNELS = [("gather_kernel", 0.0, 1.5e6), ("Memcpy DtoD", 1.5e6, 0.5e6),
           ("message_kernel", 2.0e6, 6.0e6), ("scatter_kernel", 8.0e6, 1.5e6),
           ("update_kernel", 9.5e6, 0.5e6)]
RANGES = {"delta.gather": 2.0, "delta.cache_write": 1.5, "mc.step": 10.0}
# host spans (name, start us, end us) of 2 steps
HOST = [("mc.step", 0.0, 4000.0), ("mc.energy", 100.0, 3100.0), ("mc.filter", 3200.0, 3600.0),
        ("aten::add", 3700.0, 3710.0),
        ("mc.step", 5000.0, 10000.0), ("mc.energy", 5100.0, 8100.0),
        ("mc.filter", 8200.0, 9000.0)]


def _ctx(ranges=RANGES, host=HOST, steps=2, evals=6):
    return {"trace": TraceSummary(KERNELS, 0.02, steps, evals, dict(ranges), [], {}, list(host))}


@pytest.fixture
def blocks():
    """Two steps of a two-layer delta over 3 chains: layer lists padded
    by repeating their first block; the second step an exchange's two
    tables side by side."""
    lists = [torch.tensor([[4, 5, 4], [0, 1, 2], [7, 7, 7]]),
             torch.tensor([[3, 4, 5, 6], [0, 1, 2, 3], [6, 7, 8, 6]]),
             torch.tensor([[4, 5, 4, 5, 6, 5], [0, 1, 2, 1, 2, 3], [7, 7, 7, 8, 8, 8]]),
             torch.tensor([[3, 4, 5, 6], [0, 1, 2, 3], [6, 7, 8, 6]])]
    tracing.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for b in lists:
            tracing.count("delta.blocks", b)
    yield lists
    tracing.reset_counters()


@pytest.mark.parametrize("name,want", [("delta_gather_share", 20.0),
                                       ("delta_cache_write_share", 15.0),
                                       ("step_host_ms.host_paced", 4.5),
                                       ("energy_host_ms.host_paced", 3.0),
                                       ("filter_host_ms.host_paced", 0.6),
                                       ("energy_host_share.host_paced", 6000 / 90),
                                       ("filter_host_share.host_paced", 1200 / 90)])
def test_span_readers(name, want):
    assert metric_reader(name)(_ctx()) == pytest.approx(want, rel=1e-12)
    # a program without the spans
    assert metric_reader(name)(_ctx(ranges={}, host=[("aten::add", 0.0, 5.0)])) is None


def test_the_host_spans_nest_inside_the_step():
    ctx = _ctx()
    step, energy, filt = (metric_reader(f"{n}_host_ms.host_paced")(ctx)
                          for n in ("step", "energy", "filter"))
    assert energy + filt <= step
    shares = [metric_reader(f"{n}_host_share.host_paced")(ctx) for n in ("energy", "filter")]
    assert sum(shares) <= 100.0


def test_delta_blocks_per_eval(blocks):
    # distinct ids a chain row: layer 1 2 / 3 / 1, layer 2 4 / 4 / 3, then
    # layer 1 3 / 4 / 2, layer 2 4 / 4 / 3: 37 over 2 steps x 3 chains
    assert metric_reader("delta_blocks_per_eval")(_ctx()) == pytest.approx(37 / 6, rel=1e-12)
    tracing.reset_counters()
    assert metric_reader("delta_blocks_per_eval")(_ctx()) is None


def test_delta_blocks_per_eval_without_the_counter(monkeypatch):
    tracing.reset_counters()
    assert metric_reader("delta_blocks_per_eval")(_ctx()) is None
    # a program whose tracing module has no counters at all
    monkeypatch.delattr(tracing, "counters")
    assert metric_reader("delta_blocks_per_eval")(_ctx()) is None
