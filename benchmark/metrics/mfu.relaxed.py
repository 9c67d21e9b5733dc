"""Percent of the H100's dense TF32 peak (495 TFLOP/s, 700 W) that a
relaxed step's model operations over the traced sweeps' wall time reach:
per force call the general trunk's forward (layer 1 through the general
message) and its backward, counted as twice the forward, and per step one
more forward for the fresh score. Work is counted at the trial's ideal
geometry."""

from benchmark.work.kernels import PEAK_TF32_FLOPS, painn_general_flops
from benchmark.work.readers import counts


def read(ctx):
    c, tr = ctx["config"], ctx["trace"]
    cs = counts(ctx)
    if not cs or not tr.kernels or tr.window_s <= 0 or not ctx["force_calls"]:
        return None
    per_step_calls = ctx["force_calls"] / len(cs)
    fwd = [painn_general_flops(s, c["n_members"], c["feat_dim"], c["n_rbf"], c["n_layers"],
                               c["readout_hidden"]) for s in cs]
    flops = sum(f * (3 * per_step_calls + 1) for f in fwd)
    return 100.0 * flops / (tr.window_s * PEAK_TF32_FLOPS)
