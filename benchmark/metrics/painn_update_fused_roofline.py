"""Row 3 (``painn_update_fused``, csrc/painn_update_fused.cu, its alive-row
list and update kernels): percent of its least time over its device time
in the traced sweeps."""

from benchmark.work.kernels import painn_update_s
from benchmark.work.readers import roofline


def read(ctx):
    c = ctx["config"]
    return roofline(ctx, "painn_update_fused", r"\b(alive_list_kernel|update_kernel)\b",
                    lambda s: painn_update_s(s, c["n_members"], c["feat_dim"]))
