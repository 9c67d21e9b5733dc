"""Row 2 (``painn_message_fused``, csrc/painn_message_fused.cu): percent
of its least time over its device time in the traced sweeps."""

from benchmark.work.kernels import painn_msg_s
from benchmark.work.readers import roofline


def read(ctx):
    c = ctx["config"]
    return roofline(ctx, "painn_message_fused", r"\bmessage_kernel\b",
                    lambda s: painn_msg_s(s, c["n_members"], c["feat_dim"], c["n_rbf"],
                                          c["r_pad"], c["max_neighbors"]))
