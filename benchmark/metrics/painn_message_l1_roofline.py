"""Row 1 (``painn_message_l1``, csrc/painn_message_l1.cu): percent of its
least time over its device time in the traced sweeps."""

from benchmark.work.kernels import painn_l1_s
from benchmark.work.readers import roofline


def read(ctx):
    c = ctx["config"]
    return roofline(ctx, "painn_message_l1", r"\bbinned_kernel\b",
                    lambda s: painn_l1_s(s, c["n_members"], c["feat_dim"], c["n_rbf"], c["r_pad"],
                                         c["max_neighbors"], c["n_species"]))
