"""Row 10 (``chgnet_conv``, csrc/chgnet_conv.cu): percent of its least
time over its device time in the traced sweeps."""

from benchmark.work.kernels import chgnet_conv_s
from benchmark.work.readers import roofline


def read(ctx):
    cfg = ctx["config"]
    return roofline(ctx, "chgnet_conv", r"\bconv_kernel\b",
                    lambda c: chgnet_conv_s(c, cfg["atom_fea_dim"], cfg["max_neighbors"]))
