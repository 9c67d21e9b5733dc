"""Operations of one evaluation of a PaiNN ensemble configuration, for
``mfu``."""

from benchmark.work.kernels import StateCounts, painn_eval_flops


def eval_flops(c: StateCounts, cfg: dict) -> float:
    return painn_eval_flops(c, cfg["n_members"], cfg["feat_dim"], cfg["n_rbf"], cfg["n_layers"],
                            cfg["readout_hidden"])
