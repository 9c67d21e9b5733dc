"""Operations of one evaluation of a CHGNet configuration, for ``mfu``."""

from benchmark.work.kernels import StateCounts, chgnet_eval_flops


def eval_flops(c: StateCounts, cfg: dict) -> float:
    return chgnet_eval_flops(c, cfg["atom_fea_dim"], cfg["n_conv"], cfg["mlp_hidden_dims"][0])
