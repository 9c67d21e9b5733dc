"""Blocks of sorted rows the delta recomputes per evaluation (one chain's
MC step): the distinct block ids of each chain's row of every
``delta.blocks`` list the traced sweeps counted (one a layer a step),
summed over layers. A block list pads by repeating its first block, so the
padding adds no id."""

from benchmark.work.spans import counted


def read(ctx):
    lists, evals = counted("delta.blocks"), ctx["trace"].evals
    if not lists or not evals:
        return None
    distinct = 0
    for blocks in lists:
        ids = blocks.sort(dim=1).values
        distinct += int(ids.shape[0] + (ids[:, 1:] != ids[:, :-1]).sum())
    return distinct / evals
