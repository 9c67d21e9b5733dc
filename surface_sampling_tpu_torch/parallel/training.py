"""Sharded fine-tuning: data-parallel and ensemble-parallel train steps.

The counterpart of ``surface_sampling_tpu/parallel/training.py`` over a
rank mesh (``parallel/mesh.py``), for every model family (``apply_fn``, as
in ``models.train.make_loss_fn``):

* **data parallelism** shards the structure axis of a batch over a mesh
  axis. Each rank differentiates its block, and one all-reduce averages
  the losses and gradients before the clip and Adam, the order of the JAX
  package's ``pmean`` then ``opt.update``. Parameters and optimizer state
  are replicated, so every rank applies the same update.
* **ensemble parallelism** shards the member axis of a stacked ensemble.
  Members are independent: the step has no collective, only a gather of
  the member losses at the end.

Both run the optimizer of ``models.train.Trainer``, whose gradient and
update are separate calls so that the all-reduce sits between them.
"""

from __future__ import annotations

from typing import Callable

import torch

from surface_sampling_tpu_torch.models.painn import tree_leaves, tree_map
from surface_sampling_tpu_torch.models.train import (
    PaddedBatch,
    TrainConfig,
    Trainer,
    batch_to_device,
    check_family,
)
from surface_sampling_tpu_torch.parallel.chains import gather_chain_states, shard_chain_states
from surface_sampling_tpu_torch.parallel.mesh import RankMesh, all_gather_blocks, all_reduce_mean

def make_sharded_train_step(trainer: Trainer, mesh: RankMesh, axis: str = "chains"):
    """Data-parallel train step: ``step(batch) -> (K,) losses``.

    ``batch`` is the whole device batch (the same on every rank); each rank
    takes its block of structures (:func:`shard_chain_states`; the
    structure count must split evenly over the axis), differentiates it
    (``trainer.gradients``), averages the losses and gradients over the axis
    in one all-reduce, and applies the clipped Adam update
    (``trainer.apply``), the same on every rank. The losses returned are
    the averaged ones: the full batch's when the blocks are equal."""

    def step(batch: PaddedBatch) -> torch.Tensor:
        losses, grads = trainer.gradients(shard_chain_states(batch, mesh, axis))
        flat = all_reduce_mean(torch.cat([losses] + [g.reshape(-1) for g in grads]), mesh, axis)
        parts = flat.split([losses.numel()] + [g.numel() for g in grads])
        trainer.apply([p.view_as(g) for p, g in zip(parts[1:], grads)])
        return parts[0]

    return step


def make_ensemble_sharded_train_step(trainer: Trainer, mesh: RankMesh, axis: str = "chains"):
    """Ensemble-parallel train step: ``step(batch) -> (K,) member losses``.

    ``trainer`` holds this rank's block of the members (a ``Trainer`` with
    ``ensemble=True`` over ``shard_chain_states(stacked_params, mesh,
    axis)``); every member sees the whole batch and trains on its own. The
    step has no collective but the gather of the member losses, in member
    order, on every rank."""

    def step(batch: PaddedBatch) -> torch.Tensor:
        losses, grads = trainer.gradients(batch)
        trainer.apply(grads)
        return all_gather_blocks(losses, mesh, axis)

    return step


def train_sharded(params: dict, cfg, batches, tcfg: TrainConfig, mesh: RankMesh,
                  axis: str = "chains", ensemble: bool = False,
                  apply_fn: Callable | None = None):
    """The mesh-parallel ``models.train.train_painn``: the same loss (of the
    family ``apply_fn``; None for PaiNN), optimizer and epoch loop over the
    host batches ``batches``, with the step data-parallel over the
    structure axis, or member-parallel with ``ensemble=True`` (``params``
    then stacked). Every rank calls it with the same arguments. Returns
    (params, history) on every rank: the trained parameters in the form
    given, on the mesh's device, and per epoch the mean over batches of the
    member-mean loss."""
    check_family(cfg, apply_fn)
    batches = list(batches)
    n_dev = mesh.axis_size(axis)
    ragged = [len(b.positions) for b in batches if len(b.positions) % n_dev != 0]
    if not ensemble and ragged:
        raise ValueError(
            f"data-parallel sharding needs every batch's structure count "
            f"divisible by the {n_dev}-device '{axis}' mesh axis; got batch "
            f"sizes {ragged} (pad or drop the ragged tail batch)")
    params = tree_map(lambda x: x.to(mesh.device), params)
    if ensemble:
        n_members = tree_leaves(params)[0].shape[0]
        if n_members % n_dev != 0:
            raise ValueError(
                f"ensemble sharding needs the member count ({n_members}) "
                f"divisible by the {n_dev}-device '{axis}' mesh axis")
        trainer = Trainer(shard_chain_states(params, mesh, axis), cfg, tcfg, ensemble=True,
                          apply_fn=apply_fn)
        step = make_ensemble_sharded_train_step(trainer, mesh, axis)
    else:
        trainer = Trainer(params, cfg, tcfg, apply_fn=apply_fn)
        step = make_sharded_train_step(trainer, mesh, axis)
    dev_batches = [batch_to_device(b, mesh.device) for b in batches]
    history = []
    for _ in range(tcfg.epochs):
        epoch = 0.0
        for batch in dev_batches:
            epoch += float(step(batch).mean())
        history.append(epoch / max(len(dev_batches), 1))
    out = trainer.params()
    return (gather_chain_states(out, mesh, axis) if ensemble else out), history
