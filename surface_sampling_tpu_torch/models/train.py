"""PaiNN training and fine-tuning on energy + force data.

The counterpart of ``surface_sampling_tpu/models/train.py`` for the PaiNN
family: padded batches of structures (``pad_structures``), the energy +
force loss (``make_loss_fn``) and an Adam loop with per-member global-norm
clipping (``Trainer``, ``train_painn``), which trains a single model or
every member of an ensemble in one loop.

The loss differentiates the energy twice: the forces F = -dE/dx come from
``torch.autograd.grad(..., create_graph=True)`` and the loss over F is
differentiated over the parameters. On the card the message block's
second order runs the ``painn_message_bwd2`` kernel
(``ops/painn_kernels.py``). The message kernels sum the edge cotangents over
the members, so one backward cannot separate the members' forces: the
loss runs the trunk and the force pass once per member over edges built
once per batch, and one outer backward gives every member its own
gradient (the members share no parameter).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    init_ensemble,
    painn_apply,
    stack_members,
    structure_edges,
    tree_leaves,
    tree_map,
)
from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for


class PaddedBatch(NamedTuple):
    """Fixed-shape batch: B structures padded to N atoms (numpy arrays on
    the host, or tensors on a device after :func:`batch_to_device`)."""

    positions: np.ndarray    # (B, N, 3)
    numbers: np.ndarray      # (B, N) 0 = padding
    shifts: np.ndarray       # (B, K, 3) image shifts, unused slots at 1e6
    energy: np.ndarray       # (B,) training units
    forces: np.ndarray       # (B, N, 3)
    magmoms: np.ndarray | None = None       # (B, N) per-atom magnetic moments
    magmom_mask: np.ndarray | None = None   # (B,) 1.0 where a frame has magmoms


def pad_structures(structures, energies, forces, cutoff: float, n_max=None, k_max=None,
                   magmoms=None) -> PaddedBatch:
    """Pad a list of Structures and their labels into one PaddedBatch, each
    with the image shifts its cell needs for ``cutoff``; unused shift slots
    are parked at 1e6 (no pair reaches them)."""
    n_max = n_max or max(len(s) for s in structures)
    all_shifts = [pair_shifts_for(s.cell, s.scaled_positions, cutoff) for s in structures]
    k_max = k_max or max(len(sh) for sh in all_shifts)
    B = len(structures)
    positions = np.zeros((B, n_max, 3))
    numbers = np.zeros((B, n_max), dtype=np.int32)
    shifts = np.full((B, k_max, 3), 1e6)
    forces_arr = np.zeros((B, n_max, 3))
    mag_arr = np.zeros((B, n_max)) if magmoms is not None else None
    mag_mask = np.zeros(B) if magmoms is not None else None
    for b, (s, sh, f) in enumerate(zip(structures, all_shifts, forces)):
        n = len(s)
        positions[b, :n] = s.positions
        numbers[b, :n] = s.numbers
        shifts[b, :len(sh)] = sh
        forces_arr[b, :n] = f
        if mag_arr is not None and magmoms[b] is not None:
            mag_arr[b, :n] = magmoms[b]
            mag_mask[b] = 1.0
    return PaddedBatch(positions, numbers, shifts, np.asarray(energies, dtype=np.float64),
                       forces_arr, mag_arr, mag_mask)


def batch_to_device(b: PaddedBatch, device) -> PaddedBatch:
    """A host batch as tensors on ``device``: f32 floats, int64 numbers."""
    def f32(x):
        return None if x is None else torch.as_tensor(np.asarray(x, np.float32), device=device)

    return PaddedBatch(f32(b.positions), torch.as_tensor(np.asarray(b.numbers, np.int64),
                                                         device=device),
                       f32(b.shifts), f32(b.energy), f32(b.forces), f32(b.magmoms),
                       f32(b.magmom_mask))


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    energy_weight: float = 0.05
    force_weight: float = 0.95
    magmom_weight: float = 0.0   # PaiNN has no magmom head: > 0 raises
    epochs: int = 100
    grad_clip: float = 10.0


def make_loss_fn(cfg: PaiNNConfig, tcfg: TrainConfig):
    """The energy + force loss of the JAX package's ``make_loss_fn``, term
    by term: per structure ``w_e ((E - E_ref) / n)^2 + w_f sum_alive
    (F - F_ref)^2 / (3 n)`` with n = max(number of alive atoms, 1), averaged
    over the batch.

    Returns ``loss_fn(params, batch, create_graph=True) -> (K,)``: the loss
    of every member of a stacked tree (leading member axis K) on a device
    batch (:func:`batch_to_device`). Members share no parameter, so the
    gradient of the summed losses is each member's own gradient.
    ``create_graph=False`` evaluates the loss without the graph its
    gradient needs."""
    if tcfg.magmom_weight > 0.0:
        raise ValueError("magmom_weight > 0 but the PaiNN family has no 'magmom' output "
                         "(only CHGNet does)")

    def loss_fn(params: dict, batch: PaddedBatch, create_graph: bool = True) -> torch.Tensor:
        alive = batch.numbers > 0
        n = alive.sum(dim=1).clamp(min=1).to(batch.energy.dtype)
        losses = []
        with torch.enable_grad():
            pos = batch.positions.detach().requires_grad_(True)
            edges, msg_geom = structure_edges(cfg, pos, batch.numbers, batch.shifts)
            K = params["atom_embed"].shape[0]
            for k in range(K):
                p_k = tree_map(lambda x, k=k: x[k:k + 1], params)
                e = painn_apply(p_k, cfg, batch.numbers, alive, msg_geom, edges)["energy"][:, 0]
                # the edge geometry's graph serves every member's force pass
                (g,) = torch.autograd.grad(e.sum(), pos, create_graph=create_graph,
                                           retain_graph=create_graph or k < K - 1)
                e_loss = ((e - batch.energy) / n) ** 2
                f_sq = torch.where(alive[..., None], (-g - batch.forces) ** 2,
                                   torch.zeros_like(g))
                f_loss = f_sq.sum(dim=(1, 2)) / (3 * n)
                losses.append((tcfg.energy_weight * e_loss + tcfg.force_weight * f_loss).mean())
        return torch.stack(losses)

    return loss_fn


class _AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


def _clip_adam_update(leaves, grads, state: _AdamState, tcfg: TrainConfig, K: int,
                      b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0) -> _AdamState:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))`` applied to
    each member of the stacked leaves in place: each member is clipped by its
    own global norm (scaled by grad_clip / norm only when norm >= grad_clip,
    optax's rule), then one Adam step with optax's defaults."""
    sq = sum(g.reshape(K, -1).pow(2).sum(dim=1) for g in grads)
    g_norm = torch.sqrt(sq)                                          # (K,)
    keep = g_norm < tcfg.grad_clip
    count = state.count + 1
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    mu_new, nu_new = [], []
    with torch.no_grad():
        for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
            shape = (K,) + (1,) * (g.dim() - 1)
            norm = g_norm.reshape(shape)
            g = torch.where(keep.reshape(shape), g, (g / norm) * tcfg.grad_clip)
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            update = (mu / c1) / (torch.sqrt(nu / c2 + eps_root) + eps)
            p.sub_(tcfg.learning_rate * update)
            mu_new.append(mu)
            nu_new.append(nu)
    return _AdamState(count, mu_new, nu_new)


class Trainer:
    """The optimizer loop of :func:`train_painn`, one step at a time.

    ``params`` is one model's tree of tensors (``ensemble=False``) or a
    stacked tree with a leading member axis (``ensemble=True``), on the
    device the training runs on (the card, or the CPU for the plain path);
    the trainer trains its own copy. Every member trains in the same step,
    with its own clipping and Adam moments, as the JAX package's vmapped
    update."""

    def __init__(self, params: dict, cfg: PaiNNConfig, tcfg: TrainConfig = TrainConfig(),
                 ensemble: bool = False):
        stacked = params if ensemble else stack_members([params])
        self.ensemble, self.tcfg = ensemble, tcfg
        self.device = stacked["atom_embed"].device
        self.stacked = tree_map(lambda x: x.detach().clone().requires_grad_(True), stacked)
        self.leaves = tree_leaves(self.stacked)
        self.loss_fn = make_loss_fn(cfg, tcfg)       # raises on magmom_weight > 0
        self.state = _AdamState(0, [torch.zeros_like(p) for p in self.leaves],
                                [torch.zeros_like(p) for p in self.leaves])

    def gradients(self, batch: PaddedBatch) -> tuple[torch.Tensor, list]:
        """The (K,) member losses on a device batch and the gradient of each
        parameter leaf (in ``self.leaves``' order), before any update."""
        losses = self.loss_fn(self.stacked, batch)
        grads = torch.autograd.grad(losses.sum(), self.leaves)
        return losses.detach(), list(grads)

    def apply(self, grads) -> None:
        """One clipped Adam step from gradients of :meth:`gradients`' form
        (a data-parallel step averages them over ranks first)."""
        self.state = _clip_adam_update(self.leaves, grads, self.state, self.tcfg,
                                       self.leaves[0].shape[0])

    def step(self, batch: PaddedBatch) -> float:
        """One clipped Adam step on a device batch; returns the member-mean
        loss before the step."""
        losses, grads = self.gradients(batch)
        self.apply(grads)
        return float(losses.mean())

    def params(self) -> dict:
        """A copy of the current parameters, in the form they were given."""
        out = tree_map(lambda x: x.detach().clone(), self.stacked)
        return out if self.ensemble else tree_map(lambda x: x[0], out)


def train_painn(params: dict, cfg: PaiNNConfig, batches, tcfg: TrainConfig = TrainConfig(),
                ensemble: bool = False):
    """Train (or fine-tune) PaiNN parameters for ``tcfg.epochs`` passes over
    the host PaddedBatches ``batches``; returns (params, history), the
    params in the form given (see :class:`Trainer`) and, per epoch, the mean
    of the step losses, averaged over the members."""
    trainer = Trainer(params, cfg, tcfg, ensemble)
    dev_batches = [batch_to_device(b, trainer.device) for b in batches]
    history = [sum(trainer.step(b) for b in dev_batches) / len(dev_batches)
               for _ in range(tcfg.epochs)]
    return trainer.params(), history


# family-agnostic alias, as in the JAX package (PaiNN is the only family
# trained here); ``init_ensemble`` (models/painn.py) is the JAX package's
# ``models.train.init_ensemble``
train_model = train_painn

__all__ = ["PaddedBatch", "TrainConfig", "Trainer", "batch_to_device", "init_ensemble",
           "make_loss_fn", "pad_structures", "train_model", "train_painn"]
