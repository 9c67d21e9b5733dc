"""Force-loss training and fine-tuning of the three model families on
energy + force (+ magmom) data.

The counterpart of ``surface_sampling_tpu/models/train.py``: padded batches
of structures (``pad_structures``), the energy + force + magmom loss
(``make_loss_fn``) and an Adam loop with per-member global-norm clipping
(``Trainer``, ``train_painn``), which trains a single model or every member
of a stacked tree in one loop. The family is chosen by ``apply_fn``, as in
the JAX package: None for PaiNN, ``models.chgnet.chgnet_apply_structures``
for CHGNet (the only family with a magmom head), ``models.mace.mace_apply``
for MACE.

The loss differentiates the energy twice: the forces F = -dE/dx come from
``torch.autograd.grad(..., create_graph=True)`` and the loss over F is
differentiated over the parameters. On the card PaiNN's message block runs
its second order through the ``painn_message_bwd2`` kernel
(``ops/painn_kernels.py``); CHGNet's atom conv runs its first order through
the ``chgnet_conv_bwd`` kernel and its second order in plain PyTorch
(``ops/chgnet_kernels.py``); MACE is plain PyTorch. The PaiNN message
kernels sum the edge cotangents over the members, so one backward cannot
separate the members' forces: the loss runs the trunk and the force pass
once per member (over edges built once per batch for PaiNN), and one outer
backward gives every member its own gradient (the members share no
parameter).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

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
    magmom_weight: float = 0.0   # > 0: train CHGNet's magmom head too
    epochs: int = 100
    grad_clip: float = 10.0


NO_MAGMOM = ("magmom_weight > 0 but the model family returns no 'magmom' output "
             "(only CHGNet's does)")


def check_family(cfg, apply_fn: Callable | None) -> None:
    """Refuse a configuration of another family than PaiNN without that
    family's ``apply_fn``."""
    if apply_fn is None and not isinstance(cfg, PaiNNConfig):
        raise ValueError(f"a {type(cfg).__name__} trains through its family's apply_fn "
                         "(chgnet_apply_structures, mace_apply); apply_fn=None is PaiNN")


def make_loss_fn(cfg, tcfg: TrainConfig, apply_fn: Callable | None = None):
    """The loss of the JAX package's ``make_loss_fn``, term by term: per
    structure ``w_e ((E - E_ref) / n)^2 + w_f sum_alive (F - F_ref)^2 /
    (3 n)`` with n = max(number of alive atoms, 1), plus, with
    ``tcfg.magmom_weight`` > 0, ``w_m mask sum_alive (m - m_ref)^2 / n``,
    where the batch's ``magmom_mask`` is 0 on frames without magmom labels
    (they must not pull the head toward the zero padding); averaged over
    the batch.

    ``apply_fn`` is the family: None for PaiNN (``cfg`` a ``PaiNNConfig``),
    else ``apply_fn(params, cfg, positions, numbers, alive, shifts) ->
    dict`` of one model on a (C, N) batch, with ``energy`` (C,) and, for
    the magmom term, ``magmom`` (C, N) (``chgnet_apply_structures``,
    ``mace_apply``). A magmom weight with a family that returns no magmom
    raises (PaiNN here, MACE at the first call).

    Returns ``loss_fn(params, batch, create_graph=True) -> (K,)``: the loss
    of every member of a stacked tree (leading member axis K) on a device
    batch (:func:`batch_to_device`). Members share no parameter, so the
    gradient of the summed losses is each member's own gradient.
    ``create_graph=False`` evaluates the loss without the graph its
    gradient needs."""
    check_family(cfg, apply_fn)
    need_mag = tcfg.magmom_weight > 0.0
    if need_mag and apply_fn is None:
        raise ValueError(NO_MAGMOM)

    def loss_fn(params: dict, batch: PaddedBatch, create_graph: bool = True) -> torch.Tensor:
        alive = batch.numbers > 0
        n = alive.sum(dim=1).clamp(min=1).to(batch.energy.dtype)
        K = tree_leaves(params)[0].shape[0]
        losses = []
        with torch.enable_grad():
            pos = batch.positions.detach().requires_grad_(True)
            if apply_fn is None:
                edges, msg_geom = structure_edges(cfg, pos, batch.numbers, batch.shifts)
            for k in range(K):
                if apply_fn is None:
                    p_k = tree_map(lambda x, k=k: x[k:k + 1], params)
                    out = painn_apply(p_k, cfg, batch.numbers, alive, msg_geom, edges)
                    e = out["energy"][:, 0]
                else:
                    out = apply_fn(tree_map(lambda x, k=k: x[k], params), cfg, pos,
                                   batch.numbers, alive, batch.shifts)
                    if need_mag and "magmom" not in out:
                        raise ValueError(NO_MAGMOM)
                    e = out["energy"]
                # PaiNN's edge geometry graph serves every member's force pass
                (g,) = torch.autograd.grad(e.sum(), pos, create_graph=create_graph,
                                           retain_graph=create_graph or k < K - 1)
                e_loss = ((e - batch.energy) / n) ** 2
                f_sq = torch.where(alive[..., None], (-g - batch.forces) ** 2,
                                   torch.zeros_like(g))
                f_loss = f_sq.sum(dim=(1, 2)) / (3 * n)
                loss = tcfg.energy_weight * e_loss + tcfg.force_weight * f_loss
                if need_mag and batch.magmoms is not None:
                    m_sq = torch.where(alive, (out["magmom"] - batch.magmoms) ** 2,
                                       torch.zeros_like(batch.magmoms))
                    mask = (batch.magmom_mask if batch.magmom_mask is not None
                            else torch.ones_like(n))
                    loss = loss + tcfg.magmom_weight * mask * (m_sq.sum(dim=1) / n)
                losses.append(loss.mean())
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
    update. ``apply_fn`` is the family (:func:`make_loss_fn`)."""

    def __init__(self, params: dict, cfg, tcfg: TrainConfig = TrainConfig(),
                 ensemble: bool = False, apply_fn: Callable | None = None):
        stacked = params if ensemble else stack_members([params])
        self.ensemble, self.tcfg = ensemble, tcfg
        self.stacked = tree_map(lambda x: x.detach().clone().requires_grad_(True), stacked)
        self.leaves = tree_leaves(self.stacked)
        self.device = self.leaves[0].device
        self.loss_fn = make_loss_fn(cfg, tcfg, apply_fn)
        self.state = _AdamState(0, [torch.zeros_like(p) for p in self.leaves],
                                [torch.zeros_like(p) for p in self.leaves])

    def gradients(self, batch: PaddedBatch) -> tuple[torch.Tensor, list]:
        """The (K,) member losses on a device batch and the gradient of each
        parameter leaf (in ``self.leaves``' order), before any update."""
        losses = self.loss_fn(self.stacked, batch)
        # a leaf the loss does not reach (CHGNet's last bond and angle
        # layers, its magmom head without the magmom term) gets zeros
        grads = torch.autograd.grad(losses.sum(), self.leaves, materialize_grads=True)
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


def train_painn(params: dict, cfg, batches, tcfg: TrainConfig = TrainConfig(),
                ensemble: bool = False, apply_fn: Callable | None = None):
    """Train (or fine-tune) model parameters of any family (``apply_fn``, as
    in :func:`make_loss_fn`; None for PaiNN) for ``tcfg.epochs`` passes over
    the host PaddedBatches ``batches``; returns (params, history), the
    params in the form given (see :class:`Trainer`) and, per epoch, the mean
    of the step losses, averaged over the members. A magmom weight that no
    batch's labels can train raises (the head would silently get a zero
    gradient for the whole run)."""
    batches = list(batches)
    if tcfg.magmom_weight > 0.0 and not any(
            b.magmom_mask is not None and np.asarray(b.magmom_mask).any() for b in batches):
        raise ValueError("magmom_weight > 0 but no batch carries magmom labels: the magmom "
                         "head would silently receive zero gradient for the whole run; drop "
                         "magmom_weight or load a labelled dataset")
    trainer = Trainer(params, cfg, tcfg, ensemble, apply_fn)
    dev_batches = [batch_to_device(b, trainer.device) for b in batches]
    history = [sum(trainer.step(b) for b in dev_batches) / len(dev_batches)
               for _ in range(tcfg.epochs)]
    return trainer.params(), history


# family-agnostic alias, as in the JAX package; ``init_ensemble``
# (models/painn.py) is the JAX package's ``models.train.init_ensemble``
train_model = train_painn

__all__ = ["PaddedBatch", "TrainConfig", "Trainer", "batch_to_device", "init_ensemble",
           "make_loss_fn", "pad_structures", "train_model", "train_painn"]
