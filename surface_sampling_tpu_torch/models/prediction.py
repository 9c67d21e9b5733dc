"""Batched model prediction over padded structure batches.

The counterpart of ``surface_sampling_tpu/models/prediction.py``:
``get_prediction`` runs the forward and the forces of a PaddedBatch (an
ensemble's member mean and population std); the pooling and error helpers
work on its outputs as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    painn_apply_structures,
    stack_members,
)
from surface_sampling_tpu_torch.models.train import batch_to_device


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_prediction(params: dict, cfg: PaiNNConfig, batch, ensemble: bool = False) -> dict:
    """Energies (B,), forces (B, N, 3), embeddings (B, N, F) and the
    energy std (B,) of a host PaddedBatch, as tensors on the parameters'
    device. ``params`` is one model's tree, or with ``ensemble`` a stacked
    tree whose members are averaged: energy, forces and embedding are the
    member means (the mean forces are the gradient of the mean energy) and
    ``energy_std`` is the population std over members (ddof 0, as
    ``jnp.std``); zeros for one model."""
    stacked = params if ensemble else stack_members([params])
    b = batch_to_device(batch, stacked["atom_embed"].device)
    with torch.enable_grad():
        pos = b.positions.detach().requires_grad_(True)
        out = painn_apply_structures(stacked, cfg, pos, b.numbers, b.shifts)
        e = out["energy"]                                            # (B, K)
        (g,) = torch.autograd.grad(e.mean(dim=1).sum(), pos)
    e = e.detach()
    return {"energy": e.mean(dim=1), "forces": -g,
            "embedding": out["embedding"].detach().mean(dim=1),
            "energy_std": e.std(dim=1, correction=0)}


def get_embedding(pred: dict, numbers, pool: str = "mean", center_mask=None) -> np.ndarray:
    """Per-system pooled embeddings (B, F) from the per-atom ones, over the
    alive atoms (and ``center_mask`` (B, N), where given)."""
    emb = _np(pred["embedding"])
    alive = np.asarray(numbers) > 0
    if center_mask is not None:
        alive = alive & np.asarray(center_mask, bool)
    w = alive[..., None].astype(emb.dtype)
    summed = (emb * w).sum(axis=1)
    if pool == "sum":
        return summed
    return summed / np.maximum(w.sum(axis=1), 1.0)


def get_system_val(values, numbers, order: str = "mean") -> np.ndarray:
    """Masked per-system reduction of per-atom values (vectors reduce to
    their norm first)."""
    v = _np(values)
    alive = np.asarray(numbers) > 0
    if v.ndim == 3:
        v = np.linalg.norm(v, axis=-1)
    masked = np.where(alive, v, np.nan)
    reducers = {"sum": np.nansum, "mean": np.nanmean, "max": np.nanmax, "min": np.nanmin}
    if order not in reducers:
        raise ValueError(order)
    return reducers[order](masked, axis=1)


def get_errors(pred: dict, batch) -> dict:
    """Energy (per atom) and force residuals against a labelled batch."""
    alive = np.asarray(batch.numbers) > 0
    n = np.maximum(alive.sum(axis=1), 1)
    e_err = np.abs(_np(pred["energy"]) - np.asarray(batch.energy)) / n
    f_err = get_system_val(_np(pred["forces"]) - np.asarray(batch.forces), batch.numbers, "mean")
    return {"energy_mae_per_atom": e_err, "force_mae": f_err}


def get_residual(pred: dict, batch) -> np.ndarray:
    """Per-system mean force-residual norms (conformal calibration input)."""
    return get_system_val(_np(pred["forces"]) - np.asarray(batch.forces), batch.numbers, "mean")
