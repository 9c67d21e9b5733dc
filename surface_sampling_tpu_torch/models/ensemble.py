"""NN ensembles as a member batch dimension.

The counterpart of ``surface_sampling_tpu/models/ensemble.py``: members
are the leading axis K of one stacked parameter tree, and every kernel of
the forward runs all members of all chains in one launch. The ensemble
energy is the mean over members.
"""

from __future__ import annotations

import torch

from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    painn_apply,
    painn_apply_rigid,
    prepare_message_geometry,
)
from surface_sampling_tpu_torch.ops.neighbors import Edges


def _stats(out: dict) -> dict:
    energies = out["energy"]
    stats = {
        "member_energy": energies,
        "energy": energies.mean(dim=1),
        "energy_std": energies.std(dim=1, unbiased=False),
        "per_atom_energy": out["per_atom_energy"].mean(dim=1),
    }
    for key in ("layer_s", "layer_v"):
        if key in out:
            stats[key] = out[key]
    return stats


def ensemble_apply_rigid(params: dict, rw: dict, cfg: PaiNNConfig, numbers: torch.Tensor,
                         alive: torch.Tensor, msg_geom, edges, band=None) -> dict:
    """Rigid forward of all members on a (C, N) batch of structures over
    static edge geometry (``ops.static_edges``; ``band`` is its pack's
    routing band, for a supercell).

    Returns ``member_energy`` (C, K), the ensemble ``energy`` and
    ``energy_std`` (C,) over members, and the member-mean
    ``per_atom_energy`` (C, N), in training units."""
    return _stats(painn_apply_rigid(params, rw, cfg, numbers, alive, msg_geom, edges, band))


def ensemble_apply(params: dict, cfg: PaiNNConfig, numbers: torch.Tensor,
                   alive: torch.Tensor, edges: Edges, msg_geom=None, band=None,
                   collect_layers: bool = False) -> dict:
    """General forward of all members on a (C, N) batch of structures,
    differentiable in the positions ``edges`` were built from
    (``ops.neighbors``; for a supercell with its routing ``band``, a
    ``DeviceBand``, which runs the banded trunk). The padded message
    geometry is member-invariant: it is built once (or passed as
    ``msg_geom``) and shared by the K members. Returns the same fields as
    :func:`ensemble_apply_rigid`; ``collect_layers`` adds the member-stacked
    inputs of every message block, ``layer_s`` (C, K, L, N, F) and
    ``layer_v`` (C, K, L, N, 3F) x-major, in slot order."""
    if msg_geom is None:
        msg_geom = prepare_message_geometry(cfg, edges, band)
    return _stats(painn_apply(params, cfg, numbers, alive, msg_geom, edges, band,
                              collect_layers))
