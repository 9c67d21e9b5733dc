"""NN ensembles as a member batch dimension.

The counterpart of ``surface_sampling_tpu/models/ensemble.py``: members
are the leading axis K of one stacked parameter tree, and every kernel of
the forward runs all members of all chains in one launch. The ensemble
energy is the mean over members.
"""

from __future__ import annotations

import torch

from surface_sampling_tpu_torch.models.painn import PaiNNConfig, painn_apply_rigid


def ensemble_apply(params: dict, rw: dict, cfg: PaiNNConfig, numbers: torch.Tensor,
                   alive: torch.Tensor, msg_geom, edges) -> dict:
    """Forward all members on a (C, N) batch of structures.

    Returns ``member_energy`` (C, K), the ensemble ``energy`` and
    ``energy_std`` (C,) over members, and the member-mean
    ``per_atom_energy`` (C, N), in training units."""
    out = painn_apply_rigid(params, rw, cfg, numbers, alive, msg_geom, edges)
    energies = out["energy"]
    return {
        "member_energy": energies,
        "energy": energies.mean(dim=1),
        "energy_std": energies.std(dim=1, unbiased=False),
        "per_atom_energy": out["per_atom_energy"].mean(dim=1),
    }
