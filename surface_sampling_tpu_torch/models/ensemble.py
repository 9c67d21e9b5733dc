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
    stack_members,
    tree_map,
)
from surface_sampling_tpu_torch.ops.neighbors import Edges, image_search_edges


def stack_params(params_list) -> dict:
    """Stack per-member parameter trees along a new leading ensemble axis
    (the JAX package's ``stack_params``)."""
    return stack_members(list(params_list))


def _stats(out: dict) -> dict:
    energies = out["energy"]
    stats = {
        "member_energy": energies,
        "energy": energies.mean(dim=1),
        "energy_std": energies.std(dim=1, unbiased=False),
        "per_atom_energy": out["per_atom_energy"].mean(dim=1),
    }
    if "embedding" in out:
        stats["embedding"] = out["embedding"].mean(dim=1)
        stats["member_embedding"] = out["embedding"]
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
    :func:`ensemble_apply_rigid` plus ``embedding`` (C, N, F), the
    member-mean final scalar features, and ``member_embedding`` (C, K, N,
    F), as JAX's; ``collect_layers`` adds the member-stacked inputs of every
    message block, ``layer_s`` (C, K, L, N, F) and ``layer_v`` (C, K, L, N,
    3F) x-major, in slot order."""
    if msg_geom is None:
        msg_geom = prepare_message_geometry(cfg, edges, band)
    return _stats(painn_apply(params, cfg, numbers, alive, msg_geom, edges, band,
                              collect_layers))


def ensemble_forces_std(stacked_params: dict, cfg: PaiNNConfig, positions: torch.Tensor,
                        numbers: torch.Tensor, alive: torch.Tensor,
                        shifts: torch.Tensor) -> torch.Tensor:
    """Per-atom std over the members of their forces (the uncertainty of
    the reference's clustering ``force_std``): (C, N, 3), zero on dead
    atoms, for a (C, N) batch of structures with image shifts (K, 3) or
    (C, K, 3). The edges come from one image search; each member's forces
    come from its own backward pass (the message kernels sum the edge
    cotangents over members, so one pass cannot separate them), through the
    message backward kernel. The std is the population std, as
    ``jnp.std``."""
    K = stacked_params["atom_embed"].shape[0]
    forces = []
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        edges = image_search_edges(pos, alive, shifts, cfg.cutoff, cfg.max_neighbors)
        msg_geom = prepare_message_geometry(cfg, edges)
        for k in range(K):
            p_k = tree_map(lambda x, k=k: x[k:k + 1], stacked_params)
            e = painn_apply(p_k, cfg, numbers, alive, msg_geom, edges)["energy"]
            # the edge geometry's graph serves every member's pass
            (g,) = torch.autograd.grad(e.sum(), pos, retain_graph=k < K - 1)
            forces.append(-g)
    std = torch.stack(forces).std(dim=0, unbiased=False)
    return torch.where(alive[..., None], std, torch.zeros_like(std))
