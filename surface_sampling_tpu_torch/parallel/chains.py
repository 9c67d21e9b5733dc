"""Batches of independent Markov chains, on one card or sharded over a
rank mesh.

The counterpart of ``surface_sampling_tpu/parallel/chains.py``. There the
chain axis is added by ``vmap`` and sharded by ``shard_map``; here every
function of the port is already batched over a leading chain axis, so a
chain run is the run function itself, called on a (C, ...) state, and a
sharded run is that run on each rank's contiguous block of the global
batch (``parallel/mesh.py``).

A sharded run has no collective inside the MC loop: each rank steps its
own chains on the draws of the whole batch, of which it keeps its block's
rows (``core.events.block_draws``), so that it is, chain for chain, the
unsharded run on the same generator whatever the number of ranks. The
JAX package gets the same property from per-chain keys. Its sharded
outputs are globally addressable arrays; here each rank returns its block,
and :func:`gather_chain_states` assembles the global batch on every rank
(one ``all_gather`` a tensor).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from surface_sampling_tpu_torch.core.events import ChainBlock
from surface_sampling_tpu_torch.core.state import DeviceSpec, MCState, initial_state
from surface_sampling_tpu_torch.parallel.mesh import Axis, RankMesh, all_gather_blocks


def _chain_site_states(d: DeviceSpec, n_chains: int, site_state=None) -> torch.Tensor:
    """(n_chains, S) occupancies: all sites empty, or ``site_state`` — one
    (S,) occupancy broadcast to every chain, or (n_chains, S)."""
    S = d.site_coords.shape[0]
    if site_state is None:
        site_state = torch.zeros((n_chains, S), dtype=torch.int64, device=d.device)
    site_state = torch.as_tensor(site_state, dtype=torch.int64, device=d.device)
    if site_state.ndim == 1:
        site_state = site_state.expand(n_chains, S)
    if tuple(site_state.shape) != (n_chains, S):
        raise ValueError(f"site_state has shape {tuple(site_state.shape)}, "
                         f"expected ({n_chains}, {S})")
    return site_state.clone()


def chain_states(d: DeviceSpec, n_chains: int, site_state=None) -> MCState:
    """Batch of fresh chain states: all sites empty, or ``site_state`` —
    one (S,) occupancy broadcast to every chain, or (n_chains, S)."""
    return initial_state(d, _chain_site_states(d, n_chains, site_state))


def incremental_chain_states(engine, d: DeviceSpec, n_chains: int, site_state=None):
    """Batch of chain states of a ``core.incremental`` engine (caches and
    energies from one full evaluation), with the occupancies of
    :func:`chain_states`."""
    return engine.init_state(_chain_site_states(d, n_chains, site_state))


def relaxed_chain_states(d: DeviceSpec, state_energy_fn, n_chains: int,
                         site_state=None) -> MCState:
    """Batch of chain states for a warm-started engine
    (``core/local_relax.py``): the occupancies of :func:`chain_states`, each
    with the energy and the relaxed positions of one full relaxed
    evaluation (``state_energy_fn`` of a relaxing ``MCMCRun``)."""
    states = chain_states(d, n_chains, site_state)
    first = state_energy_fn(states.site_state)
    return states._replace(energy=first.surface_energy, relaxed_positions=first.positions)


def make_chain_run(run_fn: Callable, share_temps: bool = True) -> Callable:
    """Run ``run_fn`` over a batch of chains. With ``share_temps`` every
    chain follows one schedule, ``temps`` (sweeps,); otherwise ``temps``
    has a leading chain axis, (C, sweeps) — the basis of tempering."""

    def crun(states: MCState, temps, generator: torch.Generator):
        temps = torch.as_tensor(temps)
        want = 1 if share_temps else 2
        if temps.ndim != want:
            raise ValueError(f"temps must have {want} dimension(s) with "
                             f"share_temps={share_temps}, got shape {tuple(temps.shape)}")
        if not share_temps and temps.shape[0] != states.site_state.shape[0]:
            raise ValueError("per-chain temps need one row per chain")
        return run_fn(states, temps, generator)

    return crun


def _map_leaves(fn, tree):
    """``fn`` over the tensor and array leaves of a tree of NamedTuples,
    tuples, lists and dicts (None and other leaves kept)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _leading(tree) -> int:
    sizes = []
    _map_leaves(lambda x: sizes.append(x.shape[0]), tree)
    if not sizes:
        raise ValueError("the tree holds no tensor")
    return sizes[0]


def shard_chain_states(states, mesh: RankMesh, axis: Axis = "chains"):
    """This rank's contiguous block of a batch along its leading axis, in
    every tensor (or array) of ``states``: any tree of NamedTuples, tuples,
    lists and dicts (chain states, per-chain temperatures, a training
    batch's structures, an ensemble's stacked members). With a tuple of
    axes the blocks run pod-major. The leading axis must split evenly."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    total = _leading(states)
    if total % n:
        raise ValueError(f"a batch of {total} does not split over the {n} ranks of "
                         f"mesh axis {axis!r}")
    b = total // n
    return _map_leaves(lambda x: x[i * b:(i + 1) * b], states)


def gather_chain_states(states, mesh: RankMesh, axis: Axis = "chains"):
    """Every rank's block along ``axis`` assembled on every rank, in the
    order :func:`shard_chain_states` split them (one ``all_gather`` per
    tensor): the global batch of a sharded run's states or records."""
    return _map_leaves(lambda x: all_gather_blocks(x, mesh, axis), states)


def chain_block(mesh: RankMesh, axis: Axis, n_block: int) -> ChainBlock:
    """The rows of the global batch that this rank's block of ``n_block``
    chains holds along ``axis`` (equal blocks in axis order)."""
    i = mesh.axis_index(axis)
    return ChainBlock(i * n_block, (i + 1) * n_block, mesh.axis_size(axis) * n_block)


def make_sharded_chain_run(run_fn: Callable, mesh: RankMesh, axis: Axis = "chains",
                           share_temps: bool = True) -> Callable:
    """Shard the chain batch over a mesh axis.

    ``run_fn(states, temps, generator, chain_block=...)`` is any of the
    port's runs (``core.engine.make_run_fn``, the delta, local-relax and FF
    runs). Returns ``srun(states, temps, generator) -> (states, records)``
    over this rank's block (:func:`shard_chain_states`): it runs the block
    as rows of the global batch, so the block's chains take the draws they
    take in the unsharded run on the same generator (seeded alike on every
    rank, on this rank's device). There is no collective in the MC loop;
    the outputs are the block's (:func:`gather_chain_states` assembles
    them). With ``share_temps`` every chain follows one schedule, (sweeps,);
    otherwise ``temps`` holds the block's rows, (C_block, sweeps)."""

    def srun(states, temps, generator: torch.Generator):
        C = states.site_state.shape[0]
        temps = torch.as_tensor(temps)
        want = 1 if share_temps else 2
        if temps.ndim != want:
            raise ValueError(f"temps must have {want} dimension(s) with "
                             f"share_temps={share_temps}, got shape {tuple(temps.shape)}")
        if not share_temps and temps.shape[0] != C:
            raise ValueError("per-chain temps need one row per chain of the block")
        return run_fn(states, temps, generator, chain_block=chain_block(mesh, axis, C))

    return srun


def make_hierarchical_chain_run(run_fn: Callable, mesh: RankMesh,
                                axes: tuple[str, str] = ("pod", "chains"),
                                share_temps: bool = True) -> Callable:
    """Shard the chain batch over both axes of a (pod x chains) mesh
    (``parallel.mesh.pod_mesh``): the global batch splits over the
    flattened grid, pod-major, so each pod owns a contiguous block. It is
    :func:`make_sharded_chain_run` over both axes; shard the states with
    ``shard_chain_states(states, mesh, axis=axes)``."""
    return make_sharded_chain_run(run_fn, mesh, axis=axes, share_temps=share_temps)


def make_ensemble_sharded_energy(batched_member_energy: Callable, mesh: RankMesh,
                                 ensemble_axis: str = "ensemble") -> Callable:
    """Ensemble parallelism: the NN-ensemble member axis sharded over a mesh
    axis.

    ``batched_member_energy(member_params, *args)`` takes a stacked tree
    of members (leading member axis) and returns their energies with the
    member axis first, (K_block, ...). Returns ``fn(stacked_params, *args)
    -> (mean_energy, member_energies)``: each rank evaluates its block of
    the members (:func:`shard_chain_states` of the stacked tree) and one
    ``all_gather`` over the axis assembles the (K, ...) member energies,
    whose mean over members is the ensemble energy, on every rank."""

    def fn(stacked_params, *args):
        local = shard_chain_states(stacked_params, mesh, ensemble_axis)
        e_all = all_gather_blocks(batched_member_energy(local, *args), mesh, ensemble_axis)
        return e_all.mean(dim=0), e_all

    return fn
