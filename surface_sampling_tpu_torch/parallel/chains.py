"""Batches of independent Markov chains.

The counterpart of ``chain_states`` and ``make_chain_run`` in
``surface_sampling_tpu/parallel/chains.py``. There the chain axis is
added by ``vmap``; here every function of the port is already batched
over a leading chain axis, so a chain run is the run function itself,
called on a (C, ...) state.
"""

from __future__ import annotations

from typing import Callable

import torch

from surface_sampling_tpu_torch.core.state import DeviceSpec, MCState, initial_state


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
