"""Parallel tempering (replica exchange) over the chain batch axis.

The counterpart of ``surface_sampling_tpu/parallel/tempering.py``: C
replicas on a temperature ladder, one MC sweep each at its own temperature,
then configurations exchanged between neighbouring temperatures with
p = min(1, exp[(beta_i - beta_j)(E_i - E_j)]). On one card the replicas are
the chain batch, and a swap is one gather along the chain axis of every
tensor of the state, so ``core.incremental.IncState``'s caches and the
frozen-far-field caches travel with the configurations they describe. The
swap uniforms come from the run's ``torch.Generator``, which is continued in
place (the JAX record's ``swap_key`` has no counterpart: passing the
generator to the next chunk, with its ``start``, continues the swap
sequence).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def temperature_ladder(t_min: float, t_max: float, n: int) -> np.ndarray:
    """Geometric ladder from t_max (replica 0) down to t_min."""
    return np.geomspace(t_max, t_min, n)


class TemperRecord(NamedTuple):
    """Per-round observables, leading axis rounds (the JAX package's)."""

    energy: torch.Tensor        # (rounds, C) after each round's swap phase
    swap_rate: torch.Tensor     # (rounds,)
    site_state: torch.Tensor    # (rounds, C, S)


def take_chains(state, idx: torch.Tensor):
    """``state`` (a tensor or a possibly nested NamedTuple / tuple of
    chain-batched tensors) with chain c taken from chain ``idx[c]``."""
    if isinstance(state, torch.Tensor):
        return state[idx]
    if isinstance(state, tuple):
        vals = [take_chains(x, idx) for x in state]
        return type(state)(*vals) if hasattr(state, "_fields") else tuple(vals)
    return state


def swap_phase(states, temps: torch.Tensor, u: torch.Tensor, parity, pair_ok=None):
    """Attempt swaps between the replica pairs (i, i + 1) whose left index i
    has ``parity``; ``u`` (C,) uniforms, read by each pair's left member
    (the JAX package's ``uniform(key, (C,))``); ``pair_ok`` (C,) bool gates
    the pair of each left index (the pod schedule). ``states`` is any
    chain-batched NamedTuple with an ``energy`` field. Returns the swapped
    states and the acceptance rate over the attempted pairs."""
    C = temps.shape[0]
    idx = torch.arange(C, device=temps.device)
    is_left = (idx % 2) == parity
    partner = torch.where(is_left, idx + 1, idx - 1).clamp(0, C - 1)
    valid = partner != idx
    if pair_ok is not None:
        valid = valid & pair_ok[torch.where(is_left, idx, partner)]
    e = states.energy
    beta = 1.0 / torch.clamp(temps, min=1e-12)
    delta = (beta - beta[partner]) * (e - e[partner])
    left = torch.where(is_left, idx, partner)
    accept = (torch.log(u[left] + 1e-38) < delta[left]) & valid
    rate = accept.to(torch.float32).sum() / torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    return take_chains(states, torch.where(accept, partner, idx)), rate


def make_tempered_run(run_fn: Callable, n_rounds: int, pod_size: int | None = None,
                      dcn_every: int = 4) -> Callable:
    """Build ``run(states, temps, generator, start=0) -> (states,
    TemperRecord)``.

    ``run_fn(states, temps, generator)`` is any of the port's runs
    (``core.engine.make_run_fn``, ``core.incremental.make_incremental_run``,
    ...): a round is one sweep of it with per-replica temperatures (temps
    (C, 1)), then the swap phase with C uniforms from ``generator``. Rounds
    alternate the pair parity. ``start`` offsets the round counter (parity
    and pod schedule), so a run cut into chunks that pass the generator
    along repeats one run bitwise.

    ``pod_size``: the JAX package's multi-pod schedule, chain-index gating
    only here: pairs that cross a boundary of ``pod_size`` replicas are
    attempted only on every ``dcn_every``-th round, whose parity alternates
    on its own counter.
    """

    def run(states, temps, generator: torch.Generator, start: int = 0):
        dev = states.energy.device
        temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
        C = temps.shape[0]
        idx = torch.arange(C, device=dev)
        if pod_size is not None:
            crosses = ((idx + 1) % pod_size == 0) & (idx + 1 < C)
        else:
            crosses = torch.zeros(C, dtype=torch.bool, device=dev)
        energy, rates, sites = [], [], []
        for r in range(int(start), int(start) + n_rounds):
            states, _ = run_fn(states, temps[:, None], generator)
            u = torch.rand((C,), generator=generator, device=generator.device)
            dcn_round = (r % dcn_every) == dcn_every - 1
            pair_ok = torch.ones_like(crosses) if dcn_round else ~crosses
            parity = (r // dcn_every) % 2 if dcn_round else r % 2
            states, rate = swap_phase(states, temps, u, parity, pair_ok)
            energy.append(states.energy)
            rates.append(rate)
            sites.append(states.site_state)
        return states, TemperRecord(energy=torch.stack(energy), swap_rate=torch.stack(rates),
                                    site_state=torch.stack(sites))

    return run
