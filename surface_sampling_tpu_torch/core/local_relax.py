"""Warm-started ball-local relaxation MC, batched over chains.

The counterpart of ``surface_sampling_tpu/core/local_relax.py``. The
default relaxed path (``core/energy.py``) relaxes every trial state from the
ideal lattice, so every move pays the full FIRE budget on every free atom.
This engine keeps each chain's relaxed geometry as MC state
(``MCState.relaxed_positions``), as the reference's in-place relaxation
does, and a move

  * resets only the moved site's slots to their lattice coordinates (the
    trial adsorbate starts at its ideal site geometry),
  * FIRE-relaxes only the slots within ``hops`` candidate-adjacency hops of
    the moved site against the frozen, already-relaxed far field, and
  * stops on the ball's force convergence, which a warm start reaches in
    fewer iterations than the full budget.

Acceptance energies stay full evaluations of the relaxed geometry (no
feature caches, no drift); a rejected move keeps the chain's positions.
With a ball that covers every free slot, a move from a lattice-positioned
chain runs the FIRE trajectory of the full relaxed path.

The semigrand and canonical steps take the Metropolis criterion or
``metropolis_distance`` (Metropolis under the distance filter of
``core/events.py``); the relaxation is FIRE or L-BFGS, under the scoring
potential or a separate ``relax_potential``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from surface_sampling_tpu_torch.core.energy import (
    RelaxConfig,
    StateEnergy,
    identity_surface_energy,
    relax_and_score,
    relax_settings,
)
from surface_sampling_tpu_torch.core.engine import make_sweep_record, run_sweeps
from surface_sampling_tpu_torch.core.events import (
    canonical_draws,
    hard_wall_accept,
    metropolis_accept,
    pick_exchange,
    propose_change,
    select_trial,
    semigrand_draws,
)
from surface_sampling_tpu_torch.core.relax import energy_threshold
from surface_sampling_tpu_torch.core.state import (
    DeviceSpec,
    MCState,
    element_counts,
    exchange_sites,
    realize_alive,
    realize_free_mask,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.utils.tracing import span


def build_ball_masks(spec, static_nbr, hops: int = 1) -> np.ndarray:
    """(S, N) bool: the slots within ``hops`` hops of each site's slots over
    the static candidate adjacency (``core/static_neighbors.py``; a
    geometric superset of every in-cutoff interaction, so one hop covers a
    cutoff radius of relaxation response). Host numpy, once per system."""
    P, S, G = spec.n_pristine, spec.n_sites, spec.group_size
    N = P + S * G
    slot_j = np.asarray(static_nbr.slot_j)
    valid = np.asarray(static_nbr.valid)
    adj = np.zeros((N, N), bool)
    rows = np.repeat(np.arange(N), slot_j.shape[1])
    ok = valid.reshape(-1)
    adj[rows[ok], slot_j.reshape(-1)[ok]] = True
    adj |= adj.T
    adj |= np.eye(N, dtype=bool)
    masks = np.zeros((S, N), bool)
    for s in range(S):
        masks[s, P + s * G: P + (s + 1) * G] = True
    for _ in range(hops):
        masks = (masks.astype(np.uint8) @ adj.astype(np.uint8)) > 0
    return masks


def make_local_relax_eval(
    d: DeviceSpec,
    potential,
    surface_energy_fn: Callable | None = None,
    relax: RelaxConfig = RelaxConfig(),
    ball_masks: np.ndarray | None = None,
    relax_potential=None,
) -> Callable:
    """Build ``evaluate(trial_ss (C, S), pos_prev (C, N, 3), sites2 (C, 2))
    -> StateEnergy``: the warm-started ball-local counterpart of the relaxed
    state energy of ``core/energy.py`` (the same topology policy, OOB
    clamps and fresh-edge acceptance energy, relaxing under
    ``relax_potential`` when given). ``sites2`` holds each chain's moved
    sites (one site repeated for a single-site move); ``pos_prev`` is each
    chain's current relaxed geometry."""
    if ball_masks is None:
        raise ValueError("ball_masks required (build_ball_masks)")
    fire_cfg, fixed_topo = relax_settings(
        relax, potential if relax_potential is None else relax_potential)
    balls = torch.as_tensor(np.asarray(ball_masks, bool), device=d.device)
    P = d.pristine_positions.shape[0]
    G = d.code_offsets.shape[1]
    sfn = surface_energy_fn or identity_surface_energy

    def evaluate(trial_ss, pos_prev, sites2) -> StateEnergy:
        lat = realize_positions(d, trial_ss)
        type_idx = realize_type_idx(d, trial_ss)
        alive = realize_alive(d, trial_ss)
        counts = element_counts(d, trial_ss, dtype=lat.dtype)
        C, N, _ = lat.shape
        # the moved sites' slots start at the trial code's ideal geometry;
        # every other slot keeps the chain's relaxed coordinates
        slots = (P + sites2.long()[:, :, None] * G
                 + torch.arange(G, device=lat.device)).reshape(C, -1, 1).expand(-1, -1, 3)
        pos0 = pos_prev.to(lat.dtype).scatter(1, slots, torch.gather(lat, 1, slots))
        ball = balls[sites2[:, 0]] | balls[sites2[:, 1]]
        free = realize_free_mask(d, trial_ss) & ball
        bound = torch.full((C,), energy_threshold(N), dtype=lat.dtype, device=lat.device)
        pos, e_pot, oob = relax_and_score(potential, relax.method, fire_cfg, fixed_topo, pos0,
                                          free, type_idx, alive, bound, d.shifts,
                                          relax_potential)
        se = torch.where(oob, bound, sfn(e_pot, counts))
        return StateEnergy(surface_energy=se, potential_energy=e_pot, positions=pos, oob=oob)

    return evaluate


def _local_step(evaluate: Callable, dist_accept, state: MCState, temp, trial_ss, sites2,
                u_acc, valid=None):
    with span("mc.energy"):
        e = evaluate(trial_ss, state.relaxed_positions, sites2)
    temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=trial_ss.device)
    accept = metropolis_accept(u_acc, state.energy, e.surface_energy, temp)
    if valid is not None:
        accept = accept & valid
    if dist_accept is not None:
        accept = accept & dist_accept(trial_ss)
    return select_trial(accept, trial_ss, e, state)


def make_local_relax_semigrand_step(evaluate: Callable, criterion: str = "metropolis",
                                    d: DeviceSpec | None = None,
                                    filter_distance: float = 1.5) -> Callable:
    """``step(state, temp, site, u_code, u_acc) -> (state, StepInfo)``: the
    semigrand Change step of ``core.events.make_semigrand_step`` (the same
    draws, as tensors) with the trial state evaluated by a warm-started
    ball-local relaxation of the moved site (``make_local_relax_eval``).
    ``criterion="metropolis_distance"`` (with ``d``) adds the distance
    filter's hard wall."""
    dist_accept = hard_wall_accept(d, criterion, filter_distance)

    def step(state: MCState, temp, site, u_code, u_acc):
        trial_ss = propose_change(state.site_state, site, u_code)
        return _local_step(evaluate, dist_accept, state, temp, trial_ss,
                           torch.stack([site, site], dim=1), u_acc)

    return step


def make_local_relax_canonical_step(evaluate: Callable, criterion: str = "metropolis",
                                    d: DeviceSpec | None = None,
                                    filter_distance: float = 1.5) -> Callable:
    """``step(state, temp, g_types, g_site1, g_site2, u_acc) -> (state,
    StepInfo)``: the unweighted canonical Exchange step of
    ``core.events.make_canonical_step`` (the same draws) with the trial
    state evaluated by a warm-started ball-local relaxation around both
    exchanged sites. A chain with fewer than two codes present never
    accepts; ``criterion="metropolis_distance"`` (with ``d``) adds the
    distance filter's hard wall."""
    dist_accept = hard_wall_accept(d, criterion, filter_distance)

    def step(state: MCState, temp, g_types, g_site1, g_site2, u_acc):
        ss = state.site_state
        site1, site2, valid = pick_exchange(ss, g_types.shape[1], g_types, g_site1, g_site2)
        trial_ss = exchange_sites(ss, site1, site2)
        return _local_step(evaluate, dist_accept, state, temp, trial_ss,
                           torch.stack([site1, site2], dim=1), u_acc, valid)

    return step


def make_local_relax_run(step_fn: Callable, sweep_size: int, n_sites: int, n_codes: int,
                         canonical: bool = False) -> Callable:
    """``run(state, temps, generator, chain_block=None) -> (state,
    SweepRecord)`` over local-relax steps, with the draws and the record of
    ``core.engine.make_run_fn`` (the same generator state gives the same
    draws; ``canonical`` for an exchange step's; the relaxed positions,
    which are this engine's state, are recorded)."""
    record = make_sweep_record()
    draws = canonical_draws if canonical else semigrand_draws

    def run(state: MCState, temps, generator: torch.Generator, chain_block=None):
        return run_sweeps(step_fn, state, temps, generator, sweep_size, n_sites, n_codes, record,
                          draws, chain_block)

    return run
