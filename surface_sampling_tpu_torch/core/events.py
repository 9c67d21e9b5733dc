"""MC steps (semigrand Change and canonical Exchange) and their acceptance
criteria, batched over chains.

The counterpart of ``surface_sampling_tpu/core/events.py``. A step takes
its random draws as tensors, so a caller can feed it any source of
randomness — the engine's ``torch.Generator`` (``semigrand_draws`` /
``canonical_draws``), or in a test the draws a JAX step made. Dynamic
choices ("one of the codes present", "a site holding that code") are
masked Gumbel draws, so every shape stays static. The distance criteria
and the multiple-try steps are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from surface_sampling_tpu_torch.core.state import (
    DeviceSpec,
    MCState,
    change_site,
    exchange_sites,
    num_occupied_sites,
    realize_alive,
    realize_type_idx,
)

CRITERIA = ("metropolis", "testing")


class StepInfo(NamedTuple):
    accepted: torch.Tensor      # (C,) bool
    energy: torch.Tensor        # (C,) surface energy after the step
    n_ads: torch.Tensor         # (C,) occupied sites after the step
    oob: torch.Tensor           # (C,) trial state was out of bounds


def metropolis_accept(u_acc, e_old, e_new, temp):
    """u < exp(-dE/T), tested in log space with an overflow guard:
    log(u + 1e-38) < min(-dE / max(T, 1e-12), 0)."""
    logp = torch.clamp(-(e_new - e_old) / torch.clamp(temp, min=1e-12), max=0.0)
    return torch.log(u_acc + 1e-38) < logp


def _check_criterion(criterion: str) -> None:
    if criterion in ("distance", "metropolis_distance"):
        raise NotImplementedError(f"criterion {criterion!r} waits with make_distance_accept, "
                                  "which is not ported yet")
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion {criterion!r}")


def _accept(criterion: str, always_accept: bool, u_acc, e_old, e_new, temp):
    if criterion == "testing":
        return torch.full_like(u_acc, bool(always_accept), dtype=torch.bool)
    return metropolis_accept(u_acc, e_old, e_new, temp)


def _select(accept, trial_ss, trial, state: MCState) -> tuple[MCState, StepInfo]:
    new_state = MCState(
        site_state=torch.where(accept[:, None], trial_ss, state.site_state),
        energy=torch.where(accept, trial.surface_energy, state.energy),
        relaxed_positions=torch.where(accept[:, None, None], trial.positions,
                                      state.relaxed_positions),
    )
    return new_state, StepInfo(accepted=accept, energy=new_state.energy,
                               n_ads=num_occupied_sites(new_state.site_state), oob=trial.oob)


def propose_change(site_state: torch.Tensor, site: torch.Tensor,
                   u_code: torch.Tensor) -> torch.Tensor:
    """Trial occupancy of the Change move: per chain c, site ``site[c]``
    takes a new code drawn uniformly among the codes other than its current
    one (``u_code[c]`` uniform on [0, n_codes - 1) skips the current code)."""
    cur = torch.gather(site_state, 1, site[:, None])[:, 0]
    end = u_code + (u_code >= cur).to(u_code.dtype)
    return change_site(site_state, site, end)


def semigrand_draws(gen: torch.Generator, C: int, n_sites: int, n_codes: int):
    """One semigrand step's draws per chain: a site, a code and an
    acceptance uniform."""
    dev = gen.device
    return (torch.randint(0, n_sites, (C,), generator=gen, device=dev),
            torch.randint(0, n_codes - 1, (C,), generator=gen, device=dev),
            torch.rand((C,), generator=gen, device=dev))


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), u uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


def canonical_draws(gen: torch.Generator, C: int, n_sites: int, n_codes: int):
    """One canonical step's draws per chain: Gumbels over the codes and over
    the sites for each of the two exchanged sites, and an acceptance
    uniform."""
    return (gumbel(gen, (C, n_codes)), gumbel(gen, (C, n_sites)), gumbel(gen, (C, n_sites)),
            torch.rand((C,), generator=gen, device=gen.device))


def make_semigrand_step(d: DeviceSpec, state_energy_fn: Callable, criterion: str = "metropolis",
                        always_accept: bool = True) -> Callable:
    """Build ``step(state, temp, site, u_code, u_acc) -> (state, StepInfo)``.

    Per chain c: site ``site[c]`` changes to a new code drawn uniformly
    among the codes other than its current one — ``u_code[c]`` is uniform
    on [0, n_codes - 1) and skips the current code — and the move is
    accepted by the criterion: ``"metropolis"`` (``metropolis_accept(u_acc[c],
    ...)``) or ``"testing"`` (every move accepted iff ``always_accept``).
    ``temp`` is a scalar or (C,) tensor. The distance criteria raise.
    """
    _check_criterion(criterion)

    def step(state: MCState, temp, site, u_code, u_acc):
        trial_ss = propose_change(state.site_state, site, u_code)
        trial = state_energy_fn(trial_ss)
        temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=trial_ss.device)
        accept = _accept(criterion, always_accept, u_acc, state.energy, trial.surface_energy,
                         temp)
        return _select(accept, trial_ss, trial, state)

    return step


def _top2(x: torch.Tensor):
    """Indices of each row's two largest entries, lower index first among
    ties (the tie rule of ``lax.top_k``), by a stable descending sort."""
    idx = torch.sort(x, dim=1, descending=True, stable=True).indices
    return idx[:, 0], idx[:, 1]


def make_canonical_step(d: DeviceSpec, state_energy_fn: Callable, criterion: str = "metropolis",
                        always_accept: bool = True,
                        require_per_atom_energies: bool = False,
                        require_distance_decay: bool = False, potential=None,
                        distance_weight_matrix=None) -> Callable:
    """Build the exchange step ``step(state, temp, g_types, g_site1,
    g_site2, u_acc) -> (state, StepInfo)``: per chain, two *distinct*
    codes present on the surface (the empty code counts) by a Gumbel top-2
    over ``g_types`` (C, K+1), one site holding each by a Gumbel argmax over
    the site weights (``g_site1`` / ``g_site2``, (C, S)), their codes
    swapped, then the criterion. A chain with fewer than two codes present
    never accepts.

    Optional site weights, for sites of an adsorbate (empty sites weigh 1):
      * ``require_per_atom_energies``: softmax over alive slots of
        per-atom energy / T (``potential.per_atom_energy`` at the chain's
        relaxed positions), read at each site's first slot;
      * ``require_distance_decay``: the second site's weights times row
        ``site1`` of the precomputed (S, S) ``distance_weight_matrix``.
    """
    _check_criterion(criterion)
    if require_per_atom_energies and potential is None:
        raise ValueError("require_per_atom_energies needs the potential")
    if require_distance_decay and distance_weight_matrix is None:
        raise ValueError("require_distance_decay needs a distance_weight_matrix")
    dev = d.device
    dwm = (torch.as_tensor(distance_weight_matrix, dtype=torch.float32, device=dev)
           if distance_weight_matrix is not None else None)
    n_sites = d.site_coords.shape[0]
    n_codes = d.n_codes
    group = d.code_offsets.shape[1]
    slot0 = d.pristine_numbers.shape[0] + torch.arange(n_sites, device=dev) * group

    def site_weights(state: MCState, temp):
        """(C, S) selection weight of each site, for occupied-site draws."""
        C = state.site_state.shape[0]
        if not require_per_atom_energies:
            return torch.ones((C, n_sites), dtype=state.energy.dtype, device=dev)
        ti = realize_type_idx(d, state.site_state)
        alive = realize_alive(d, state.site_state)
        pa = potential.per_atom_energy(state.relaxed_positions, ti, alive, d.shifts)
        t = temp[:, None] if temp.dim() else temp
        logits = torch.where(alive, pa / t, torch.full_like(pa, -torch.inf))
        return torch.softmax(logits, dim=1)[:, slot0]

    def occupied_weights(ss, code, w_site):
        """(C, S) weights of the sites holding ``code`` (empty sites 1)."""
        return torch.where(ss == code[:, None], torch.where(code[:, None] == 0, 1.0, w_site),
                           0.0)

    def step(state: MCState, temp, g_types, g_site1, g_site2, u_acc):
        ss = state.site_state
        temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=ss.device)
        codes = torch.arange(n_codes, device=ss.device)
        present = (ss[:, :, None] == codes).any(dim=1)                     # (C, K+1)
        valid = present.sum(dim=1) >= 2
        type1, type2 = _top2(torch.where(present, g_types, torch.full_like(g_types, -torch.inf)))

        # Gumbel argmax over log-weights; torch.argmax, like jnp.argmax,
        # returns the lowest index among ties
        w_site = site_weights(state, temp)
        site1 = torch.argmax(torch.log(occupied_weights(ss, type1, w_site) + 1e-38) + g_site1,
                             dim=1)
        w2 = occupied_weights(ss, type2, w_site)
        if require_distance_decay:
            w2 = w2 * dwm[site1]
        site2 = torch.argmax(torch.log(w2 + 1e-38) + g_site2, dim=1)

        trial_ss = exchange_sites(ss, site1, site2)
        trial = state_energy_fn(trial_ss)
        accept = _accept(criterion, always_accept, u_acc, state.energy, trial.surface_energy,
                         temp) & valid
        return _select(accept, trial_ss, trial, state)

    return step
