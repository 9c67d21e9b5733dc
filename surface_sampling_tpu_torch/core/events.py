"""Semigrand MC step with the Metropolis criterion, batched over chains.

The counterpart of ``metropolis_accept`` and ``make_semigrand_step`` in
``surface_sampling_tpu/core/events.py``. The step takes its random draws
as tensors, so a caller can feed it any source of randomness — the
engine's ``torch.Generator``, or in a test the draws a JAX step made.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from surface_sampling_tpu_torch.core.state import (
    DeviceSpec,
    MCState,
    change_site,
    num_occupied_sites,
)


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


def propose_change(site_state: torch.Tensor, site: torch.Tensor,
                   u_code: torch.Tensor) -> torch.Tensor:
    """Trial occupancy of the Change move: per chain c, site ``site[c]``
    takes a new code drawn uniformly among the codes other than its current
    one (``u_code[c]`` uniform on [0, n_codes - 1) skips the current code)."""
    cur = torch.gather(site_state, 1, site[:, None])[:, 0]
    end = u_code + (u_code >= cur).to(u_code.dtype)
    return change_site(site_state, site, end)


def make_semigrand_step(d: DeviceSpec, state_energy_fn: Callable) -> Callable:
    """Build ``step(state, temp, site, u_code, u_acc) -> (state, StepInfo)``.

    Per chain c: site ``site[c]`` changes to a new code drawn uniformly
    among the codes other than its current one — ``u_code[c]`` is uniform
    on [0, n_codes - 1) and skips the current code — and the move is
    accepted when ``metropolis_accept(u_acc[c], ...)``. ``temp`` is a
    scalar or (C,) tensor.
    """

    def step(state: MCState, temp, site, u_code, u_acc):
        ss = state.site_state
        trial_ss = propose_change(ss, site, u_code)
        trial = state_energy_fn(trial_ss)
        temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=ss.device)
        accept = metropolis_accept(u_acc, state.energy, trial.surface_energy, temp)
        new_state = MCState(
            site_state=torch.where(accept[:, None], trial_ss, ss),
            energy=torch.where(accept, trial.surface_energy, state.energy),
            relaxed_positions=torch.where(accept[:, None, None], trial.positions,
                                          state.relaxed_positions),
        )
        info = StepInfo(
            accepted=accept,
            energy=new_state.energy,
            n_ads=num_occupied_sites(new_state.site_state),
            oob=trial.oob,
        )
        return new_state, info

    return step
