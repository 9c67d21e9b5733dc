"""Plain semigrand Metropolis: a sweep of Change moves replayed from the
draws of a ``torch.Generator``, scored by a reference energy.

Each step draws, for every chain of the batch and in this order, a site
(uniform over the S sites), a code index u (uniform over the K other codes)
and an acceptance uniform; the site's code becomes u, or u + 1 where u is
at or above its current code. The trial is accepted where
log(uniform + 1e-38) < min(-(E_trial - E) / T, 0), and, under the distance
criterion, where no two adsorbate atoms lie closer than the filter distance
(periodic images included). An out-of-bounds trial carries the bound as its
energy and is judged as any other.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from benchmark.reference.common import Lattice, edge_list, image_shifts, realise


def draws(gen: torch.Generator, n_chains: int, n_sites: int, n_codes: int):
    """One step's (site, code index, uniform) of every chain."""
    dev = gen.device
    return (torch.randint(0, n_sites, (n_chains,), generator=gen, device=dev),
            torch.randint(0, n_codes - 1, (n_chains,), generator=gen, device=dev),
            torch.rand((n_chains,), generator=gen, device=dev))


def too_close(lat: Lattice, site_state: torch.Tensor, distance: float) -> torch.Tensor:
    """(C,) True where two adsorbate atoms (or one and an image of
    another, or of itself) are closer than ``distance``."""
    numbers, positions = realise(lat, site_state)
    P = lat.pristine_numbers.shape[0]
    ads = numbers[:, P:] > 0
    e = edge_list(positions[:, P:], ads, image_shifts(lat.cell, lat.pbc, distance), distance)
    return e.count.sum(dim=1) > 0


class Replay(NamedTuple):
    """A replayed sweep of a set of chains."""

    site_state: torch.Tensor     # (n, S) after the sweep
    energy: torch.Tensor         # (n,) float64 reference surface energy after it
    near_tie: torch.Tensor       # (n,) bool: a decision closer to its edge than the margin
    accepted: torch.Tensor       # (n,) moves accepted


def replay_sweep(lat: Lattice, energy_fn: Callable, site_state: torch.Tensor,
                 energy: torch.Tensor, rows: torch.Tensor, gen: torch.Generator, n_chains: int,
                 steps: int, temp: float, margin_ev: float,
                 filter_distance: float | None = None) -> Replay:
    """Replay ``steps`` Change moves of chains ``rows`` of an
    ``n_chains`` batch from their occupancies ``site_state`` (n, S) and
    reference energies ``energy`` (n,), on the draws of ``gen`` (advanced
    in place). ``energy_fn(site_state) -> (n,)`` float64 surface energies.
    A Metropolis decision whose log ratio lies within ``margin_ev / temp``
    of the uniform's log marks the chain as a near tie: an energy within
    ``margin_ev`` of the reference could decide it either way."""
    S, n_codes = lat.n_sites, lat.n_codes
    ss, e = site_state.clone(), energy.clone()
    tie = torch.zeros(ss.shape[0], dtype=torch.bool, device=ss.device)
    acc_n = torch.zeros(ss.shape[0], dtype=torch.int64, device=ss.device)
    for _ in range(steps):
        site, u_code, u_acc = (x[rows].to(ss.device) for x in draws(gen, n_chains, S, n_codes))
        cur = ss.gather(1, site[:, None])[:, 0]
        trial = ss.clone()
        trial.scatter_(1, site[:, None], (u_code + (u_code >= cur).long())[:, None])
        e_trial = energy_fn(trial)
        log_u = torch.log(u_acc.double() + 1e-38)
        log_p = torch.clamp(-(e_trial - e) / temp, max=0.0)
        accept = log_u < log_p
        tie |= (log_u - log_p).abs() < margin_ev / temp
        if filter_distance is not None:
            accept &= ~too_close(lat, trial, filter_distance)
        ss = torch.where(accept[:, None], trial, ss)
        e = torch.where(accept, e_trial, e)
        acc_n += accept.long()
    return Replay(ss, e, tie, acc_n)
