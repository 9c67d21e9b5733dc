"""MC steps (semigrand Change and canonical Exchange, single-try and
multiple-try) and their acceptance criteria, batched over chains.

The counterpart of ``surface_sampling_tpu/core/events.py``. A step takes
its random draws as tensors, so a caller can feed it any source of
randomness — the engine's ``torch.Generator`` (``semigrand_draws`` /
``canonical_draws`` / ``mtm_draws``), or in a test the draws a JAX step
made. Dynamic choices ("one of the codes present", "a site holding that
code") are masked Gumbel draws, so every shape stays static.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
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
from surface_sampling_tpu_torch.utils.tracing import span

CRITERIA = ("metropolis", "testing", "distance", "metropolis_distance")
DISTANCE_CRITERIA = ("distance", "metropolis_distance")
# rows of the host's candidate-pair search per chunk: the (rows, S, Kimg, 3)
# displacement block stays small on large site lattices
_CANDIDATE_ROWS = 64


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


def _distance_candidates(site: np.ndarray, shifts: np.ndarray, bound: float):
    """Cross-site candidate triples (i, j, k) with |site_i - site_j + shift_k|
    < bound and i < j, or i == j with a nonzero shift (a site against its
    own periodic image), in the order of ``np.nonzero`` over the dense
    (S, S, Kimg) array, built a block of rows at a time."""
    S = site.shape[0]
    nonzero_shift = ~np.all(np.abs(shifts) <= 1e-8, axis=1)     # np.allclose(shift, 0)
    out = []
    for lo in range(0, S, _CANDIDATE_ROWS):
        blk = site[lo:lo + _CANDIDATE_ROWS]
        diff = blk[:, None, None, :] - site[None, :, None, :] + shifts[None, None, :, :]
        ii, jj, kk = np.nonzero(np.linalg.norm(diff, axis=-1) < bound)
        ii = ii + lo
        keep = (ii < jj) | ((ii == jj) & nonzero_shift[kk])
        out.append(np.stack([ii[keep], jj[keep], kk[keep]], axis=1))
    return np.concatenate(out) if out else np.zeros((0, 3), np.int64)


def make_distance_accept(d: DeviceSpec, filter_distance: float) -> Callable:
    """Geometric filter ``accept(site_state (C, S)) -> (C,) bool``: a chain
    passes iff no two of its adsorbate atoms (the alive site-slot atoms) are
    closer than ``filter_distance``.

    Site coordinates are static under MC moves, so the candidate pairs are
    found once on the host: the (site, site, image shift) triples whose
    site separation can fall below the cutoff after allowing for the
    largest group-member offset, plus each site against itself when a code
    has more than one atom. A trial then tests only those pairs' member
    atoms, O(C * P * G^2) for P candidate pairs."""
    site = d.site_coords.double().cpu().numpy()                    # (S, 3)
    offs = d.code_offsets.double().cpu().numpy()                   # (K+1, G, 3)
    shifts = d.shifts.double().cpu().numpy()                       # (Kimg, 3)
    S, G = site.shape[0], offs.shape[1]
    r_off = float(np.linalg.norm(offs, axis=-1).max()) if offs.size else 0.0
    tri = _distance_candidates(site, shifts, filter_distance + 2.0 * r_off)
    ci, cj = list(tri[:, 0]), list(tri[:, 1])
    csh = [-shifts[k] for k in tri[:, 2]]
    cself = [False] * len(ci)
    if G > 1:
        ci += list(range(S))
        cj += list(range(S))
        csh += [np.zeros(3)] * S
        cself += [True] * S

    dev = d.device
    if not ci:
        return lambda site_state: torch.ones(site_state.shape[0], dtype=torch.bool,
                                             device=site_state.device)
    ci_t = torch.as_tensor(np.asarray(ci), dtype=torch.int64, device=dev)
    cj_t = torch.as_tensor(np.asarray(cj), dtype=torch.int64, device=dev)
    csh_t = torch.as_tensor(np.asarray(csh), dtype=torch.float32, device=dev)   # (P, 3)
    g = np.arange(G)
    pair_mask = np.where(np.asarray(cself)[:, None, None], (g[:, None] < g[None, :])[None],
                         True)
    pm_t = torch.as_tensor(pair_mask, device=dev)                               # (P, G, G)
    members = torch.arange(G, device=dev)
    fd2 = filter_distance * filter_distance
    si, sj = d.site_coords[ci_t][None, :, None, :], d.site_coords[cj_t][None, :, None, :]

    def accept(site_state):
        with span("mc.filter"):
            code_i, code_j = site_state[:, ci_t], site_state[:, cj_t]           # (C, P)
            occ = (code_i > 0) & (code_j > 0)
            pi = si + d.code_offsets[code_i]                                    # (C, P, G, 3)
            pj = sj + d.code_offsets[code_j] + csh_t[None, :, None, :]
            d2 = ((pi[:, :, :, None, :] - pj[:, :, None, :, :]) ** 2).sum(dim=-1)  # (C, P, G, G)
            m_i = members < d.code_natoms[code_i][..., None]
            m_j = members < d.code_natoms[code_j][..., None]
            mask = occ[..., None, None] & m_i[..., :, None] & m_j[..., None, :] & pm_t
            dmin2 = torch.where(mask, d2, torch.full_like(d2, torch.inf)).amin(dim=(1, 2, 3))
            return dmin2 > fd2

    return accept


def hard_wall_accept(d: DeviceSpec | None, criterion: str, filter_distance: float):
    """The distance factor of a delta or local-relax step, which take the
    Metropolis criterion only, or Metropolis under the distance filter's
    hard wall: None for ``"metropolis"``, the filter of
    :func:`make_distance_accept` for ``"metropolis_distance"`` (which needs
    the DeviceSpec ``d``)."""
    if criterion == "metropolis":
        return None
    if criterion != "metropolis_distance":
        raise ValueError("delta and local-relax steps support criterion='metropolis' or "
                         f"'metropolis_distance' (got {criterion!r})")
    if d is None:
        raise ValueError("criterion='metropolis_distance' needs the DeviceSpec (d=) for the "
                         "candidate-pair table")
    return make_distance_accept(d, filter_distance)


def _criterion_fn(d: DeviceSpec, criterion: str, filter_distance: float,
                  always_accept: bool) -> Callable:
    """``accept(u_acc, e_old, e_new, temp, trial_ss) -> (C,) bool`` of a
    criterion: Metropolis, testing (every move accepted iff
    ``always_accept``), distance (the geometric filter alone) or
    metropolis_distance (Metropolis under the filter's hard wall)."""
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion {criterion!r}")
    dist = (make_distance_accept(d, filter_distance) if criterion in DISTANCE_CRITERIA
            else None)

    def accept(u_acc, e_old, e_new, temp, trial_ss):
        if criterion == "testing":
            return torch.full_like(u_acc, bool(always_accept), dtype=torch.bool)
        if criterion == "distance":
            return dist(trial_ss)
        ok = metropolis_accept(u_acc, e_old, e_new, temp)
        return ok & dist(trial_ss) if dist is not None else ok

    return accept


def select_trial(accept, trial_ss, trial, state: MCState) -> tuple[MCState, StepInfo]:
    """Per chain: the trial state (occupancy ``trial_ss``, its StateEnergy
    ``trial``) where ``accept``, else ``state``; and the step's StepInfo."""
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


class ChainBlock(NamedTuple):
    """Rows ``lo:hi`` of a global batch of ``n_global`` chains: the chains
    one rank of a sharded run holds (``parallel/chains.py``)."""

    lo: int
    hi: int
    n_global: int


def block_draws(draws: Callable, block: ChainBlock | None) -> Callable:
    """``draws`` for the chains of ``block``: the draws of the whole global
    batch, of which the block's rows are kept (nested tuples, as the
    multiple-try draws, row by row). A sharded run then takes, chain for
    chain, the draws of the unsharded run on the same generator, whatever
    the number of blocks; the draws are a few numbers per chain a step, so
    drawing the global batch on every rank costs little."""
    if block is None:
        return draws

    def take(x):
        return tuple(take(y) for y in x) if isinstance(x, tuple) else x[block.lo:block.hi]

    def blocked(gen: torch.Generator, C: int, n_sites: int, n_codes: int):
        if C != block.hi - block.lo:
            raise ValueError(f"the state holds {C} chains, the block {block.lo}:{block.hi}")
        return take(draws(gen, block.n_global, n_sites, n_codes))

    return blocked


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
                        filter_distance: float = 1.5, always_accept: bool = True) -> Callable:
    """Build ``step(state, temp, site, u_code, u_acc) -> (state, StepInfo)``.

    Per chain c: site ``site[c]`` changes to a new code drawn uniformly
    among the codes other than its current one — ``u_code[c]`` is uniform
    on [0, n_codes - 1) and skips the current code — and the move is
    accepted by the criterion: ``"metropolis"`` (``metropolis_accept(u_acc[c],
    ...)``), ``"testing"`` (every move accepted iff ``always_accept``),
    ``"distance"`` (no two adsorbate atoms closer than ``filter_distance``)
    or ``"metropolis_distance"`` (both). ``temp`` is a scalar or (C,)
    tensor.
    """
    accept_fn = _criterion_fn(d, criterion, filter_distance, always_accept)

    def step(state: MCState, temp, site, u_code, u_acc):
        trial_ss = propose_change(state.site_state, site, u_code)
        with span("mc.energy"):
            trial = state_energy_fn(trial_ss)
        temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=trial_ss.device)
        accept = accept_fn(u_acc, state.energy, trial.surface_energy, temp, trial_ss)
        return select_trial(accept, trial_ss, trial, state)

    return step


def _top2(x: torch.Tensor):
    """Indices of each row's two largest entries, lower index first among
    ties (the tie rule of ``lax.top_k``), by a stable descending sort."""
    idx = torch.sort(x, dim=1, descending=True, stable=True).indices
    return idx[:, 0], idx[:, 1]


def codes_present(ss: torch.Tensor, n_codes: int) -> torch.Tensor:
    """(C, K+1) bool: which codes occur in each chain (the empty code
    counts)."""
    return (ss[:, :, None] == torch.arange(n_codes, device=ss.device)).any(dim=1)


def pick_exchange(ss: torch.Tensor, n_codes: int, g_types, g_site1, g_site2,
                  w_site: torch.Tensor | None = None, dwm: torch.Tensor | None = None):
    """The Exchange proposal's choice per chain: two *distinct* codes present
    (a Gumbel top-2 over ``g_types`` (C, K+1)), one site holding each (a
    Gumbel argmax over the log site weights, ``g_site1`` / ``g_site2``
    (C, S)). Sites of an adsorbate weigh ``w_site`` (C, S) (1 when None),
    empty sites 1; ``dwm`` multiplies the second site's weights by row
    ``site1`` of a distance-decay matrix. Returns (site1, site2, valid),
    valid where at least two codes are present."""
    present = codes_present(ss, n_codes)
    valid = present.sum(dim=1) >= 2
    type1, type2 = _top2(torch.where(present, g_types, torch.full_like(g_types, -torch.inf)))

    def weights(code):
        if w_site is None:
            return (ss == code[:, None]).to(torch.float32)
        return torch.where(ss == code[:, None], torch.where(code[:, None] == 0, 1.0, w_site),
                           0.0)

    # Gumbel argmax over log-weights; torch.argmax, like jnp.argmax, returns
    # the lowest index among ties
    site1 = torch.argmax(torch.log(weights(type1) + 1e-38) + g_site1, dim=1)
    w2 = weights(type2)
    if dwm is not None:
        w2 = w2 * dwm[site1]
    site2 = torch.argmax(torch.log(w2 + 1e-38) + g_site2, dim=1)
    return site1, site2, valid


def make_canonical_step(d: DeviceSpec, state_energy_fn: Callable, criterion: str = "metropolis",
                        filter_distance: float = 1.5, always_accept: bool = True,
                        require_per_atom_energies: bool = False,
                        require_distance_decay: bool = False, potential=None,
                        distance_weight_matrix=None) -> Callable:
    """Build the exchange step ``step(state, temp, g_types, g_site1,
    g_site2, u_acc) -> (state, StepInfo)``: per chain, two *distinct*
    codes present on the surface (the empty code counts) by a Gumbel top-2
    over ``g_types`` (C, K+1), one site holding each by a Gumbel argmax over
    the site weights (``g_site1`` / ``g_site2``, (C, S)), their codes
    swapped, then the criterion (those of :func:`make_semigrand_step`). A
    chain with fewer than two codes present never accepts.

    Optional site weights, for sites of an adsorbate (empty sites weigh 1):
      * ``require_per_atom_energies``: softmax over alive slots of
        per-atom energy / T (``potential.per_atom_energy`` at the chain's
        relaxed positions), read at each site's first slot;
      * ``require_distance_decay``: the second site's weights times row
        ``site1`` of the precomputed (S, S) ``distance_weight_matrix``.
    """
    accept_fn = _criterion_fn(d, criterion, filter_distance, always_accept)
    if require_per_atom_energies and potential is None:
        raise ValueError("require_per_atom_energies needs the potential")
    if require_distance_decay and distance_weight_matrix is None:
        raise ValueError("require_distance_decay needs a distance_weight_matrix")
    dev = d.device
    dwm = (torch.as_tensor(distance_weight_matrix, dtype=torch.float32, device=dev)
           if require_distance_decay else None)
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

    def step(state: MCState, temp, g_types, g_site1, g_site2, u_acc):
        ss = state.site_state
        temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=ss.device)
        site1, site2, valid = pick_exchange(ss, n_codes, g_types, g_site1, g_site2,
                                            site_weights(state, temp), dwm)
        trial_ss = exchange_sites(ss, site1, site2)
        with span("mc.energy"):
            trial = state_energy_fn(trial_ss)
        accept = accept_fn(u_acc, state.energy, trial.surface_energy, temp, trial_ss) & valid
        return select_trial(accept, trial_ss, trial, state)

    return step


# ----------------------------------------------------------------------
# Multiple-try Metropolis
# ----------------------------------------------------------------------
def propose_change_batch(ss: torch.Tensor, sites: torch.Tensor,
                         codes: torch.Tensor) -> torch.Tensor:
    """(C, T, S) Change proposals from each chain's occupancy ``ss`` (C, S):
    draw t of chain c moves site ``sites[c, t]`` by code draw ``codes[c, t]``
    (as :func:`propose_change`)."""
    C, T = sites.shape
    S = ss.shape[1]
    rep = ss[:, None, :].expand(C, T, S).reshape(C * T, S)
    return propose_change(rep, sites.reshape(-1), codes.reshape(-1)).view(C, T, S)


def propose_exchange_batch(ss: torch.Tensor, n_codes: int, g_types, g_site1,
                           g_site2) -> torch.Tensor:
    """(C, T, S) unweighted Exchange proposals from each chain's occupancy:
    draw t uses the Gumbels ``g_types[c, t]`` (K+1,), ``g_site1[c, t]`` and
    ``g_site2[c, t]`` (S,) (as the canonical step's unweighted choice)."""
    C, T, S = g_site1.shape
    rep = ss[:, None, :].expand(C, T, S).reshape(C * T, S)
    s1, s2, _ = pick_exchange(rep, n_codes, g_types.reshape(C * T, -1),
                              g_site1.reshape(C * T, S), g_site2.reshape(C * T, S))
    return exchange_sites(rep, s1, s2).view(C, T, S)


def mtm_draws(k_trials: int, canonical: bool = False) -> Callable:
    """``draws(gen, C, n_sites, n_codes)`` of one multiple-try step: the K
    trials' proposal draws, K selection Gumbels, the K - 1 reference
    proposals' draws and an acceptance uniform per chain. A proposal's
    draws are a site and a code (C, T) each for a Change, or Gumbels over
    the codes (C, T, K+1) and over the sites for each of the two exchanged
    sites (C, T, S) for an Exchange."""

    def proposal(gen, C, T, n_sites, n_codes):
        dev = gen.device
        if canonical:
            return (gumbel(gen, (C, T, n_codes)), gumbel(gen, (C, T, n_sites)),
                    gumbel(gen, (C, T, n_sites)))
        return (torch.randint(0, n_sites, (C, T), generator=gen, device=dev),
                torch.randint(0, n_codes - 1, (C, T), generator=gen, device=dev))

    def draws(gen: torch.Generator, C: int, n_sites: int, n_codes: int):
        trial = proposal(gen, C, k_trials, n_sites, n_codes)
        g_sel = gumbel(gen, (C, k_trials))
        ref = proposal(gen, C, k_trials - 1, n_sites, n_codes)
        return trial, g_sel, ref, torch.rand((C,), generator=gen, device=gen.device)

    return draws


def _make_mtm_step(propose: Callable, state_energy_fn: Callable, k_trials: int,
                   valid_fn: Callable | None = None) -> Callable:
    """Multiple-try Metropolis over a symmetric proposal ``propose(ss (C, S),
    *draws) -> (C, T, S)``: ``step(state, temp, trial_draws, g_sel,
    ref_draws, u_acc) -> (state, StepInfo)``.

    Per chain: K trials y_1..y_K from x, evaluated as one (C K, S) batch;
    y = y_J selected with probability proportional to w(y_j) = exp(-E/T)
    (a Gumbel argmax of log w + ``g_sel``); K - 1 references from y,
    evaluated as one (C (K-1), S) batch, and x itself; y accepted iff
    log(u + 1e-38) < logsumexp(log w(y)) - logsumexp(log w(x*)).
    ``valid_fn(ss) -> (C,) bool`` gates acceptance where the proposal
    family is degenerate. ``oob`` is taken over all 2K - 1 evaluations."""

    def step(state: MCState, temp, trial_draws, g_sel, ref_draws, u_acc):
        ss = state.site_state
        C, S = ss.shape
        temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=ss.device)
        beta = 1.0 / torch.clamp(temp, min=1e-12)
        beta = beta[:, None] if beta.dim() else beta
        trial_ss = propose(ss, *trial_draws)                                  # (C, K, S)
        with span("mc.energy"):
            trials = state_energy_fn(trial_ss.reshape(C * k_trials, S))
        e_y = trials.surface_energy.view(C, k_trials)
        logw_y = -beta * e_y
        sel = torch.argmax(logw_y + g_sel, dim=1)
        rows = torch.arange(C, device=ss.device)
        y_ss = trial_ss[rows, sel]
        ref_ss = propose(y_ss, *ref_draws)                                    # (C, K-1, S)
        with span("mc.energy"):
            refs = state_energy_fn(ref_ss.reshape(C * (k_trials - 1), S))
        logw_x = -beta * torch.cat([refs.surface_energy.view(C, k_trials - 1),
                                    state.energy[:, None]], dim=1)
        log_ratio = torch.logsumexp(logw_y, dim=1) - torch.logsumexp(logw_x, dim=1)
        accept = torch.log(u_acc + 1e-38) < log_ratio
        if valid_fn is not None:
            accept = accept & valid_fn(ss)
        pos_y = trials.positions.view(C, k_trials, *trials.positions.shape[1:])[rows, sel]
        new_state = MCState(
            site_state=torch.where(accept[:, None], y_ss, ss),
            energy=torch.where(accept, e_y[rows, sel], state.energy),
            relaxed_positions=torch.where(accept[:, None, None], pos_y,
                                          state.relaxed_positions),
        )
        oob = (trials.oob.view(C, k_trials).any(dim=1)
               | refs.oob.view(C, k_trials - 1).any(dim=1))
        return new_state, StepInfo(accepted=accept, energy=new_state.energy,
                                   n_ads=num_occupied_sites(new_state.site_state), oob=oob)

    return step


def make_semigrand_step_mtm(d: DeviceSpec, state_energy_fn: Callable,
                            k_trials: int = 8) -> Callable:
    """Multiple-try Metropolis (Liu, Liang & Wong, JASA 2000) over the
    semigrand Change family: ``step(state, temp, (sites, codes), g_sel,
    (ref_sites, ref_codes), u_acc)``, draws from ``mtm_draws(k_trials)``.
    The Change proposal is symmetric, so the MTM weights are the Boltzmann
    factors; every step pays 2K - 1 evaluations in two batched calls."""
    if k_trials < 2:
        raise ValueError("multiple-try Metropolis needs k_trials >= 2")
    return _make_mtm_step(propose_change_batch, state_energy_fn, k_trials)


def make_canonical_step_mtm(d: DeviceSpec, state_energy_fn: Callable,
                            k_trials: int = 8) -> Callable:
    """Multiple-try Metropolis over the unweighted canonical Exchange family
    (symmetric: an exchange preserves the multiset of codes present), draws
    from ``mtm_draws(k_trials, canonical=True)``. A chain with fewer than
    two codes present never accepts."""
    if k_trials < 2:
        raise ValueError("multiple-try Metropolis needs k_trials >= 2")
    n_codes = d.n_codes

    def propose(ss, g_types, g_site1, g_site2):
        return propose_exchange_batch(ss, n_codes, g_types, g_site1, g_site2)

    def valid_fn(ss):
        return codes_present(ss, n_codes).sum(dim=1) >= 2

    return _make_mtm_step(propose, state_energy_fn, k_trials, valid_fn=valid_fn)
