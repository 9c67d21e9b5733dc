"""Delta-energy semigrand MC for rigid PaiNN supercells, batched over chains.

The counterpart of the static-geometry mode of
``surface_sampling_tpu/core/incremental.py``. A move changes one site's
occupancy; an L-layer message-passing energy is local, so layer l's
outputs change only within l + 1 hops of the site. Each chain carries the
inputs of every message block (s, the filter features phi and the vector
features vcat, L tensors each) and its per-atom energies, all in the
routing band's sorted row order, and a move recomputes, layer by layer,
only the blocks of n_blk sorted rows that its hop balls touch: the
subset-grid message kernel over those blocks, the dense layers and the
update kernel on their rows. Hop balls come from the static candidate
table, a superset of every interaction, so locality is exact.

On the card the blocks are gathered and written by index, not through the
TPU's one-hot products. Chains are the leading batch axis and members the
next; every chain moves its own site, so every chain has its own block
list. A block list repeats blocks (padding, and the overlap of a two-site
move's tables): each write carries the values of the first entry of its
block, so the result never depends on the order in which a duplicate
index is written. The acceptance energy is re-summed from the per-atom
cache every move, in a fixed order (no running sum, no drift), and a move
is accepted per chain by a select over the caches.

Ported: the static-geometry delta and the dynamic-geometry delta (code-
dependent slot geometry, or ``static_geometry="off"``: the edges rebuilt
over the candidate table at every step) for one site (Change) and two sites
(Exchange), the semigrand and canonical steps (Metropolis, or
``metropolis_distance``: Metropolis under the distance filter of
``core/events.py``) and the run.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as tnf

from surface_sampling_tpu_torch.core.energy import identity_surface_energy
from surface_sampling_tpu_torch.core.engine import run_sweeps
from surface_sampling_tpu_torch.core.events import (
    StepInfo,
    canonical_draws,
    hard_wall_accept,
    metropolis_accept,
    pick_exchange,
    propose_change,
    semigrand_draws,
)
from surface_sampling_tpu_torch.core.relax import energy_threshold
from surface_sampling_tpu_torch.core.state import (
    element_counts,
    exchange_sites,
    num_occupied_sites,
    realize_alive,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.models.painn import (
    atom_energies,
    excluded_volume,
    filter_features,
    message_weights,
    painn_features_rigid,
    prepare_message_geometry,
    rigid_member_weights,
    update_weights,
    with_halo,
)
from surface_sampling_tpu_torch.ops.painn_kernels import painn_message_subset, painn_update_fused
from surface_sampling_tpu_torch.ops.static_edges import build_static_edge_pack, static_edge_geometry
from surface_sampling_tpu_torch.utils.tracing import count, span


class IncTables(NamedTuple):
    """Host-built recompute tables (numpy). ``blocks[l]``: (S, nb[l])
    int32 sorted-block ids (of the routing band) covering the (l+1)-hop
    ball of each site's slots, ascending, padded by repeating the first."""

    blocks: tuple
    nb: tuple


def build_inc_tables(spec, static_nbr, band, n_layers: int) -> IncTables:
    """Hop balls of every site over the candidate adjacency, as sorted-block
    ids of ``band`` (an ``ops.banding.RoutingBand``)."""
    P, S, G = spec.n_pristine, spec.n_sites, spec.group_size
    N = P + S * G
    slot_j, valid = np.asarray(static_nbr.slot_j), np.asarray(static_nbr.valid)
    adj = [set() for _ in range(N)]          # undirected, whatever the table's symmetry
    for i in range(N):
        for j in slot_j[i][valid[i]]:
            adj[i].add(int(j))
            adj[int(j)].add(i)
    rank = np.asarray(band.rank)
    n_blk = int(band.n_blk)
    balls = [{P + s * G + g for g in range(G)} for s in range(S)]
    blocks, nbs = [], []
    for _ in range(n_layers):
        grown = []
        for ball in balls:
            big = set(ball)
            for i in ball:
                big |= adj[i]
            grown.append(big)
        balls = grown
        per_site = [np.unique(rank[sorted(ball)] // n_blk) for ball in balls]
        nb = max(len(b) for b in per_site)
        arr = np.zeros((S, nb), np.int32)
        for s, b in enumerate(per_site):
            arr[s, :len(b)] = b
            arr[s, len(b):] = b[0]
        blocks.append(arr)
        nbs.append(nb)
    return IncTables(blocks=tuple(blocks), nb=tuple(nbs))


def first_occurrence(blocks: torch.Tensor) -> torch.Tensor:
    """(C, NB) index of the first entry of each row of ``blocks`` that
    holds the same block id."""
    NB = blocks.shape[1]
    pos = torch.arange(NB, device=blocks.device)
    return torch.where(blocks[:, :, None] == blocks[:, None, :], pos, NB).amin(dim=2)


def take_blocks(x: torch.Tensor, blocks: torch.Tensor, dim: int, n_blocks: int) -> torch.Tensor:
    """The rows of blocks ``blocks`` (C, NB) of each chain, in block-list
    order: axis ``dim`` of x (leading axis: chains) holds n_blocks equal
    blocks of rows; returns x with that axis cut to NB blocks."""
    lead = x.shape[:dim]
    flat = x.reshape(*lead, n_blocks, -1)
    C, NB = blocks.shape
    idx = blocks.view(C, *([1] * (dim - 1)), NB, 1).expand(*lead, NB, flat.shape[-1])
    per = x.shape[dim] // n_blocks
    with span("delta.gather"):
        return flat.gather(dim, idx).reshape(*lead, NB * per, *x.shape[dim + 1:])


def _put_blocks(table: torch.Tensor, blocks: torch.Tensor, first: torch.Tensor,
                rows: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """A copy of ``table`` (C, K, n_pad, W) with the blocks ``blocks``
    (C, NB) set to ``rows`` (C, K, NB*n_blk, W). Every entry of a repeated
    block writes the rows of its first occurrence, so duplicate indices
    carry identical values and the write order cannot matter."""
    C, K = table.shape[:2]
    NB = blocks.shape[1]
    vals = rows.reshape(C, K, NB, -1)
    with span("delta.cache_write"):
        vals = vals.gather(2, first.view(C, 1, NB, 1).expand_as(vals))
        out = table.clone()
        out.view(C, K, n_blocks, -1).scatter_(2, blocks.view(C, 1, NB, 1).expand_as(vals), vals)
    return out


class IncCaches(NamedTuple):
    """Per-chain, per-member caches, rows in the band's sorted order padded
    to n_pad. Pad rows hold finite values that nothing reads: no edge
    routes from a pad slot and pad-row energies are zero."""

    s: tuple                 # L x (C, K, n_pad, F) scalar inputs of each message block
    phi: tuple               # L x (C, K, n_pad, 3F) their filter features
    vcat: tuple              # L x (C, K, n_pad, 3F) vector inputs, x-major
    e_atom: torch.Tensor     # (C, K, n_pad) raw per-atom energies incl. excluded volume


def select_caches(accept: torch.Tensor, new: IncCaches, old: IncCaches) -> IncCaches:
    """Per chain: ``new`` where ``accept``, else ``old``."""

    def pick(n, o):
        return n if n is o else torch.where(accept.view(-1, *([1] * (n.ndim - 1))), n, o)

    with span("delta.cache_write"):
        return IncCaches(*(tuple(pick(n, o) for n, o in zip(nf, of)) if isinstance(nf, tuple)
                           else pick(nf, of) for nf, of in zip(new, old)))


class IncState(NamedTuple):
    """MC state of a batch of chains on the incremental engine."""

    site_state: torch.Tensor     # (C, S) int64
    energy: torch.Tensor         # (C,) surface (acceptance) energy
    caches: IncCaches


class IncEngine(NamedTuple):
    init_state: Callable         # site_state (C, S) -> IncState
    energy_full: Callable        # site_state -> (surface energy, caches, oob)
    delta: Callable              # (caches, trial site_state, sites (C, k)) -> same; k = 1
                                 # for a Change, 2 for an Exchange
    n_sites: int
    n_codes: int


def make_incremental_painn(
    spec,
    d,
    potential,
    static_nbr,
    band,
    surface_energy_fn: Callable | None = None,
    static_geometry: str = "auto",
) -> IncEngine:
    """The delta-evaluation engine of a PaiNN ensemble system on a lattice.

    Args:
        spec, d: the SurfaceSpec and its DeviceSpec (the engine runs on
            ``d.device``).
        potential: a ``models.nn_calculator.PaiNNPotential`` built with
            ``routing_band=band``: the engine runs its weights (K members; K
            = 1 for one network), its units and its composition offset, and
            its banded static edges (with ``spec=``) or its edges over the
            candidate table.
        static_nbr: the spec's StaticNeighborTable; band: its host
            RoutingBand (required: a cell too small to band is too small
            for delta locality).
        surface_energy_fn: as for ``make_state_energy_fn``.
        static_geometry: "auto" (the JAX package's rule: the static-geometry
            delta where the slot geometry is code-independent, else the
            dynamic one) or "off" (the dynamic-geometry delta).

    The static-geometry delta reads the edge payload of the static pack
    (``ops/static_edges.py``) and caches s, phi and vcat of every layer. The
    dynamic one rebuilds the edges over the candidate table at every step
    (``ops/neighbors.neighbor_list_from_table``) and their banded message
    geometry, caches s and vcat (phi is recomputed on every row, as JAX
    does; ``caches.phi`` is empty), and recomputes the same hop-ball blocks
    through the same kernels. Both keep their caches in the band's sorted
    row order (the JAX package's dynamic path keeps slot order: the same
    rows, permuted).
    """
    if static_geometry not in ("auto", "off"):
        raise ValueError("static_geometry must be 'auto' or 'off'")
    if band is None:
        raise ValueError("incremental evaluation needs a routing band (ops/banding.py); cells "
                         "too small to band are too small for delta locality too")
    dev = d.device
    params, cfg = potential.params, potential.cfg
    pack, rw = getattr(potential, "static_edge_pack", None), getattr(potential, "rw", None)
    if static_geometry == "auto" and pack is None:
        pack = build_static_edge_pack(spec, static_nbr, cfg, dev, band=band)
        if pack is not None:
            rw = rigid_member_weights(params, cfg, tuple(sorted({int(z) for z in
                                                                 potential.znums.tolist()})),
                                      pack.r_pad)
    dynamic = static_geometry == "off" or pack is None
    if dynamic:
        dband = potential.band
        if dband is None:
            raise ValueError("the dynamic-geometry delta needs a potential built with "
                             "routing_band=band (its banded edges)")
        r_pad = ((cfg.n_rbf + 7) // 8) * 8
        dw, db = zip(*(message_weights(mp, cfg, r_pad) for mp in params["message"]))
        rw = {"dw": dw, "db": db}
        N, n_pad = spec.n_slots, dband.n_pad
    else:
        if pack.band is None:
            raise ValueError("the static-geometry delta needs a static edge pack built with "
                             "the routing band")
        dband = pack.band
        N, n_pad = pack.N, pack.n_pad
    L, n_blk = cfg.n_layers, dband.n_blk
    n_blocks = n_pad // n_blk
    blocks_tbl = [torch.as_tensor(b, dtype=torch.int64, device=dev)
                  for b in build_inc_tables(spec, static_nbr, band, L).blocks]
    sfn = surface_energy_fn or identity_surface_energy
    e_bound = energy_threshold(N)
    perm = dband.perm

    def _finish(e_raw, overflow, type_idx, alive, counts):
        e_raw = torch.where(overflow[:, None], torch.full_like(e_raw, 1e6), e_raw)
        e_pot = e_raw.mean(dim=1) * potential.factor + potential.comp_offset(type_idx, alive)
        oob = (e_pot.abs() > e_bound) | torch.isnan(e_pot)
        bound = torch.full_like(e_pot, e_bound)
        e_pot = torch.where(oob, bound, e_pot)
        return torch.where(oob, bound, sfn(e_pot, counts)), oob

    def _occupancy(site_state):
        """Types, alive mask, atomic numbers and element counts of (C, S)
        occupancies, their edge geometry (static, or rebuilt over the
        candidate table) and overflow flags, and the alive mask and the
        excluded-volume energies of live atoms in sorted rows."""
        type_idx, alive = realize_type_idx(d, site_state), realize_alive(d, site_state)
        numbers = potential.znums[type_idx] * alive.to(torch.int64)
        if dynamic:
            edges = potential.edge_fn(realize_positions(d, site_state), alive)
            msg_geom = prepare_message_geometry(cfg, edges, dband)[:5]
            r, mask, overflow = edges.r, edges.mask, edges.overflow
        else:
            msg_geom, (r, mask, overflow) = static_edge_geometry(pack, alive)
        pad = n_pad - N
        alive_s = tnf.pad(alive.to(torch.float32), (0, pad))[:, perm]
        excl_s = tnf.pad(excluded_volume(cfg, r, mask) * alive, (0, pad))[:, perm]
        return (type_idx, alive, numbers, element_counts(d, site_state), msg_geom, overflow,
                alive_s, excl_s)

    def _energies(s, alive_s, excl_s):
        """Per-atom raw energies (C, K, rows) of sorted rows."""
        live = alive_s[:, None, :] > 0
        return (torch.where(live, atom_energies(params, s), torch.zeros((), device=dev))
                + excl_s[:, None, :])

    def energy_full(site_state):
        type_idx, alive, numbers, counts, msg_geom, overflow, alive_s, excl_s = \
            _occupancy(site_state)
        s, (s_l, phi_l, vcat_l) = painn_features_rigid(params, rw, cfg, numbers, alive, msg_geom,
                                                       band=dband, collect_layers=True)
        caches = IncCaches(s=tuple(s_l), phi=() if dynamic else tuple(phi_l),
                           vcat=tuple(vcat_l), e_atom=_energies(s, alive_s, excl_s))
        se, oob = _finish(caches.e_atom.sum(dim=-1), overflow, type_idx, alive, counts)
        return se, caches, oob

    def delta(caches: IncCaches, ss_trial, sites):
        """Trial evaluation of occupancy ``ss_trial`` (C, S) that differs
        from the cached one at ``sites`` (C, k): the hop balls of the k
        sites are recomputed, layer by layer, from the caches."""
        C = ss_trial.shape[0]
        type_idx, alive, numbers, counts, msg_geom, overflow, alive_s, excl_s = \
            _occupancy(ss_trial)
        rbf, envm, nbr, unit, _ = msg_geom
        numbers_s = tnf.pad(numbers, (0, n_pad - N))[:, perm]
        s_t, phi_t, vcat_t = list(caches.s), list(caches.phi), list(caches.vcat)
        e_atom = caches.e_atom
        if dynamic:
            # every row's embedding: the geometry, and with it every row's
            # messages, may have changed
            z = torch.clamp(numbers_s, 0, cfg.max_z - 1)
            s_t[0] = params["atom_embed"][:, z].transpose(0, 1) * alive_s[:, None, :, None]
        for li, (mp, up) in enumerate(zip(params["message"], params["update"])):
            blocks = blocks_tbl[li][sites].reshape(C, -1)            # (C, NB)
            first = first_occurrence(blocks)
            count("delta.blocks", blocks)

            def take(x, dim):
                return take_blocks(x, blocks, dim, n_blocks)

            def halo(x):
                with span("delta.gather"):
                    return with_halo(x, dband.halo, 2)

            alive_rows = take(alive_s, 1)                            # (C, rows)
            if dynamic:
                phi = filter_features(mp, s_t[li])
                s_rows = take(s_t[li], 2)
            else:
                if li == 0:
                    z = torch.clamp(take(numbers_s, 1), 0, cfg.max_z - 1)
                    s_rows = (params["atom_embed"][:, z].transpose(0, 1)
                              * alive_rows[:, None, :, None])
                    s_t[0] = _put_blocks(s_t[0], blocks, first, s_rows, n_blocks)
                else:
                    s_rows = take(s_t[li], 2)
                phi = phi_t[li] = _put_blocks(phi_t[li], blocks, first,
                                              filter_features(mp, s_rows), n_blocks)
            vc_rows = take(vcat_t[li], 2)
            ds, dv = painn_message_subset(
                halo(phi), halo(vcat_t[li]), take(rbf, 1), take(envm, 1), take(nbr, 1),
                take(unit, 2), rw["dw"][li], rw["db"][li], dband.win_start[blocks], dband)
            s_out, v_out = painn_update_fused((s_rows + ds).contiguous(),
                                              (vc_rows + dv).contiguous(),
                                              *update_weights(up), alive_rows)
            if li + 1 < L:
                s_t[li + 1] = _put_blocks(s_t[li + 1], blocks, first, s_out, n_blocks)
                vcat_t[li + 1] = _put_blocks(vcat_t[li + 1], blocks, first, v_out, n_blocks)
            else:
                e_rows = _energies(s_out, alive_rows, take(excl_s, 1))
                e_atom = _put_blocks(e_atom[..., None], blocks, first, e_rows[..., None],
                                     n_blocks)[..., 0]
        new = IncCaches(s=tuple(s_t), phi=tuple(phi_t), vcat=tuple(vcat_t), e_atom=e_atom)
        se, oob = _finish(e_atom.sum(dim=-1), overflow, type_idx, alive, counts)
        return se, new, oob

    def init_state(site_state) -> IncState:
        site_state = torch.as_tensor(site_state, dtype=torch.int64, device=dev)
        se, caches, _ = energy_full(site_state)
        return IncState(site_state=site_state, energy=se, caches=caches)

    return IncEngine(init_state=init_state, energy_full=energy_full, delta=delta,
                     n_sites=spec.n_sites, n_codes=spec.n_codes)


def make_incremental_painn_from_system(system) -> IncEngine:
    """The delta engine of a ``systems.py`` ExampleSystem that carries a
    routing band (``srtio3_001_painn(supercell=...)`` on a rigid lattice)."""
    if system.routing_band is None or system.run.relax is not None:
        raise ValueError("the system carries no routing band or relaxes: incremental "
                         "evaluation needs a rigid banded PaiNN system (e.g. "
                         "systems.srtio3_001_painn(supercell=(2, 2)))")
    return make_incremental_painn(system.spec, system.run.d, system.potential, system.static_nbr,
                                  system.routing_band, system.run.surface_energy_fn)


def _inc_step(engine: IncEngine, dist_accept, state: IncState, temp, trial_ss, sites, u_acc,
              valid=None):
    ss = state.site_state
    with span("mc.energy"):
        se, new_caches, oob = engine.delta(state.caches, trial_ss, sites)
    temp = torch.as_tensor(temp, dtype=state.energy.dtype, device=ss.device)
    accept = metropolis_accept(u_acc, state.energy, se, temp)
    if valid is not None:
        accept = accept & valid
    if dist_accept is not None:
        accept = accept & dist_accept(trial_ss)
    new_state = IncState(
        site_state=torch.where(accept[:, None], trial_ss, ss),
        energy=torch.where(accept, se, state.energy),
        caches=select_caches(accept, new_caches, state.caches),
    )
    return new_state, StepInfo(accepted=accept, energy=new_state.energy,
                               n_ads=num_occupied_sites(new_state.site_state), oob=oob)


def make_incremental_semigrand_step(engine: IncEngine, d=None, criterion: str = "metropolis",
                                    filter_distance: float = 1.5) -> Callable:
    """``step(state, temp, site, u_code, u_acc) -> (state, StepInfo)``: the
    semigrand Change step of ``core.events.make_semigrand_step`` with the
    full evaluation replaced by ``engine.delta`` of the moved site, batched
    over chains. ``criterion="metropolis_distance"`` (with the DeviceSpec
    ``d``) adds the distance filter's hard wall, as the full-evaluation
    step does."""
    dist_accept = hard_wall_accept(d, criterion, filter_distance)

    def step(state: IncState, temp, site, u_code, u_acc):
        trial_ss = propose_change(state.site_state, site, u_code)
        return _inc_step(engine, dist_accept, state, temp, trial_ss, site[:, None], u_acc)

    return step


def make_incremental_canonical_step(engine: IncEngine, d=None, criterion: str = "metropolis",
                                    filter_distance: float = 1.5) -> Callable:
    """``step(state, temp, g_types, g_site1, g_site2, u_acc) -> (state,
    StepInfo)``: the unweighted canonical Exchange step of
    ``core.events.make_canonical_step`` (the same draws) with the full
    evaluation replaced by ``engine.delta`` of the two exchanged sites. A
    chain with fewer than two codes present never accepts;
    ``criterion="metropolis_distance"`` (with ``d``) adds the distance
    filter's hard wall."""
    dist_accept = hard_wall_accept(d, criterion, filter_distance)

    def step(state: IncState, temp, g_types, g_site1, g_site2, u_acc):
        ss = state.site_state
        site1, site2, valid = pick_exchange(ss, engine.n_codes, g_types, g_site1, g_site2)
        trial_ss = exchange_sites(ss, site1, site2)
        return _inc_step(engine, dist_accept, state, temp, trial_ss,
                         torch.stack([site1, site2], dim=1), u_acc, valid)

    return step


class IncSweepRecord(NamedTuple):
    """Per-sweep observables, leading axes (chains, sweeps)."""

    energy: torch.Tensor         # (C, sweeps) end-of-sweep surface energies
    accept_rate: torch.Tensor    # (C, sweeps)
    n_ads: torch.Tensor          # (C, sweeps)
    site_state: torch.Tensor     # (C, sweeps, S)
    oob_rate: torch.Tensor       # (C, sweeps) fraction of trial moves OOB-clamped


def make_incremental_run(step_fn: Callable, sweep_size: int, n_sites: int, n_codes: int,
                         canonical: bool = False) -> Callable:
    """``run(state, temps, generator, chain_block=None) -> (state,
    IncSweepRecord)`` over incremental steps, with the draws of ``core.engine.make_run_fn`` (the
    same generator state gives the same draws; ``canonical`` for an
    exchange step's; the generator is continued in place)."""
    draws = canonical_draws if canonical else semigrand_draws

    def record(state: IncState, accept_rate, oob_rate) -> IncSweepRecord:
        return IncSweepRecord(energy=state.energy, accept_rate=accept_rate,
                              n_ads=num_occupied_sites(state.site_state),
                              site_state=state.site_state, oob_rate=oob_rate)

    def run(state: IncState, temps, generator: torch.Generator, chain_block=None):
        return run_sweeps(step_fn, state, temps, generator, sweep_size, n_sites, n_codes, record,
                          draws, chain_block)

    return run
