"""The MC engine: sweeps of batched steps over all chains at once.

The counterpart of ``surface_sampling_tpu/core/engine.py``. The JAX
engine nests two ``lax.scan``s under one ``jit``; here a run is a Python
loop of batched steps, each step one evaluation of every chain. The
random draws of a run come from one ``torch.Generator`` on the chains'
device (:func:`make_generator`), which every run continues in place, so a
run cut into chunks that pass one generator along gives bitwise the same
states and records as one run (the JAX state carries its key for the same
reason).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from scipy.cluster.hierarchy import fcluster, linkage

from surface_sampling_tpu_torch.core.energy import (
    RelaxConfig,
    SymmetricSlabConfig,
    identity_surface_energy,
    make_state_energy_fn,
)
from surface_sampling_tpu_torch.core.events import (
    ChainBlock,
    block_draws,
    canonical_draws,
    make_canonical_step,
    make_canonical_step_mtm,
    make_semigrand_step,
    make_semigrand_step_mtm,
    mtm_draws,
    semigrand_draws,
)
from surface_sampling_tpu_torch.core.spec import SurfaceSpec
from surface_sampling_tpu_torch.core.state import MCState, device_spec, num_occupied_sites
from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.parallel.chains import chain_states
from surface_sampling_tpu_torch.utils.tracing import span


class SweepRecord(NamedTuple):
    """Per-sweep observables, leading axes (chains, sweeps)."""

    site_state: torch.Tensor        # (C, sweeps, S)
    energy: torch.Tensor            # (C, sweeps)
    accept_rate: torch.Tensor       # (C, sweeps)
    n_ads: torch.Tensor             # (C, sweeps)
    positions: torch.Tensor         # (C, sweeps, N, 3), or (C, sweeps, 0, 3)
    oob_rate: torch.Tensor          # (C, sweeps) fraction of trial moves OOB-clamped


@dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (the JAX package's fields)."""

    sweep_size: int = 20
    canonical: bool = False
    num_ads_atoms: int = 0
    criterion: str = "metropolis"        # metropolis | testing | distance | metropolis_distance
    filter_distance: float = 1.5         # for the distance criteria
    always_accept: bool = True           # for the testing criterion
    require_per_atom_energies: bool = False
    require_distance_decay: bool = False
    record_positions: bool = True
    prep_max_steps: int | None = None    # bound canonical prep (None = reference-faithful)
    prep_force_fill: bool = False        # deterministic fill if the bound is hit
    mtm_trials: int = 0                  # >1: multiple-try Metropolis (semigrand + canonical)


def geometric_schedule(start_temp: float, total_sweeps: int, alpha: float = 0.99) -> np.ndarray:
    """T_i = start * alpha^i, the default annealing schedule."""
    return start_temp * alpha ** np.arange(total_sweeps, dtype=np.float64)


def make_generator(seed: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def run_sweeps(step_fn: Callable, state, temps, generator: torch.Generator, sweep_size: int,
               n_sites: int, n_codes: int, record: Callable, draws: Callable = semigrand_draws,
               chain_block: ChainBlock | None = None):
    """The sweep loop of a run: ``temps`` (sweeps,) or (C, sweeps); every
    step takes ``draws(gen, C, n_sites, n_codes)`` (per chain: a site, a
    code and an acceptance uniform by default) and calls ``step_fn(state,
    temp, *draws) -> (state, StepInfo)``. The draws come from ``generator``
    (on the state's device), which advances in place. With ``chain_block``
    the state holds rows ``lo:hi`` of a global batch, and each step takes
    those rows of the global batch's draws (:func:`block_draws`). After each
    sweep ``record(state, accept_rate, oob_rate)`` gives that sweep's
    record, a tuple of (C, ...) tensors. Returns the final state and the
    records stacked along a sweep axis 1."""
    dev = state.site_state.device
    C = state.site_state.shape[0]
    draws = block_draws(draws, chain_block)
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    recs = []
    for t in range(temps.shape[-1]):
        temp = temps[..., t]
        n_acc = torch.zeros(C, device=dev)
        n_oob = torch.zeros(C, device=dev)
        for _ in range(sweep_size):
            with span("mc.step"):
                state, info = step_fn(state, temp, *draws(generator, C, n_sites, n_codes))
            n_acc += info.accepted
            n_oob += info.oob
        recs.append(record(state, n_acc / sweep_size, n_oob / sweep_size))
    return state, type(recs[0])(*(torch.stack(f, dim=1) for f in zip(*recs)))


def make_sweep_record(record_positions: bool = True) -> Callable:
    """``record(state, accept_rate, oob_rate) -> SweepRecord`` of an
    ``MCState`` run (the relaxed positions left out, as an empty axis,
    unless ``record_positions``)."""

    def record(state: MCState, accept_rate, oob_rate) -> SweepRecord:
        pos = state.relaxed_positions
        return SweepRecord(
            site_state=state.site_state,
            energy=state.energy,
            accept_rate=accept_rate,
            n_ads=num_occupied_sites(state.site_state),
            positions=pos if record_positions else pos[:, :0],
            oob_rate=oob_rate,
        )

    return record


def _semigrand_step(d, state_energy_fn, cfg: EngineConfig):
    return make_semigrand_step(d, state_energy_fn, criterion=cfg.criterion,
                               filter_distance=cfg.filter_distance,
                               always_accept=cfg.always_accept)


def make_run_fn(d, state_energy_fn: Callable, cfg: EngineConfig, potential=None,
                distance_weight_matrix=None) -> Callable:
    """Build ``run(state, temps, generator) -> (state, SweepRecord)``: semigrand steps, or canonical exchange steps with
    ``cfg.canonical`` (``potential`` for per-atom-energy weights,
    ``distance_weight_matrix`` for distance-decay weights).

    ``temps`` holds one temperature per sweep, shape (sweeps,) for a
    schedule all chains share or (C, sweeps) for one per chain. The draws
    come from ``generator`` (a ``torch.Generator`` on the state's device,
    see :func:`make_generator`), continued in place: pass the same one to
    the next chunk of a run. ``chain_block`` (a :class:`ChainBlock`) runs
    the chains of one block of a global batch on the global batch's draws
    (:func:`run_sweeps`).

    ``cfg.mtm_trials`` > 1 runs multiple-try Metropolis steps of that many
    trials (``core.events.make_semigrand_step_mtm`` /
    ``make_canonical_step_mtm``), which need the Metropolis criterion and,
    canonical, the unweighted (symmetric) exchange proposal.
    """
    if cfg.mtm_trials > 1:
        if cfg.criterion != "metropolis":
            raise ValueError("mtm_trials requires the metropolis criterion")
        if cfg.canonical and (cfg.require_per_atom_energies or cfg.require_distance_decay):
            raise ValueError("mtm_trials needs the symmetric (unweighted) switch proposal")
        make = make_canonical_step_mtm if cfg.canonical else make_semigrand_step_mtm
        step_fn = make(d, state_energy_fn, k_trials=cfg.mtm_trials)
        draws = mtm_draws(cfg.mtm_trials, canonical=cfg.canonical)
    elif cfg.canonical:
        step_fn = make_canonical_step(
            d, state_energy_fn, criterion=cfg.criterion, filter_distance=cfg.filter_distance,
            always_accept=cfg.always_accept,
            require_per_atom_energies=cfg.require_per_atom_energies,
            require_distance_decay=cfg.require_distance_decay, potential=potential,
            distance_weight_matrix=distance_weight_matrix)
        draws = canonical_draws
    else:
        step_fn = _semigrand_step(d, state_energy_fn, cfg)
        draws = semigrand_draws
    n_sites = d.site_coords.shape[0]
    record = make_sweep_record(cfg.record_positions)

    def run(state: MCState, temps, generator: torch.Generator,
            chain_block: ChainBlock | None = None):
        return run_sweeps(step_fn, state, temps, generator, cfg.sweep_size, n_sites, d.n_codes,
                          record, draws, chain_block)

    return run


def _select_chains(mask: torch.Tensor, new: MCState, old: MCState) -> MCState:
    return MCState(site_state=torch.where(mask[:, None], new.site_state, old.site_state),
                   energy=torch.where(mask, new.energy, old.energy),
                   relaxed_positions=torch.where(mask[:, None, None], new.relaxed_positions,
                                                 old.relaxed_positions))


def prepare_canonical_fn(d, state_energy_fn: Callable, num_ads_atoms: int, cfg: EngineConfig,
                         max_steps: int | None = None, force_fill: bool = False) -> Callable:
    """Build ``prepare(state, temp, generator) -> state``: semigrand steps
    until ``num_ads_atoms`` sites of each chain are occupied (the
    reference's MCMC.prepare_canonical). Chains step together; a chain that
    has reached the count keeps its state while the others go on, as in the
    JAX package's batched ``while_loop``.

    The loop is unbounded by default, as the reference's. ``max_steps``
    bounds it; with ``force_fill`` each chain's missing occupancy is then
    filled deterministically (its lowest-index empty sites, uniform random
    codes). Canonical exchanges conserve the code multiset, so in a
    multi-species vocabulary a force-filled start fixes the composition
    for the whole run.

    ``prepare(..., chain_block, group)`` prepares rows ``lo:hi`` of a global
    batch on the global batch's draws (:func:`block_draws`). The loop runs
    until every chain of the global batch is full, which a block learns
    from ``group``, the process group of the blocks (one all-reduce a
    step); without it a block stops when its own chains are full, and its
    generator then falls behind the unsharded run's.
    """
    step_fn = _semigrand_step(d, state_energy_fn, cfg)
    n_sites = d.site_coords.shape[0]
    n_codes = d.n_codes

    def prepare(state: MCState, temp, generator: torch.Generator,
                chain_block: ChainBlock | None = None, group=None) -> MCState:
        C = state.site_state.shape[0]
        draws = block_draws(semigrand_draws, chain_block)
        it = 0
        while True:
            active = num_occupied_sites(state.site_state) < num_ads_atoms
            any_active = active.any().to(torch.int32)
            if group is not None:
                torch.distributed.all_reduce(any_active, torch.distributed.ReduceOp.MAX,
                                             group=group)
            if not bool(any_active) or (max_steps is not None and it >= max_steps):
                break
            new, _ = step_fn(state, temp, *draws(generator, C, n_sites, n_codes))
            state = _select_chains(active, new, state)
            it += 1
        if not force_fill:
            return state
        ss = state.site_state
        missing = num_ads_atoms - num_occupied_sites(ss)
        ar = torch.arange(n_sites, device=ss.device)
        # rank empty sites first (stable by index), occupy the first `missing`
        order = torch.argsort(torch.where(ss == 0, ar, n_sites + ar), dim=1)
        take = ar < missing[:, None]
        n_global = C if chain_block is None else chain_block.n_global
        codes = torch.randint(1, n_codes, (n_global, n_sites), generator=generator,
                              device=generator.device)
        if chain_block is not None:
            codes = codes[chain_block.lo:chain_block.hi]
        filled = torch.where(take, codes, torch.gather(ss, 1, order))
        return state._replace(site_state=ss.scatter(1, order, filled))

    return prepare


# ----------------------------------------------------------------------
# Host helpers: even prefill and site-class counts
# ----------------------------------------------------------------------
def _cluster_centers(points: np.ndarray, n_clusters: int):
    """Ward clustering of site coordinates (a copy of
    ``analysis/clustering.get_cluster_centers``): (centers, labels 1..k)."""
    labels = fcluster(linkage(points, "ward"), n_clusters, criterion="maxclust")
    # fcluster may return fewer clusters than requested (ties): relabel to
    # contiguous 1..k over the clusters that exist
    uniq = np.unique(labels)
    remap = {old: new for new, old in enumerate(uniq, start=1)}
    labels = np.array([remap[v] for v in labels])
    centers = np.array([points[labels == i].mean(axis=0) for i in range(1, len(uniq) + 1)])
    return centers, labels


def _closest_members(points: np.ndarray, centers: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Index of the member closest to each cluster's center (a copy of
    ``analysis/clustering.find_closest_points_indices``)."""
    out = []
    for i in range(1, len(centers) + 1):
        members = np.where(labels == i)[0]
        out.append(int(members[np.argmin(np.linalg.norm(points[members] - centers[i - 1],
                                                        axis=1))]))
    return np.array(out, dtype=int)


def even_site_prefill(spec, num_ads_atoms: int, rng=None, code: int | None = None) -> np.ndarray:
    """Evenly spread initial adsorption over the site lattice (reference
    MCMC.prepare_canonical(even_adsorption_sites=True)): Ward-cluster the
    xy site coordinates into ``num_ads_atoms`` groups and occupy the member
    closest to each center. Returns an (S,) int32 site_state (codes random
    over the vocabulary unless ``code`` is given)."""
    rng = rng or np.random.default_rng()
    xy = spec.site_coords[:, :2]
    centers, labels = _cluster_centers(xy, num_ads_atoms)
    sites_idx = list(_closest_members(xy, centers, labels))
    # ward/fcluster can merge ties and return fewer clusters; top up randomly
    remaining = [s for s in range(spec.n_sites) if s not in sites_idx]
    while len(sites_idx) < num_ads_atoms and remaining:
        sites_idx.append(remaining.pop(int(rng.choice(len(remaining)))))
    ss = np.zeros(spec.n_sites, dtype=np.int32)
    for s in sites_idx[:num_ads_atoms]:
        ss[s] = code if code is not None else rng.integers(1, spec.n_codes)
    return ss


def count_adsorption_sites(site_state, connectivity) -> dict:
    """Histogram of one chain's occupied sites by connectivity class."""
    ss = np.asarray(site_state)
    return dict(Counter(np.asarray(connectivity)[ss > 0].tolist()))


@dataclass
class MCMCRun:
    """Bundle of a spec and a potential staged on one device: the device
    spec ``d`` and the batched ``state_energy_fn`` that runs and steps use
    (every trial state relaxed when ``relax`` is given, under
    ``relax_potential`` when that is given; the mirrored double slab when
    ``symmetric`` is a ``SymmetricSlabConfig``), and :meth:`run`, the entry
    point of a whole run."""

    spec: SurfaceSpec
    potential: object
    surface_energy_fn: Callable | None = None
    device: torch.device | str = "cuda"
    relax: RelaxConfig | None = None
    symmetric: SymmetricSlabConfig | None = None
    relax_potential: object | None = None

    def __post_init__(self):
        self.d = device_spec(self.spec, resolve_device(self.device))
        self.state_energy_fn = make_state_energy_fn(
            self.d, self.potential, self.surface_energy_fn or identity_surface_energy,
            relax=self.relax, symmetric=self.symmetric, relax_potential=self.relax_potential)

    def init_state(self, site_state=None, n_chains: int = 1) -> MCState:
        """States of ``n_chains`` chains (all sites empty, or ``site_state``:
        (S,) for every chain or (C, S)) with the energies and positions of
        one evaluation."""
        if site_state is not None and np.ndim(site_state) == 2:
            n_chains = len(site_state)
        state = chain_states(self.d, n_chains, site_state)
        e = self.state_energy_fn(state.site_state)
        return state._replace(energy=e.surface_energy, relaxed_positions=e.positions)

    def run(self, seed, temps, site_state=None, cfg: EngineConfig = EngineConfig(),
            distance_weight_matrix=None, n_chains: int = 1):
        """A whole run from fresh states: the canonical prefill (semigrand
        steps at ``temps[0]`` up to ``cfg.num_ads_atoms``) when ``cfg`` is
        canonical, then ``make_run_fn``'s sweeps. ``seed`` is an int or a
        ``torch.Generator`` (continued in place). Returns the final state
        and the SweepRecord, leading axis chains."""
        gen = seed if isinstance(seed, torch.Generator) else make_generator(seed, self.d.device)
        state = self.init_state(site_state, n_chains)
        if cfg.canonical and cfg.num_ads_atoms > 0:
            prep = prepare_canonical_fn(self.d, self.state_energy_fn, cfg.num_ads_atoms, cfg,
                                        max_steps=cfg.prep_max_steps,
                                        force_fill=cfg.prep_force_fill)
            state = prep(state, float(np.asarray(temps).reshape(-1)[0]), gen)
            e = self.state_energy_fn(state.site_state)
            state = state._replace(energy=e.surface_energy, relaxed_positions=e.positions)
        run_fn = make_run_fn(self.d, self.state_energy_fn, cfg, potential=self.potential,
                             distance_weight_matrix=distance_weight_matrix)
        return run_fn(state, temps, gen)
