"""Surface-energy models and the per-move state evaluation, batched over
chains.

The counterpart of ``surface_sampling_tpu/core/energy.py``: a
surface-energy model (chemical potentials alone, or with bulk-reference
offsets) maps (potential energy, per-element counts) to the acceptance
energy, and ``make_state_energy_fn`` assembles the evaluation
every MC step runs: realize the occupancy (mirrored for a symmetric
slab), relax it (FIRE or L-BFGS, under a separate relax potential if
given) or take the rigid slot geometry, score it, clamp out-of-bounds
energies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import HARTREE_TO_EV, Z_FROM_SYMBOL
from surface_sampling_tpu_torch.core.spec import SurfaceSpec
from surface_sampling_tpu_torch.core.state import (
    DeviceSpec,
    element_counts,
    realize_alive,
    realize_free_mask,
    realize_numbers,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.core.relax import (
    FireConfig,
    energy_threshold,
    fire_relax,
    lbfgs_relax,
)
from surface_sampling_tpu_torch.device import resolve_device


def identity_surface_energy(e_pot, counts):
    """Surface energy == potential energy."""
    return e_pot


def make_chem_pot_surface_energy(spec: SurfaceSpec, chem_pots: dict[str, float],
                                 device: torch.device | str = "cuda") -> Callable:
    """Plain semigrand surface energy E_pot - sum_e mu_e * n_e over the
    elements named in ``chem_pots`` (no bulk-reference offsets). Returns
    ``fn(e_pot (C,), counts (C, E)) -> (C,)``."""
    coeff = np.zeros(len(spec.element_zs))
    for sym, mu in chem_pots.items():
        idx = np.where(spec.element_zs == Z_FROM_SYMBOL[sym])[0]
        if len(idx):
            coeff[int(idx[0])] = mu
    coeff_t = torch.as_tensor(coeff, dtype=torch.float32, device=resolve_device(device))

    def surface_energy(e_pot, counts):
        return e_pot - counts @ coeff_t

    return surface_energy


def make_offset_surface_energy(
    spec: SurfaceSpec,
    chem_pots: dict[str, float],
    offset_data: dict,
    offset_units: str = "atomic",
    device: torch.device | str = "cuda",
) -> Callable:
    """Semigrand surface energy with bulk-reference and chemical-potential
    offsets: surface_energy = E_pot - sum_e coeff_e * n_e, with

        coeff_ref = s*E_bulk[ref_formula]
                    - sum_{e != ref} (stoic_e/stoic_ref) (s*E_bulk[e] + mu_e)
        coeff_e   = s*E_bulk[e] + mu_e          (e != ref)

    where s = HARTREE_TO_EV if the offset table is in atomic units. Returns
    ``fn(e_pot (C,), counts (C, E)) -> (C,)``.
    """
    bulk_energies = offset_data["bulk_energies"]
    stoics = offset_data["stoics"]
    ref_formula = offset_data["ref_formula"]
    ref_element = offset_data["ref_element"]
    scale = HARTREE_TO_EV if offset_units == "atomic" else 1.0

    coeff = np.zeros(len(spec.element_zs))
    sym_of = {Z_FROM_SYMBOL[s]: s for s in list(chem_pots) + list(stoics) + [ref_element]}
    ref_coeff = scale * bulk_energies[ref_formula]
    for i, z in enumerate(spec.element_zs):
        sym = sym_of.get(int(z))
        if sym is None or sym == ref_element:
            continue
        mu = chem_pots.get(sym, 0.0)
        be = scale * bulk_energies.get(sym, 0.0)
        coeff[i] = be + mu
        ref_coeff -= stoics.get(sym, 0.0) / stoics[ref_element] * (be + mu)
    ref_slot = int(np.where(spec.element_zs == Z_FROM_SYMBOL[ref_element])[0][0])
    coeff[ref_slot] = ref_coeff
    coeff_t = torch.as_tensor(coeff, dtype=torch.float32, device=resolve_device(device))

    def surface_energy(e_pot, counts):
        return e_pot - counts @ coeff_t

    return surface_energy


@dataclass(frozen=True)
class RelaxConfig:
    """Relaxation policy inside the acceptance energy (reference:
    calc_settings relax_atoms / relax_steps).

    ``method``: "fire" (``core.relax.fire_relax``) or "lbfgs"
    (``core.relax.lbfgs_relax``). ``refresh_edges``: "once" selects the
    edge topology at the start geometry of each relaxation and recomputes
    only the geometry per force call (the reference's neighbor-list
    semantics), for potentials with the topology hooks; "every_step"
    re-ranks the candidate pairs at every force call."""

    steps: int = 20
    fmax: float = 0.01
    max_step: float = 0.2
    method: str = "fire"          # fire | lbfgs
    refresh_edges: str = "once"   # once | every_step


@dataclass(frozen=True)
class SymmetricSlabConfig:
    """Symmetric-slab energy mode: the MC moves the top half; the energy is
    that of the slab with every non-base slot mirrored through the plane
    z = ``base_z`` (N + N - n_base slots, a static shape).

    base_z: the z of the reflection plane (mean of the base atoms).
    n_base: number of base atoms (not mirrored), the first slots.
    """

    base_z: float
    n_base: int


def symmetrize_arrays(sym: SymmetricSlabConfig, positions, numbers, alive):
    """Append mirrored copies of all non-base slots to (C, N, ...) arrays:
    positions reflected through z = base_z, numbers and alive copied."""
    refl = positions.clone()
    refl[..., 2] = 2.0 * sym.base_z - positions[..., 2]
    n = sym.n_base
    return (torch.cat([positions, refl[:, n:]], dim=1), torch.cat([numbers, numbers[:, n:]], dim=1),
            torch.cat([alive, alive[:, n:]], dim=1))


class StateEnergy(NamedTuple):
    surface_energy: torch.Tensor    # (C,) acceptance energy (OOB-clamped)
    potential_energy: torch.Tensor  # (C,)
    positions: torch.Tensor         # (C, N, 3) relaxed (or ideal) geometry
    oob: torch.Tensor               # (C,) bool


def relax_settings(relax: RelaxConfig, relax_pot,
                   symmetric: SymmetricSlabConfig | None = None):
    """The ``FireConfig`` of a ``RelaxConfig`` (steps, fmax, max_step) and
    whether each relaxation fixes its edge topology (``refresh_edges="once"``
    with a relaxing potential that carries the topology hooks, on a slab
    that is not mirrored). Raises on an unknown method or policy."""
    if relax.method not in ("fire", "lbfgs"):
        raise ValueError(f"relax method must be 'fire' or 'lbfgs', got {relax.method!r}")
    if relax.refresh_edges not in ("once", "every_step"):
        raise ValueError(f"refresh_edges must be 'once' or 'every_step', "
                         f"got {relax.refresh_edges!r}")
    fire_cfg = FireConfig(steps=relax.steps, fmax=relax.fmax, max_step=relax.max_step)
    fixed_topo = (relax.refresh_edges == "once" and symmetric is None
                  and hasattr(relax_pot, "edge_topology"))
    return fire_cfg, fixed_topo


def relax_and_score(potential, method: str, fire_cfg: FireConfig, fixed_topo: bool, pos0,
                    free, type_idx, alive, bound, shifts=None, relax_potential=None,
                    energy_of: Callable | None = None):
    """Relax every chain from ``pos0`` with the atoms under ``free`` (C, N)
    moving, by ``method`` ("fire": ``fire_relax``, "lbfgs":
    ``lbfgs_relax``) under ``relax_potential`` (``potential`` when None),
    and score the result under ``potential``: ``(positions, e_pot, oob)``.

    ``energy_of(pot) -> (positions -> (C,) energies)`` is the evaluator
    (default ``pot.energy(p, type_idx, alive, shifts)``; a symmetric slab
    passes its mirror). With ``fixed_topo`` the edge topology is selected at
    ``pos0`` and each force call recomputes only the geometry. With either,
    or with a separate relax potential, the potential energy is a fresh
    ``potential`` evaluation at the relaxed positions, checked against the
    bound (C,) again, so relaxed and unrelaxed states are scored by one
    evaluator; otherwise it is the relaxation's own final energy.
    Out-of-bounds potential energies are clamped to the bound."""
    if energy_of is None:
        def energy_of(pot):
            return lambda p: pot.energy(p, type_idx, alive, shifts)

    relax_pot = potential if relax_potential is None else relax_potential
    if fixed_topo:
        topo = relax_pot.edge_topology(pos0, alive)

        def relax_e_of(p):
            return relax_pot.energy_with_edges(p, type_idx, alive,
                                               edges=relax_pot.edges_of(p, topo))
    else:
        relax_e_of = energy_of(relax_pot)
    relaxer = fire_relax if method == "fire" else lbfgs_relax
    res = relaxer(relax_e_of, pos0, free, fire_cfg)
    if relax_potential is None and not fixed_topo:
        return res.positions, res.energy, res.oob
    e_pot = energy_of(potential)(res.positions)
    oob = res.oob | (e_pot.abs() > bound) | torch.isnan(e_pot)
    return res.positions, torch.where(oob, bound, e_pot), oob


def make_state_energy_fn(
    d: DeviceSpec,
    potential,
    surface_energy_fn: Callable = identity_surface_energy,
    relax: RelaxConfig | None = None,
    symmetric: SymmetricSlabConfig | None = None,
    relax_potential=None,
) -> Callable:
    """Build ``fn(site_state (C, S)) -> StateEnergy``, the evaluation of
    every MC step.

    Without ``relax`` the state is scored at its ideal slot geometry,
    through ``potential.rigid_energy(type_idx, alive)`` where the
    potential has it (and the slab is not mirrored), else
    ``potential.energy(positions, type_idx, alive, d.shifts)``. With
    ``relax`` every chain's trial state is relaxed (FIRE or L-BFGS; frozen
    bulk and dead slots held) and scored by :func:`relax_and_score`.

    ``symmetric``: the potential sees the mirrored double slab, whose
    non-base alive atoms count twice in the element counts; a relaxation
    moves the top half and re-derives the mirror at every force call.
    ``relax_potential``: relax under this potential, score the relaxed
    geometry under ``potential`` (only meaningful with ``relax``).

    A NaN or an energy beyond ``energy_threshold(N)`` is out of bounds:
    both the potential and the surface energy are clamped to the bound, so
    the Metropolis test rejects the state."""
    if relax is not None:
        fire_cfg, fixed_topo = relax_settings(
            relax, potential if relax_potential is None else relax_potential, symmetric)
    rigid = (getattr(potential, "rigid_energy", None)
             if relax is None and symmetric is None else None)

    def state_energy(site_state: torch.Tensor) -> StateEnergy:
        pos0 = realize_positions(d, site_state)
        type_idx = realize_type_idx(d, site_state)
        alive = realize_alive(d, site_state)
        counts = element_counts(d, site_state, dtype=pos0.dtype)
        e_bound = energy_threshold(pos0.shape[1])
        bound = torch.full((pos0.shape[0],), e_bound, dtype=pos0.dtype, device=pos0.device)
        energy_of = None
        if symmetric is not None:
            n_base, base_z = symmetric.n_base, symmetric.base_z
            numbers = realize_numbers(d, site_state)
            elem = d.z_to_element[numbers[:, n_base:]]
            mirrored = (elem[..., None] == torch.arange(d.n_elements, device=elem.device)) \
                & alive[:, n_base:, None]
            counts = counts + mirrored.sum(dim=1).to(pos0.dtype)
            _, numbers_full, alive_full = symmetrize_arrays(symmetric, pos0, numbers, alive)
            type_idx_full = d.type_of_z[numbers_full]

            def energy_of(pot):
                def e_of(p_top):
                    refl = torch.cat([p_top[:, n_base:, :2],
                                      2.0 * base_z - p_top[:, n_base:, 2:]], dim=2)
                    return pot.energy(torch.cat([p_top, refl], dim=1), type_idx_full,
                                      alive_full, d.shifts)

                return e_of

        if relax is None:
            if rigid is not None:
                e_pot = rigid(type_idx, alive)
            elif energy_of is not None:
                e_pot = energy_of(potential)(pos0)
            else:
                e_pot = potential.energy(pos0, type_idx, alive, d.shifts)
            oob = (e_pot.abs() > e_bound) | torch.isnan(e_pot)
            e_pot = torch.where(oob, bound, e_pot)
            pos = pos0
        else:
            pos, e_pot, oob = relax_and_score(potential, relax.method, fire_cfg, fixed_topo,
                                              pos0, realize_free_mask(d, site_state), type_idx,
                                              alive, bound, d.shifts, relax_potential, energy_of)
        se = torch.where(oob, bound, surface_energy_fn(e_pot, counts))
        return StateEnergy(surface_energy=se, potential_energy=e_pot, positions=pos, oob=oob)

    return state_energy
