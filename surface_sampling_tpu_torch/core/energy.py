"""Surface-energy models and the per-move state evaluation, batched over
chains.

The counterpart of ``surface_sampling_tpu/core/energy.py``: a
surface-energy model (chemical potentials alone, or with bulk-reference
offsets) maps (potential energy, per-element counts) to the acceptance
energy, and ``make_state_energy_fn`` assembles the evaluation
every MC step runs: realize the occupancy, relax it (FIRE) or take the
rigid slot geometry, score it, clamp out-of-bounds energies.
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
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.core.relax import FireConfig, energy_threshold, fire_relax
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

    ``refresh_edges``: "once" selects the edge topology at the start
    geometry of each relaxation and recomputes only the geometry per force
    call (the reference's neighbor-list semantics), for potentials with
    the topology hooks; "every_step" re-ranks the candidate pairs at every
    force call. Only ``method="fire"`` is ported."""

    steps: int = 20
    fmax: float = 0.01
    max_step: float = 0.2
    method: str = "fire"          # fire | lbfgs
    refresh_edges: str = "once"   # once | every_step


class StateEnergy(NamedTuple):
    surface_energy: torch.Tensor    # (C,) acceptance energy (OOB-clamped)
    potential_energy: torch.Tensor  # (C,)
    positions: torch.Tensor         # (C, N, 3) relaxed (or ideal) geometry
    oob: torch.Tensor               # (C,) bool


def relax_settings(relax: RelaxConfig, potential) -> tuple[FireConfig, bool]:
    """The FIRE configuration of a ``RelaxConfig`` and whether each
    relaxation fixes its edge topology (``refresh_edges="once"`` with a
    potential carrying the topology hooks). Raises on what is not ported."""
    if relax.method != "fire":
        raise NotImplementedError(f"relax method {relax.method!r} is not ported: only 'fire'")
    if relax.refresh_edges not in ("once", "every_step"):
        raise ValueError(f"refresh_edges must be 'once' or 'every_step', "
                         f"got {relax.refresh_edges!r}")
    fire_cfg = FireConfig(steps=relax.steps, fmax=relax.fmax, max_step=relax.max_step)
    return fire_cfg, relax.refresh_edges == "once" and hasattr(potential, "edge_topology")


def relax_and_score(potential, fire_cfg: FireConfig, fixed_topo: bool, pos0, free, type_idx,
                    alive, bound, shifts=None):
    """FIRE-relax every chain from ``pos0`` with the atoms under ``free``
    (C, N) moving, and score the result: ``(positions, e_pot, oob)``.

    With ``fixed_topo`` the edge topology is selected at ``pos0`` and each
    force call recomputes only the geometry; the potential energy is then a
    fresh-edge ``potential.energy`` at the relaxed positions, checked
    against the bound (C,) again, so relaxed and unrelaxed states are
    scored by one evaluator. Otherwise it is the relaxation's own final
    energy. Out-of-bounds potential energies are clamped to the bound."""

    def e_of(p):
        return potential.energy(p, type_idx, alive, shifts)

    if fixed_topo:
        topo = potential.edge_topology(pos0, alive)

        def relax_e_of(p):
            return potential.energy_with_edges(p, type_idx, alive,
                                               edges=potential.edges_of(p, topo))
    else:
        relax_e_of = e_of
    res = fire_relax(relax_e_of, pos0, free, fire_cfg)
    if not fixed_topo:
        return res.positions, res.energy, res.oob
    e_pot = e_of(res.positions)
    oob = res.oob | (e_pot.abs() > bound) | torch.isnan(e_pot)
    return res.positions, torch.where(oob, bound, e_pot), oob


def make_state_energy_fn(
    d: DeviceSpec,
    potential,
    surface_energy_fn: Callable = identity_surface_energy,
    relax: RelaxConfig | None = None,
    symmetric=None,
    relax_potential=None,
) -> Callable:
    """Build ``fn(site_state (C, S)) -> StateEnergy``, the evaluation of
    every MC step.

    Without ``relax`` the state is scored at its ideal slot geometry,
    through ``potential.rigid_energy(type_idx, alive)`` where the
    potential has it, else ``potential.energy(positions, type_idx, alive,
    d.shifts)``. With ``relax`` every
    chain's trial state is FIRE-relaxed (frozen bulk and dead slots held)
    and scored by :func:`relax_and_score`.

    A NaN or an energy beyond ``energy_threshold(N)`` is out of bounds:
    both the potential and the surface energy are clamped to the bound, so
    the Metropolis test rejects the state. ``symmetric``, ``relax_potential``
    and ``method="lbfgs"`` are not ported and raise."""
    if symmetric is not None or relax_potential is not None:
        raise NotImplementedError("symmetric slabs and a separate relax_potential "
                                  "are not ported yet")
    if relax is not None:
        fire_cfg, fixed_topo = relax_settings(relax, potential)
    rigid = getattr(potential, "rigid_energy", None) if relax is None else None

    def state_energy(site_state: torch.Tensor) -> StateEnergy:
        pos0 = realize_positions(d, site_state)
        type_idx = realize_type_idx(d, site_state)
        alive = realize_alive(d, site_state)
        counts = element_counts(d, site_state, dtype=pos0.dtype)
        e_bound = energy_threshold(pos0.shape[1])
        bound = torch.full((pos0.shape[0],), e_bound, dtype=pos0.dtype, device=pos0.device)

        if relax is None:
            e_pot = rigid(type_idx, alive) if rigid is not None else potential.energy(
                pos0, type_idx, alive, d.shifts)
            oob = (e_pot.abs() > e_bound) | torch.isnan(e_pot)
            e_pot = torch.where(oob, bound, e_pot)
            pos = pos0
        else:
            pos, e_pot, oob = relax_and_score(potential, fire_cfg, fixed_topo, pos0,
                                              realize_free_mask(d, site_state), type_idx,
                                              alive, bound, d.shifts)
        se = torch.where(oob, bound, surface_energy_fn(e_pot, counts))
        return StateEnergy(surface_energy=se, potential_energy=e_pot, positions=pos, oob=oob)

    return state_energy
