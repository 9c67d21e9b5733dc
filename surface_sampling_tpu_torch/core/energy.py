"""Surface-energy models and the per-move state evaluation, batched over
chains.

The counterpart of ``surface_sampling_tpu/core/energy.py`` without the
relaxation branch: a surface-energy model maps (potential energy,
per-element counts) to the acceptance energy, and
``make_state_energy_fn`` assembles the rigid evaluation every MC step
runs: realize the occupancy, score it, clamp out-of-bounds energies.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import HARTREE_TO_EV, Z_FROM_SYMBOL
from surface_sampling_tpu_torch.core.spec import SurfaceSpec
from surface_sampling_tpu_torch.core.state import (
    DeviceSpec,
    element_counts,
    realize_alive,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.device import resolve_device

ENERGY_THRESHOLD = 1000.0           # eV, absolute out-of-bounds bound
ENERGY_THRESHOLD_PER_ATOM = 20.0    # eV/atom added to it, so large slabs'
                                    # legitimate cohesive energies stay in bounds


def energy_threshold(n_atoms) -> float:
    """Size-aware OOB energy bound: 1000 eV + 20 eV/atom."""
    return ENERGY_THRESHOLD + ENERGY_THRESHOLD_PER_ATOM * n_atoms


def identity_surface_energy(e_pot, counts):
    """Surface energy == potential energy."""
    return e_pot


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


class StateEnergy(NamedTuple):
    surface_energy: torch.Tensor    # (C,) acceptance energy (OOB-clamped)
    potential_energy: torch.Tensor  # (C,)
    positions: torch.Tensor         # (C, N, 3) ideal slot geometry
    oob: torch.Tensor               # (C,) bool


def make_state_energy_fn(
    d: DeviceSpec,
    potential,
    surface_energy_fn: Callable = identity_surface_energy,
) -> Callable:
    """Build ``fn(site_state (C, S)) -> StateEnergy``, the evaluation of
    every MC step on a rigid lattice. ``potential`` must expose
    ``rigid_energy(type_idx, alive)`` (``models/nn_calculator.py``).

    A NaN or an energy beyond ``energy_threshold(N)`` is out of bounds:
    both the potential and the surface energy are clamped to the bound, so
    the Metropolis test rejects the state."""
    if not hasattr(potential, "rigid_energy"):
        raise NotImplementedError("only rigid-lattice potentials are ported")

    def state_energy(site_state: torch.Tensor) -> StateEnergy:
        pos = realize_positions(d, site_state)
        type_idx = realize_type_idx(d, site_state)
        alive = realize_alive(d, site_state)
        counts = element_counts(d, site_state, dtype=pos.dtype)
        e_bound = energy_threshold(pos.shape[1])
        e_pot = potential.rigid_energy(type_idx, alive)
        oob = (e_pot.abs() > e_bound) | torch.isnan(e_pot)
        bound = torch.full_like(e_pot, e_bound)
        e_pot = torch.where(oob, bound, e_pot)
        se = torch.where(oob, bound, surface_energy_fn(e_pot, counts))
        return StateEnergy(surface_energy=se, potential_energy=e_pot, positions=pos, oob=oob)

    return state_energy
