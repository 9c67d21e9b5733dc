"""The two surface energies of the configurations, and the engine's
out-of-bounds clamp.

Both are E_pot - sum_e coeff_e n_e over the atoms of each element:

* chemical potentials alone: coeff_e = mu_e;
* bulk-referenced offsets (the SrTiO3 campaigns): with s the Hartree to eV
  factor of an offset table in atomic units,
      coeff_e   = s E_bulk[e] + mu_e                       (e != ref)
      coeff_ref = s E_bulk[ref formula] - sum_{e != ref} (n_e / n_ref) coeff_e
  where n_e are the formula's stoichiometries.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import energy_bound

HARTREE_TO_EV = 27.211386245988
Z_OF = {"H": 1, "O": 8, "Ti": 22, "Mn": 25, "Sr": 38, "La": 57}


def chem_pot_coefficients(chem_pots: dict) -> dict:
    """{Z: coeff} of the plain chemical-potential surface energy."""
    return {Z_OF[sym]: float(mu) for sym, mu in chem_pots.items()}


def offset_coefficients(chem_pots: dict, offset: dict, atomic_units: bool = True) -> dict:
    """{Z: coeff} of the bulk-referenced surface energy."""
    scale = HARTREE_TO_EV if atomic_units else 1.0
    bulk, stoics, ref = offset["bulk_energies"], offset["stoics"], offset["ref_element"]
    coeff = {}
    ref_coeff = scale * bulk[offset["ref_formula"]]
    for sym in set(chem_pots) | set(stoics):
        if sym == ref:
            continue
        coeff[Z_OF[sym]] = scale * bulk.get(sym, 0.0) + chem_pots.get(sym, 0.0)
        ref_coeff -= stoics.get(sym, 0.0) / stoics[ref] * coeff[Z_OF[sym]]
    coeff[Z_OF[ref]] = ref_coeff
    return coeff


def surface_energy(e_pot: torch.Tensor, numbers: torch.Tensor, coeff: dict) -> torch.Tensor:
    """(C,) float64 surface energies of (C,) potential energies and (C, N)
    atomic numbers, clamped as the engine clamps: a NaN or a potential energy
    beyond 1000 eV + 20 eV per slot gives that bound."""
    bound = energy_bound(numbers.shape[1])
    se = e_pot.double()
    for z, c in coeff.items():
        se = se - c * (numbers == z).sum(dim=1).double()
    oob = (e_pot.abs() > bound) | torch.isnan(e_pot)
    return torch.where(oob, torch.full_like(se, bound), se)
