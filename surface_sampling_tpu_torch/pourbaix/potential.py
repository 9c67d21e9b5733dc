"""The electrochemical (Pourbaix) grand potential as the MC acceptance
energy, batched over chains.

The counterpart of ``surface_sampling_tpu/pourbaix/potential.py``:

    Phi(pH, phi) = E_slab + corrections(counts)
                   - sum_e n_e [ mu_std_e
                                + dG2_std_e - num_e_e*phi
                                - ln(10)*num_H_e*kT*pH + kT*ln(conc_e) ]

linear in the per-element counts but for the adsorbate-correction terms
(an integer number of formula units, floored). The coefficients are built
in host float64 and rounded to float32 once, as the JAX package does,
before the product with the counts, which runs as the JAX package's f32
dot product does on the CPU: a chain of fused multiply-adds over the
elements in slot order, each rounded to f32 once. Surface energies of a few
hundred eV carry f32 spacings of 3e-5 eV, so a sum in another order shows.
"""

from __future__ import annotations

from functools import reduce
from typing import Callable

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import SYMBOL_FROM_Z, Z_FROM_SYMBOL, parse_formula
from surface_sampling_tpu_torch.core.spec import SurfaceSpec
from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.pourbaix.atoms import PourbaixAtom


def make_pourbaix_surface_energy(
    spec: SurfaceSpec,
    pourbaix_atoms: dict[str, PourbaixAtom],
    phi: float,
    pH: float,
    temp: float = 0.0257,
    adsorbate_corrections: dict[str, float] | None = None,
    device: torch.device | str = "cuda",
) -> Callable:
    """Build ``surface_energy(e_pot (C,), counts (C, E)) -> (C,)`` for the
    MC engine.

    Args:
        pourbaix_atoms: per-element PourbaixAtom table (``pourbaix/atoms.py``).
        phi: electrode potential vs SHE (V).
        pH: pH.
        temp: k_B T in eV.
        adsorbate_corrections: per-group free-energy corrections, e.g.
            {"OH": 0.23}: each whole formula unit the counts hold adds its
            correction; for a group of O and H, the H beyond the O count is
            taken as intact water first (HO_diff = max(n_H - n_O, 0) waters
            removed). A formula of one or two elements.
        device: where the coefficients live (the counts' device).
    """
    coeff = np.zeros(len(spec.element_zs))
    for i, z in enumerate(spec.element_zs):
        sym = SYMBOL_FROM_Z[int(z)]
        atom = pourbaix_atoms.get(sym)
        if atom is None:
            raise KeyError(f"no PourbaixAtom for element {sym}")
        g2 = (atom.delta_G2_std - atom.num_e * phi - np.log(10.0) * atom.num_H * temp * pH
              + temp * np.log(atom.species_conc))
        coeff[i] = atom.atom_std_state_energy + g2
    coeff_t = torch.as_tensor(coeff, dtype=torch.float32, device=resolve_device(device))

    slot_of = {SYMBOL_FROM_Z[int(z)]: slot for slot, z in enumerate(spec.element_zs)}
    corrections = []
    for formula, corr in (adsorbate_corrections or {}).items():
        counts_f = parse_formula(formula)
        if len(counts_f) > 2:
            raise ValueError(f"adsorbate correction {formula!r}: a formula of one or two "
                             "elements")
        corrections.append((counts_f, float(np.float32(corr))))
    h_slot, o_slot = slot_of.get("H"), slot_of.get("O")

    def surface_energy(e_pot, counts):
        se = e_pot - _fma_dot(counts, coeff_t)
        if not corrections:
            return se
        zero = counts.new_zeros(counts.shape[0])
        n_h = counts[:, h_slot] if h_slot is not None else zero
        n_o = counts[:, o_slot] if o_slot is not None else zero
        for counts_f, corr in corrections:
            if "O" in counts_f and "H" in counts_f:
                ho_diff = torch.clamp(n_h - n_o, min=0.0)
                eff = {"H": n_h - 2 * ho_diff, "O": n_o - ho_diff}
            else:
                eff = {"H": n_h, "O": n_o}
            ratios = []
            for sym, n_in_f in counts_f.items():
                avail = eff.get(sym)
                if avail is None:
                    avail = counts[:, int(spec.z_to_element[Z_FROM_SYMBOL[sym]])]
                ratios.append(avail / n_in_f)
            div = torch.clamp(torch.floor(reduce(torch.minimum, ratios) + 1e-6), min=0.0)
            # se + div * corr in one rounding, as XLA fuses it
            se = (se.double() + div.double() * corr).to(se.dtype)
        return se

    return surface_energy


def _fma_dot(counts: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """(C, E) counts . (E,) coefficients as a chain of fused multiply-adds
    over E in order, each step rounded once to the counts' dtype. A step is
    exact in float64 (counts are whole numbers, the coefficients f32), so
    rounding its f64 value is the fused operation's one rounding."""
    acc = counts.new_zeros(counts.shape[0])
    c64 = coeff.double()
    for k in range(counts.shape[1]):
        acc = (acc.double() + counts[:, k].double() * c64[k]).to(counts.dtype)
    return acc
