"""Pymatgen-free MaterialsProject2020 + aqueous energy-correction scheme
(host side, numpy).

A copy of ``surface_sampling_tpu/pourbaix/compatibility.py``: the
compatibility pipeline applied to DFT entries before building
surface-Pourbaix diagrams (MaterialsProject2020Compatibility ->
MaterialsProjectAqueousCompatibility -> SurfaceOHCompatibility).

The MP2020 scheme is published constants (Wang, Kingsbury et al.,
"A framework for quantifying uncertainty in DFT energy corrections",
Sci. Rep. 11, 15496 (2021); shipped as MP2020Compatibility.yaml in
pymatgen). Two families:

* **Anion corrections** (eV per anion atom), applied when the element
  acts as the anion (here: the most electronegative element of the
  composition, with oxygen taking precedence — the common case for the
  oxide/hydroxide slabs this pipeline serves). Oxygen's value depends on
  the O-O bonding: oxide / peroxide / superoxide, classified from the
  structure's minimum O-O distance exactly like pymatgen's structure
  path (superoxide < 1.35 A <= peroxide < 1.49 A <= oxide).
* **GGA/GGA+U mixing corrections** (eV per transition-metal atom),
  applied when the composition contains O or F and the calculation used
  the standard MP U values.

The aqueous part (MaterialsProjectAqueousCompatibility) re-references
hydrogen so that the DFT formation energy of water matches the
experimental MU_H2O = -2.4583 eV used throughout the Pourbaix stack:
given the MP fitted O2 and H2O energies (o2_energy=-4.94795546875,
h2o_energy=-5.192751548333333, h2o_adjustments=-0.229 per atom), the
effective H2 reference is E(H2) = E(H2O,raw) - 1/2 E(O2) - MU_H2O
(``AqueousCompatibility.fit_h2_energy``), and every H-containing entry
is shifted by n_H * (h_ref - E(H2)/2) so that formation energies
computed against the raw GGA reference h_ref end up referencing
hydrogen against the fitted H2 — the raw h_ref cancels exactly (see
``AqueousCompatibility.h_correction``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from surface_sampling_tpu_torch.pourbaix.entries import MU_H2O

# --- MP2020 constants (MP2020Compatibility.yaml) ------------------------
# anion corrections, eV per anion atom
MP2020_ANION_CORRECTIONS = {
    "oxide": -0.687,
    "peroxide": -0.465,
    "superoxide": -0.161,
    "S": -0.503,
    "F": -0.462,
    "Cl": -0.614,
    "Br": -0.534,
    "I": -0.379,
    "N": -0.361,
    "Se": -0.472,
    "Sb": -0.192,
    "Te": -0.422,
    "H": -0.179,
}

# GGA/GGA+U mixing corrections, eV per TM atom, for O/F-containing
# compositions computed with the standard MP U values
MP2020_U_CORRECTIONS = {
    "V": -1.700,
    "Cr": -1.999,
    "Mn": -1.668,
    "Fe": -2.256,
    "Co": -1.638,
    "Ni": -2.541,
    "Mo": -3.202,
    "W": -4.438,
}

# the U values those corrections assume (the standard MP set for the
# tabulated metals)
MP_U_VALUES = {
    "V": 3.25, "Cr": 3.7, "Mn": 3.9, "Fe": 5.3, "Co": 3.32, "Ni": 6.2,
    "Mo": 4.38, "W": 6.2,
}

# Pauling electronegativities for anion determination (the elements this
# pipeline can meet; extend as needed)
_EN = {
    "H": 2.20, "Li": 0.98, "Na": 0.93, "K": 0.82, "Rb": 0.82, "Cs": 0.79,
    "Be": 1.57, "Mg": 1.31, "Ca": 1.00, "Sr": 0.95, "Ba": 0.89,
    "Sc": 1.36, "Y": 1.22, "La": 1.10, "Ti": 1.54, "Zr": 1.33, "Hf": 1.30,
    "V": 1.63, "Nb": 1.60, "Ta": 1.50, "Cr": 1.66, "Mo": 2.16, "W": 2.36,
    "Mn": 1.55, "Fe": 1.83, "Co": 1.88, "Ni": 1.91, "Cu": 1.90, "Zn": 1.65,
    "Ru": 2.20, "Rh": 2.28, "Pd": 2.20, "Ag": 1.93, "Ir": 2.20, "Pt": 2.28,
    "Au": 2.54, "Al": 1.61, "Ga": 1.81, "In": 1.78, "Si": 1.90, "Ge": 2.01,
    "Sn": 1.96, "Pb": 2.33, "Sb": 2.05, "Bi": 2.02, "B": 2.04, "C": 2.55,
    "N": 3.04, "P": 2.19, "As": 2.18, "O": 3.44, "S": 2.58, "Se": 2.55,
    "Te": 2.10, "F": 3.98, "Cl": 3.16, "Br": 2.96, "I": 2.66,
}

# the O2 / H2O fit inputs of the aqueous correction
O2_DFT_ENERGY = -4.94795546875          # eV/atom, before entropy correction
H2O_DFT_ENERGY = -5.192751548333333     # eV/atom, before entropy correction
H2O_ADJUSTMENTS = -0.229                # eV/atom, already inside the H2O energy


def classify_oxide(structure=None, composition: dict | None = None) -> str:
    """oxide | peroxide | superoxide, from the minimum O-O distance
    (pymatgen's structure-based classification: superoxide < 1.35 A,
    peroxide < 1.49 A). Composition-only fallback: oxide."""
    if structure is None:
        return "oxide"
    numbers = np.asarray(structure.numbers)
    o_idx = np.flatnonzero(numbers == 8)
    if len(o_idx) < 2:
        return "oxide"
    d = structure.all_distances(mic=True)[np.ix_(o_idx, o_idx)]
    np.fill_diagonal(d, np.inf)
    dmin = float(d.min())
    if dmin < 1.35:
        return "superoxide"
    if dmin < 1.49:
        return "peroxide"
    return "oxide"


@dataclass
class MP2020Compatibility:
    """Anion + GGA/GGA+U mixing corrections as explicit tables.

    ``get_adjustments`` returns labeled terms; ``process_entry_energy``
    applies their sum. ``hubbards``: the U values the energies were
    computed with — U corrections only apply when they match the MP set
    (pymatgen's is_hubbard / hubbards check)."""

    anion_corrections: dict = field(default_factory=lambda: dict(MP2020_ANION_CORRECTIONS))
    u_corrections: dict = field(default_factory=lambda: dict(MP2020_U_CORRECTIONS))
    check_hubbards: bool = True

    def _anion(self, composition: dict) -> str | None:
        """The element acting as anion: oxygen when present, else the most
        electronegative non-metal with a tabulated correction."""
        if composition.get("O", 0) > 0:
            return "O"
        cands = [e for e in composition
                 if e in self.anion_corrections and composition[e] > 0]
        if not cands:
            return None
        # only the most electronegative element of the WHOLE composition
        # acts as the anion
        top = max(composition, key=lambda e: _EN.get(e, 0.0))
        best = max(cands, key=lambda e: _EN.get(e, 0.0))
        return best if best == top else None

    def get_adjustments(self, composition: dict, structure=None,
                        hubbards: dict | None = None) -> list[tuple[str, float]]:
        adj: list[tuple[str, float]] = []
        anion = self._anion(composition)
        if anion == "O":
            kind = classify_oxide(structure, composition)
            adj.append((f"MP2020 anion ({kind})",
                        self.anion_corrections[kind] * composition["O"]))
        elif anion is not None:
            adj.append((f"MP2020 anion ({anion})",
                        self.anion_corrections[anion] * composition[anion]))
        if composition.get("O", 0) > 0 or composition.get("F", 0) > 0:
            for el, corr in self.u_corrections.items():
                n = composition.get(el, 0)
                if n <= 0:
                    continue
                if self.check_hubbards and hubbards is not None:
                    if abs(hubbards.get(el, 0.0) - MP_U_VALUES[el]) > 0.05:
                        continue   # computed without the standard U: no mixing term
                adj.append((f"MP2020 GGA+U ({el})", corr * n))
        return adj

    def process_entry_energy(self, energy: float, composition: dict,
                             structure=None, hubbards: dict | None = None) -> float:
        return energy + sum(v for _, v in
                            self.get_adjustments(composition, structure, hubbards))


@dataclass
class AqueousCompatibility:
    """MaterialsProjectAqueousCompatibility re-design: fit the H2
    reference so DFT water formation matches the experimental
    MU_H2O = -2.4583 eV, then shift H-containing entries onto that scale.

    fit_h2_energy: E(H2O)_corrected - 1/2 E(O2) - MU_H2O per molecule
    (H2 + 1/2 O2 -> H2O). With the default inputs this gives the
    hydrogen scale every aqueous/Pourbaix energy in this package uses.
    """

    o2_energy: float = O2_DFT_ENERGY            # eV/atom
    h2o_energy: float = H2O_DFT_ENERGY          # eV/atom
    h2o_adjustments: float = H2O_ADJUSTMENTS    # eV/atom, already applied

    @property
    def fit_h2_energy(self) -> float:
        e_h2o = 3.0 * (self.h2o_energy - self.h2o_adjustments)   # raw molecule
        e_half_o2 = self.o2_energy                               # 1/2 * 2 atoms
        return e_h2o - e_half_o2 - MU_H2O

    def h_correction(self, h_ref: float) -> float:
        """Per-H entry adjustment that substitutes the fitted aqueous H2
        reference for a raw GGA hydrogen reference ``h_ref`` (eV/atom) in
        downstream formation energies.

        Formation energies computed as E_corrected - sum_el n_el*ref_el
        (with the RAW ``h_ref`` still in the reference table) then equal
        E - sum_{el != H} n_el*ref_el - n_H * (fit_h2/2), i.e. hydrogen is
        referenced against the fitted H2 — the net effect of pymatgen's
        MaterialsProjectAqueousCompatibility, which corrects the H2/H2O
        entries so the element reference itself moves:

            E' = E + n_H * (h_ref - fit_h2/2)
            E' - n_H*h_ref = E - n_H * fit_h2/2        (raw h_ref cancels)
        """
        return h_ref - 0.5 * self.fit_h2_energy

    def process_entry_energy(self, energy: float, composition: dict,
                             h_ref: float) -> float:
        n_h = composition.get("H", 0)
        return energy + n_h * self.h_correction(h_ref) if n_h > 0 else energy
