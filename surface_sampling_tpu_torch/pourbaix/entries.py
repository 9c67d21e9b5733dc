"""Minimal phase-diagram / Pourbaix-diagram machinery (host side, numpy).

A copy of ``surface_sampling_tpu/pourbaix/entries.py``: the pieces of a
phase diagram and a Pourbaix diagram that find, at a given (pH, phi), the
dominant aqueous or solid species of each element, read from the MSON JSON
dicts of serialized diagrams (``tests/data/pourbaix/pd_dict.json``,
``pbx_dict.json``), with pymatgen's conventions:

    PREFAC  = 0.0591 eV/pH (k_B T ln 10 at 298 K)
    MU_H2O  = -2.4583 eV (formation free energy of water)
    npH     = n_H - 2 n_O
    nH2O    = n_O
    nPhi    = npH - charge
    E       = E_raw + PREFAC log10(conc) - MU_H2O nH2O
    E(pH,V) = E + npH PREFAC pH + nPhi V
    normalization = 1 / (atoms not H or O)

Multi-element stability uses pymatgen's MultiEntry scheme: weighted
combinations of entries whose non-HO composition reproduces comp_dict,
minimizing the composition-normalized energy at conditions.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

PREFAC = 0.0591
MU_H2O = -2.4583
ELEMENTS_HO = {"H", "O"}


# ----------------------------------------------------------------------
# Phase diagram (elemental references + formation energies)
# ----------------------------------------------------------------------
@dataclass
class CompEntry:
    composition: dict[str, float]
    energy: float            # corrected total energy (eV)

    @property
    def natoms(self) -> float:
        return sum(self.composition.values())

    @property
    def energy_per_atom(self) -> float:
        return self.energy / self.natoms

    @property
    def reduced_formula(self) -> str:
        from math import gcd

        counts = {k: int(round(v)) for k, v in self.composition.items()}
        g = 0
        for v in counts.values():
            g = gcd(g, v)
        g = max(g, 1)
        items = sorted(counts.items())
        return "".join(f"{k}{v // g if v // g > 1 else ''}" for k, v in items if v > 0)


@dataclass
class PhaseDiagramLite:
    """Elemental reference energies + formation energies from a pymatgen
    PhaseDiagram MSON dict."""

    entries: list[CompEntry]
    el_refs: dict[str, float] = field(init=False)

    def __post_init__(self):
        refs: dict[str, float] = {}
        for e in self.entries:
            els = [el for el, n in e.composition.items() if n > 0]
            if len(els) == 1:
                el = els[0]
                epa = e.energy_per_atom
                if el not in refs or epa < refs[el]:
                    refs[el] = epa
        self.el_refs = refs

    @classmethod
    def from_mson(cls, d: dict | str | Path) -> "PhaseDiagramLite":
        if not isinstance(d, dict):
            d = json.loads(Path(d).read_text())
        entries = []
        for ent in d["all_entries"]:
            comp = {k: float(v) for k, v in ent["composition"].items()}
            energy = float(ent["energy"]) + float(ent.get("correction", 0.0))
            entries.append(CompEntry(comp, energy))
        return cls(entries)

    def get_reference_energy_per_atom(self, element: str) -> float:
        """pymatgen PhaseDiagram.get_reference_energy_per_atom analog."""
        return self.el_refs[element]

    def get_form_energy(self, entry: CompEntry) -> float:
        """Total formation energy relative to elemental references."""
        return entry.energy - sum(
            n * self.el_refs[el] for el, n in entry.composition.items() if n > 0
        )

    def lowest_entry_of(self, reduced_formula: str) -> CompEntry:
        cands = [e for e in self.entries if e.reduced_formula == reduced_formula]
        if not cands:
            raise KeyError(f"no entry with formula {reduced_formula}")
        return min(cands, key=lambda e: e.energy_per_atom)


# ----------------------------------------------------------------------
# Pourbaix entries and diagram
# ----------------------------------------------------------------------
@dataclass
class PourbaixEntryLite:
    composition: dict[str, float]     # includes H and O
    raw_energy: float                 # formation energy as serialized
    charge: float = 0.0
    concentration: float = 1.0
    entry_type: str = "Solid"
    name: str | None = None

    @property
    def npH(self) -> float:
        return self.composition.get("H", 0.0) - 2 * self.composition.get("O", 0.0)

    @property
    def nH2O(self) -> float:
        return self.composition.get("O", 0.0)

    @property
    def nPhi(self) -> float:
        return self.npH - self.charge

    @property
    def conc_term(self) -> float:
        return PREFAC * np.log10(self.concentration)

    @property
    def energy(self) -> float:
        return self.raw_energy + self.conc_term - MU_H2O * self.nH2O

    @property
    def normalization_factor(self) -> float:
        n = sum(v for k, v in self.composition.items() if k not in ELEMENTS_HO)
        return 1.0 / n if n else 1.0

    def energy_at_conditions(self, pH: float, V: float) -> float:
        return self.energy + self.npH * PREFAC * pH + self.nPhi * V

    @property
    def reduced_species(self) -> str:
        """Display name: ion name (e.g. 'Sr[+2]') or solid reduced formula."""
        if self.name:
            return self.name
        counts = {k: v for k, v in self.composition.items() if v > 0}
        return CompEntry(counts, 0.0).reduced_formula

    @property
    def non_ho_elements(self) -> tuple[str, ...]:
        return tuple(sorted(k for k, v in self.composition.items()
                            if v > 0 and k not in ELEMENTS_HO))


@dataclass
class MultiEntryLite:
    entries: list[PourbaixEntryLite]
    weights: list[float]

    def energy_at_conditions(self, pH: float, V: float) -> float:
        return sum(w * e.energy_at_conditions(pH, V) for w, e in zip(self.weights, self.entries))

    @property
    def normalization_factor(self) -> float:
        n = sum(
            w * sum(v for k, v in e.composition.items() if k not in ELEMENTS_HO)
            for w, e in zip(self.weights, self.entries)
        )
        return 1.0 / n if n else 1.0

    def normalized_energy_at_conditions(self, pH: float, V: float) -> float:
        return self.energy_at_conditions(pH, V) * self.normalization_factor

    @property
    def entry_list(self) -> list[PourbaixEntryLite]:
        return self.entries


@dataclass
class PourbaixDiagramLite:
    entries: list[PourbaixEntryLite]
    comp_dict: dict[str, float]

    @classmethod
    def from_mson(cls, d: dict | str | Path) -> "PourbaixDiagramLite":
        if not isinstance(d, dict):
            d = json.loads(Path(d).read_text())
        entries = []
        for e in d["entries"]:
            ent = e["entry"]
            if e["entry_type"] == "Ion":
                ion = dict(ent["ion"])
                charge = float(ion.pop("charge", 0.0))
                entries.append(
                    PourbaixEntryLite(
                        composition=ion,
                        raw_energy=float(ent["energy"]),
                        charge=charge,
                        concentration=float(e.get("concentration", 1e-6)),
                        entry_type="Ion",
                        name=ent.get("name"),
                    )
                )
            else:
                comp = {k: float(v) for k, v in ent["composition"].items()}
                energy = float(ent["energy"]) + float(ent.get("correction", 0.0))
                entries.append(
                    PourbaixEntryLite(
                        composition=comp,
                        raw_energy=energy,
                        charge=0.0,
                        concentration=float(e.get("concentration", 1.0)),
                        entry_type="Solid",
                    )
                )
        comp_dict = {k: float(v) for k, v in (d.get("comp_dict") or {}).items()}
        if not comp_dict:
            els = sorted({el for e in entries for el in e.non_ho_elements})
            comp_dict = {el: 1.0 / len(els) for el in els}
        return cls(entries, comp_dict)

    def _multi_entries(self) -> list[MultiEntryLite]:
        """All weighted entry combinations reproducing comp_dict
        (pymatgen _generate_multielement_entries analog)."""
        elements = sorted(self.comp_dict)
        target = np.array([self.comp_dict[el] for el in elements])
        out: list[MultiEntryLite] = []
        for size in range(1, len(elements) + 1):
            for combo in itertools.combinations(self.entries, size):
                # element content matrix (n_elements x size)
                A = np.array(
                    [[e.composition.get(el, 0.0) for e in combo] for el in elements]
                )
                if np.any(A.sum(axis=0) == 0):
                    continue  # an entry with no target elements
                w, res, rank, _ = np.linalg.lstsq(A, target, rcond=None)
                if rank < len(combo):
                    continue
                if np.any(w < 1e-9):
                    continue
                if np.linalg.norm(A @ w - target) > 1e-8:
                    continue
                out.append(MultiEntryLite(list(combo), w.tolist()))
        return out

    def get_stable_entry(self, pH: float, V: float):
        """Dominant entry at (pH, V): pymatgen get_stable_entry analog.
        Returns a PourbaixEntryLite (single element) or MultiEntryLite."""
        if len(self.comp_dict) == 1:
            cands = [e for e in self.entries if e.non_ho_elements]
            return min(
                cands,
                key=lambda e: e.energy_at_conditions(pH, V) * e.normalization_factor,
            )
        multis = self._multi_entries()
        if not multis:
            raise RuntimeError("no multi-entry combination matches comp_dict")
        return min(multis, key=lambda m: m.normalized_energy_at_conditions(pH, V))
