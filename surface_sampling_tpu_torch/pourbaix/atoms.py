"""PourbaixAtom: per-element dominant aqueous species at (pH, phi) (host
side).

A copy of ``surface_sampling_tpu/pourbaix/atoms.py``, whose JSON files
either package reads. The two-step dissolution scheme (Rong & Kolpak,
J. Phys. Chem. Lett. 2015):

  step 1:  slab -> slab' + A            (energy from the NN / potential)
  step 2:  A + n H2O -> HxAOy^(z-) + n_H H+ + n_e e-

Each element gets (dominant_species, conc, n_e, n_H, standard-state atom
energy from the phase diagram, delta_G2_std from the Pourbaix entry).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path

from surface_sampling_tpu_torch.pourbaix.entries import (
    MU_H2O,
    MultiEntryLite,
    PhaseDiagramLite,
    PourbaixDiagramLite,
)


@dataclass
class PourbaixAtom:
    """Dominant-species data for one element."""

    symbol: str
    dominant_species: str
    species_conc: float = 1e-6
    num_e: float = 0.0
    num_H: float = 0.0
    atom_std_state_energy: float = 0.0
    delta_G2_std: float = 0.0

    def as_dict(self) -> dict:
        return {"@class": "PourbaixAtom", **asdict(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "PourbaixAtom":
        return cls(**{k: v for k, v in d.items() if not k.startswith("@")})

    def __repr__(self):
        return (
            f"PourbaixAtom('{self.symbol}' species={self.dominant_species}, "
            f"num_e={self.num_e}, num_H={self.num_H}, "
            f"atom_std_state_energy={self.atom_std_state_energy:.3f}, "
            f"delta_G2_std={self.delta_G2_std:.3f})"
        )


def _atom_from_entry(symbol: str, entry, pd: PhaseDiagramLite) -> PourbaixAtom:
    """A PourbaixAtom from a Pourbaix entry:
    num_e = -normalized nPhi, num_H = -normalized npH,
    delta_G2_std = (energy - conc_term) * normalization."""
    nf = entry.normalization_factor
    return PourbaixAtom(
        symbol=symbol,
        dominant_species=entry.reduced_species,
        species_conc=entry.concentration,
        num_e=round(-entry.nPhi * nf, 10),
        num_H=round(-entry.npH * nf, 10),
        atom_std_state_energy=pd.get_reference_energy_per_atom(symbol),
        delta_G2_std=(entry.energy - entry.conc_term) * nf,
    )


def generate_pourbaix_atoms(
    phase_diagram: PhaseDiagramLite | dict | str | Path,
    pourbaix_diagram: PourbaixDiagramLite | dict | str | Path,
    phi: float,
    pH: float,
    elements: list[str] | tuple[str, ...],
) -> dict[str, PourbaixAtom]:
    """Per-element dominant species at (pH, phi) + synthesized H2O/H+ atoms."""
    if not isinstance(phase_diagram, PhaseDiagramLite):
        phase_diagram = PhaseDiagramLite.from_mson(phase_diagram)
    if not isinstance(pourbaix_diagram, PourbaixDiagramLite):
        pourbaix_diagram = PourbaixDiagramLite.from_mson(pourbaix_diagram)

    stable = pourbaix_diagram.get_stable_entry(pH, phi)
    if isinstance(stable, MultiEntryLite):
        pbx_entries = sorted(stable.entry_list, key=lambda e: e.non_ho_elements[0])
    else:
        pbx_entries = [stable]
    symbols = sorted(set(elements) - {"H", "O"})

    out = {
        sym: _atom_from_entry(sym, entry, phase_diagram)
        for sym, entry in zip(symbols, pbx_entries)
    }

    # O as H2O: O(ads) + 2 H+ + 2 e- -> H2O ; delta_G2_std = E_f(H2O)
    h2o = phase_diagram.lowest_entry_of("H2O")
    e_f_h2o = phase_diagram.get_form_energy(h2o) / h2o.composition["O"]
    out["O"] = PourbaixAtom(
        symbol="O",
        dominant_species="H2O",
        species_conc=1.0,
        num_e=-2.0,
        num_H=-2.0,
        atom_std_state_energy=phase_diagram.get_reference_energy_per_atom("O"),
        delta_G2_std=e_f_h2o,
    )
    # H as H+: H(ads) -> H+ + e- ; delta_G2_std = 0 by SHE convention
    out["H"] = PourbaixAtom(
        symbol="H",
        dominant_species="H[+1]",
        species_conc=1.0,
        num_e=1.0,
        num_H=1.0,
        atom_std_state_energy=phase_diagram.get_reference_energy_per_atom("H"),
        delta_G2_std=0.0,
    )
    return out


def save_pourbaix_atoms(path: str | Path, atoms: dict[str, PourbaixAtom]) -> None:
    Path(path).write_text(json.dumps({k: v.as_dict() for k, v in atoms.items()}, indent=1))


def load_pourbaix_atoms(path: str | Path) -> dict[str, PourbaixAtom]:
    d = json.loads(Path(path).read_text())
    return {k: PourbaixAtom.from_dict(v) for k, v in d.items()}
