"""Surface-hydroxyl energy corrections for Pourbaix formation entries
(host side).

A copy of ``surface_sampling_tpu/pourbaix/utils.py``
(``SurfaceOHCompatibility``): +0.23 eV ZPE-TS (Rong & Kolpak 2015) and
-0.30 eV hydrogen-bond correction per surface OH group, with excess H
attributed to intact water.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SurfaceOHCompatibility:
    zpe_ts_correction: float = 0.23
    hydrogen_bond_correction: float = -0.30

    def n_oh_groups(self, composition: dict[str, float]) -> float:
        """Number of surface OH groups in a composition, after removing
        HO_diff = max(nH - nO, 0) intact waters."""
        n_h = composition.get("H", 0.0)
        n_o = composition.get("O", 0.0)
        ho_diff = max(n_h - n_o, 0.0)
        return min(n_o, n_h) - ho_diff

    def get_adjustment(self, composition: dict[str, float]) -> float:
        """Total energy adjustment (eV) for an entry's composition."""
        if composition.get("H", 0) <= 0 or composition.get("O", 0) <= 0:
            return 0.0
        n = self.n_oh_groups(composition)
        return n * (self.zpe_ts_correction + self.hydrogen_bond_correction)

    def process_entry_energy(self, energy: float, composition: dict[str, float]) -> float:
        return energy + self.get_adjustment(composition)
