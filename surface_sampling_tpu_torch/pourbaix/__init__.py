"""Electrochemical (Pourbaix) sampling support: the dominant aqueous species
of each element at (pH, phi) and the grand potential as the MC acceptance
energy."""

from surface_sampling_tpu_torch.pourbaix.atoms import (
    PourbaixAtom,
    generate_pourbaix_atoms,
    load_pourbaix_atoms,
    save_pourbaix_atoms,
)
from surface_sampling_tpu_torch.pourbaix.entries import (
    PhaseDiagramLite,
    PourbaixDiagramLite,
)
from surface_sampling_tpu_torch.pourbaix.potential import make_pourbaix_surface_energy
from surface_sampling_tpu_torch.pourbaix.utils import SurfaceOHCompatibility

__all__ = [
    "PhaseDiagramLite",
    "PourbaixAtom",
    "PourbaixDiagramLite",
    "SurfaceOHCompatibility",
    "generate_pourbaix_atoms",
    "load_pourbaix_atoms",
    "make_pourbaix_surface_energy",
    "save_pourbaix_atoms",
]
