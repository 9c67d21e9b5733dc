"""Host-side structure layer: the slab container, slabs and adsorption sites."""

from surface_sampling_tpu_torch.structure.atoms import Structure
from surface_sampling_tpu_torch.structure.sites import (
    find_adsorption_sites,
    find_surface_symmetry_ops,
    symmetry_reduce_sites,
)
from surface_sampling_tpu_torch.structure.slabs import (
    SupercellSurfaceGenerator,
    bulk,
    diamond111,
    fcc100,
    fcc110,
    fcc111,
    surface_from_bulk,
    symmetrize_slab,
)

__all__ = ["Structure", "SupercellSurfaceGenerator", "bulk", "diamond111", "fcc100", "fcc110",
           "fcc111", "find_adsorption_sites", "find_surface_symmetry_ops", "surface_from_bulk",
           "symmetrize_slab", "symmetry_reduce_sites"]
