"""Host-side structure layer: the slab container, slabs and adsorption sites."""

from surface_sampling_tpu_torch.structure.atoms import Structure
from surface_sampling_tpu_torch.structure.sites import find_adsorption_sites
from surface_sampling_tpu_torch.structure.slabs import fcc100

__all__ = ["Structure", "fcc100", "find_adsorption_sites"]
