"""Host-side structure layer: the slab container and adsorption sites."""

from surface_sampling_tpu_torch.structure.atoms import Structure
from surface_sampling_tpu_torch.structure.sites import find_adsorption_sites

__all__ = ["Structure", "find_adsorption_sites"]
