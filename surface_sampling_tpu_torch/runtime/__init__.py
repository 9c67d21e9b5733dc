"""Native host runtime (the C++ surfkit library through ctypes, with numpy
versions)."""

from surface_sampling_tpu_torch.runtime.native import (
    cell_list_neighbors,
    load_library,
    min_selected_distance,
    write_xyz_frames,
)

__all__ = [
    "cell_list_neighbors",
    "load_library",
    "min_selected_distance",
    "write_xyz_frames",
]
