"""Low-index slabs with exact geometries (host side, numpy).

The counterpart of ``fcc100`` in ``surface_sampling_tpu/structure/slabs.py``:
the Cu(100) slab of the EAM systems.
"""

from __future__ import annotations

import numpy as np

from surface_sampling_tpu_torch.constants import Z_FROM_SYMBOL
from surface_sampling_tpu_torch.structure.atoms import Structure


def fcc100(symbol: str, size: tuple[int, int, int], a: float, vacuum: float = 15.0) -> Structure:
    """fcc(100) slab: size = (nx, ny, nlayers); in-plane lattice a/sqrt(2)."""
    d = a / np.sqrt(2.0)
    nx, ny, nz = size
    pos, nums = [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                off = 0.5 * d if iz % 2 else 0.0
                pos.append([ix * d + off, iy * d + off, iz * a / 2.0])
                nums.append(Z_FROM_SYMBOL[symbol])
    cell = np.diag([nx * d, ny * d, nz * a / 2.0])
    return Structure(np.array(nums), np.array(pos), cell).center_z(vacuum)
