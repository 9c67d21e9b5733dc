"""Minimal periodic structure container (host side, numpy).

The part of ``surface_sampling_tpu/structure/atoms.py`` that building the
flagship spec uses: construction, layer tagging and the formula.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from surface_sampling_tpu_torch.constants import formula_from_numbers


@dataclass
class Structure:
    """A periodic atomic structure.

    Attributes:
        numbers: (N,) int atomic numbers.
        positions: (N, 3) float cartesian coordinates in Angstrom.
        cell: (3, 3) float lattice vectors as rows (periodic in x and y;
            the slab's vacuum axis is z).
    """

    numbers: np.ndarray
    positions: np.ndarray
    cell: np.ndarray

    def __post_init__(self):
        self.numbers = np.asarray(self.numbers, dtype=np.int32)
        self.positions = np.asarray(self.positions, dtype=np.float64).reshape(-1, 3)
        self.cell = np.asarray(self.cell, dtype=np.float64).reshape(3, 3)

    def __len__(self) -> int:
        return len(self.numbers)

    @property
    def formula(self) -> str:
        return formula_from_numbers(self.numbers)

    def get_layers(self, tol: float = 0.1) -> np.ndarray:
        """Tag atoms by unique z-layers: 1 = topmost, increasing downward."""
        z = self.positions[:, 2]
        order = np.argsort(-z)
        tags = np.zeros(len(z), dtype=np.int32)
        layer = 0
        last = None
        for i in order:
            if last is None or (last - z[i]) > tol:
                layer += 1
                last = z[i]
            tags[i] = layer
        return tags
