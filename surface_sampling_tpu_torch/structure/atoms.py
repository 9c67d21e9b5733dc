"""Minimal periodic structure container (host side, numpy).

The part of ``surface_sampling_tpu/structure/atoms.py`` that building the
ported systems, loading training data, structure files and the Pourbaix
path use: construction, fractional coordinates, wrapping, tiling, selection,
translation, concatenation, sorting by height, centring in vacuum, layer
tagging, masses, minimum-image distances and the formula. Every axis is
periodic (the JAX class's default ``pbc``); the class keeps no per-atom
``arrays`` or ``info``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from surface_sampling_tpu_torch.constants import (
    ATOMIC_MASSES,
    CHEMICAL_SYMBOLS,
    Z_FROM_SYMBOL,
    formula_from_numbers,
)


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

    @classmethod
    def from_symbols(cls, symbols, positions, cell) -> "Structure":
        return cls([Z_FROM_SYMBOL[s] for s in symbols], positions, cell)

    def __len__(self) -> int:
        return len(self.numbers)

    @property
    def scaled_positions(self) -> np.ndarray:
        """Fractional coordinates (cell-row convention: cart = frac @ cell)."""
        return np.linalg.solve(self.cell.T, self.positions.T).T

    def set_scaled_positions(self, frac: np.ndarray) -> None:
        self.positions = np.asarray(frac) @ self.cell

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.cell)))

    @property
    def symbols(self) -> list[str]:
        return [CHEMICAL_SYMBOLS[z] for z in self.numbers]

    def copy(self) -> "Structure":
        return Structure(self.numbers.copy(), self.positions.copy(), self.cell.copy())

    def wrap(self) -> "Structure":
        """A copy with every atom wrapped into the cell (all three axes
        periodic)."""
        out = self.copy()
        out.set_scaled_positions(self.scaled_positions % 1.0)
        return out

    def repeat(self, reps) -> "Structure":
        """Tile the structure (nx, ny, nz) times; images are ordered with
        the x index slowest."""
        reps = np.asarray(reps, dtype=int)
        shifts = np.array([[i, j, k] for i in range(reps[0]) for j in range(reps[1])
                           for k in range(reps[2])], dtype=np.float64)
        pos = (self.positions[None, :, :] + (shifts @ self.cell)[:, None, :]).reshape(-1, 3)
        return Structure(np.tile(self.numbers, len(shifts)), pos, self.cell * reps[:, None])

    def select(self, mask_or_idx) -> "Structure":
        """The atoms under a boolean mask or at the given indices, in that
        order, in a copy of the cell."""
        idx = np.asarray(mask_or_idx)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        return Structure(self.numbers[idx], self.positions[idx], self.cell.copy())

    def translated(self, vec) -> "Structure":
        return Structure(self.numbers.copy(), self.positions + np.asarray(vec), self.cell.copy())

    def __add__(self, other: "Structure") -> "Structure":
        """The atoms of both, in this structure's cell."""
        return Structure(np.concatenate([self.numbers, other.numbers]),
                         np.concatenate([self.positions, other.positions]), self.cell.copy())

    def sorted_by_z(self) -> "Structure":
        return self.select(np.argsort(self.positions[:, 2], kind="stable"))

    def center_z(self, vacuum: float) -> "Structure":
        """Centre the slab along z with ``vacuum`` Angstrom of padding on
        each side: the c axis becomes (0, 0, height + 2 vacuum)."""
        z = self.positions[:, 2]
        cell = self.cell.copy()
        cell[2] = np.array([0.0, 0.0, z.max() - z.min() + 2.0 * vacuum])
        pos = self.positions.copy()
        pos[:, 2] += vacuum - z.min()
        return Structure(self.numbers.copy(), pos, cell)

    @property
    def formula(self) -> str:
        return formula_from_numbers(self.numbers)

    @property
    def masses(self) -> np.ndarray:
        return ATOMIC_MASSES[self.numbers]

    def all_distances(self, mic: bool = True) -> np.ndarray:
        """(N, N) pairwise distances; with ``mic`` the least over the 27
        nearest periodic images, exact where the cutoff of interest is
        below half the smallest cell height."""
        diff = self.positions[:, None, :] - self.positions[None, :, :]
        if not mic:
            return np.linalg.norm(diff, axis=-1)
        r = (-1, 0, 1)
        shifts = np.array([[i, j, k] for i in r for j in r for k in r], np.float64) @ self.cell
        return np.min(np.linalg.norm(diff[None] + shifts[:, None, None, :], axis=-1), axis=0)

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
