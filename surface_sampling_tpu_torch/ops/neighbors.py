"""Periodic image shifts for a cutoff (host side, numpy).

The numpy ``pair_shifts`` and ``pair_shifts_for`` of
``surface_sampling_tpu/ops/neighbors.py``; the spec and the static
candidate table use them once, when a system is built.
"""

from __future__ import annotations

import numpy as np


def pair_shifts(
    cell: np.ndarray,
    cutoff: float,
    frac_span: np.ndarray | None = None,
    pbc=(True, True, True),
) -> np.ndarray:
    """Statically choose the periodic image shifts that can host a pair.

    A shift n = (n1, n2, n3) is kept if the geometric lower bound on the
    distance between any home-cell atom and any atom in the n-shifted image
    is below ``cutoff``. ``frac_span`` (per-axis fractional extent actually
    occupied by atoms, e.g. small along z for a vacuum slab) tightens the
    bound so slabs don't pay for z images.

    The zero shift is always first in the returned (K, 3) cartesian array.
    """
    cell = np.asarray(cell, dtype=np.float64)
    if frac_span is None:
        frac_span = np.ones(3)
    frac_span = np.clip(np.asarray(frac_span, dtype=np.float64), 0.0, 1.0)
    # cell heights: distance between opposite faces
    vol = abs(np.linalg.det(cell))
    heights = np.array(
        [vol / np.linalg.norm(np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3])) for i in range(3)]
    )
    nmax = [int(np.ceil(cutoff / heights[i])) + 1 if pbc[i] else 0 for i in range(3)]
    shifts = [(0, 0, 0)]
    for n1 in range(-nmax[0], nmax[0] + 1):
        for n2 in range(-nmax[1], nmax[1] + 1):
            for n3 in range(-nmax[2], nmax[2] + 1):
                n = (n1, n2, n3)
                if n == (0, 0, 0):
                    continue
                gap = [max(0.0, (abs(n[i]) - frac_span[i]) * heights[i]) for i in range(3)]
                if np.linalg.norm(gap) < cutoff:
                    shifts.append(n)
    return np.array(shifts, dtype=np.float64) @ cell


def pair_shifts_for(
    cell: np.ndarray,
    frac_coords: np.ndarray,
    cutoff: float,
    pbc=(True, True, True),
    span_pad: float = 2.0,
) -> np.ndarray:
    """:func:`pair_shifts` with the occupied fractional span measured from
    actual coordinates, padded by ``span_pad`` Angstrom per axis."""
    cell = np.asarray(cell, dtype=np.float64)
    frac = np.asarray(frac_coords, dtype=np.float64)
    frac = frac - np.floor(frac)
    heights = np.array([np.linalg.norm(cell[i]) for i in range(3)])
    span = frac.max(axis=0) - frac.min(axis=0) + span_pad / np.maximum(heights, 1e-9)
    return pair_shifts(cell, cutoff, frac_span=span, pbc=pbc)
