"""Static candidate-pair neighbor tables (host side, numpy).

Every slot's position is one of a handful of known candidates (site
coordinate + per-code offsets), displaced at most ``relax_slack`` by
relaxation, so the slot pairs that can ever interact are known when the
spec is built. The counterpart of
``surface_sampling_tpu/core/static_neighbors.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from surface_sampling_tpu_torch.core.spec import SurfaceSpec
from surface_sampling_tpu_torch.ops.neighbors import pair_shifts


class StaticNeighborTable(NamedTuple):
    """Host-side padded candidate table."""

    slot_j: np.ndarray      # (N, M) int32 — candidate neighbor slot
    shift: np.ndarray       # (N, M, 3) float — periodic image shift of j
    valid: np.ndarray       # (N, M) bool — padding mask
    max_candidates: int


def build_static_neighbor_table(
    spec: SurfaceSpec, cutoff: float, relax_slack: float = 0.5
) -> StaticNeighborTable:
    """Enumerate all slot pairs whose minimum possible distance is below
    cutoff + 2*relax_slack, over all periodic images; candidates of each
    slot are sorted nearest-template-first, so the rank-select compaction
    keeps the nearest ones if a state ever overflows."""
    P, S, G = spec.n_pristine, spec.n_sites, spec.group_size
    N = P + S * G
    centers = np.zeros((N, 3))
    reach = np.zeros(N)
    centers[:P] = spec.pristine_positions
    for s in range(S):
        for g in range(G):
            slot = P + s * G + g
            centers[slot] = spec.site_coords[s]
            offs = spec.code_offsets[:, g, :]
            reach[slot] = np.linalg.norm(offs, axis=1).max()
    margin = cutoff + 2.0 * relax_slack
    shifts = pair_shifts(spec.cell, margin + reach.max() * 2, frac_span=None)
    cand: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(N)]
    for shift in shifts:
        d = np.linalg.norm(
            centers[:, None, :] - (centers[None, :, :] + shift[None, None, :]), axis=-1
        )
        dmin = d - reach[:, None] - reach[None, :]
        is_zero_shift = np.allclose(shift, 0.0)
        for i in range(N):
            for j in np.where(dmin[i] < margin)[0]:
                if is_zero_shift and i == j:
                    continue
                cand[i].append((j, shift))
    for i, lst in enumerate(cand):
        lst.sort(key=lambda js: float(np.linalg.norm(centers[i] - (centers[js[0]] + js[1]))))
    M = max(len(c) for c in cand)
    M = int(np.ceil(M / 8.0) * 8)
    slot_j = np.zeros((N, M), dtype=np.int32)
    shift_arr = np.zeros((N, M, 3))
    valid = np.zeros((N, M), dtype=bool)
    for i, lst in enumerate(cand):
        for m, (j, sh) in enumerate(lst):
            slot_j[i, m] = j
            shift_arr[i, m] = sh
            valid[i, m] = True
    return StaticNeighborTable(slot_j, shift_arr, valid, M)
