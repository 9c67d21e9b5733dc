"""Block-banded neighbour routing for supercells (host side, numpy), and
its tables staged on a device.

The counterpart of ``surface_sampling_tpu/ops/banding.py`` and of
``choose_message_block``, ``DeviceBand`` and ``stage_band`` in
``surface_sampling_tpu/ops/pallas_painn.py``. Slots are sorted along the
cell's longest lateral axis, so each block of ``n_blk`` sorted centres
finds every candidate neighbour in a narrow window of W consecutive sorted
ranks (wrapping at the end, which a halo copy of the first rows makes
contiguous). On the TPU the window shrinks the one-hot routing products
from n_pad to W columns; the port's kernels load rows by index, so there
the band is a layout that the supercell path keeps for parity, not a
saving (``csrc/painn_message_banded.cuh``). The band's device-side
addressing (``window_rows``) and the reverse table of the banded message
backward (``banded_reverse_table``) live here too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# a band is kept only when its windows are narrower than this share of the
# padded slot count (the JAX package's threshold)
MIN_SAVING = 0.85


class RoutingBand(NamedTuple):
    """Host-side banding data (numpy).

    perm: (n_pad,) slot order (sorted spatial order; pad rows at the
        end): ``x_sorted = x[perm]``.
    inv_perm: (n_pad,) inverse: ``x = x_sorted[inv_perm]``.
    rank: (n_pad,) position of each slot in sorted order.
    win_start: (n_pad // n_blk,) int32 8-aligned window start (sorted
        coordinates, modulo n_pad) per block of n_blk sorted centres.
    window: W, a multiple of 8; every candidate neighbour j of block b
        satisfies (rank[j] - win_start[b]) mod n_pad < W.
    halo: rows [0, halo) of a sorted table are appended after row
        n_pad - 1, so that every window is a contiguous row range.
    n_blk: the centre-block size the windows were built for.
    """

    perm: np.ndarray
    inv_perm: np.ndarray
    rank: np.ndarray
    win_start: np.ndarray
    window: int
    halo: int
    n_blk: int


def choose_message_block(n_pad: int) -> int:
    """Centre-block size of the JAX package's message kernels for n_pad
    padded slots (its VMEM budget). Windows are defined per block of
    sorted rows, so the port builds its bands with the same block size to
    get the same windows; its own kernels use it only to find a centre's
    window (``win_start[i // n_blk]``)."""
    return 16 if n_pad <= 256 else 8


def _circular_window(ranks: np.ndarray, n: int) -> tuple[int, int]:
    """Minimal circular window [s, s + W) mod n covering ``ranks``."""
    rs = np.unique(ranks)
    if len(rs) >= n:
        return 0, n
    gaps = np.diff(np.concatenate([rs, [rs[0] + n]]))
    k = int(np.argmax(gaps))
    start = int(rs[(k + 1) % len(rs)])
    width = int(n - gaps[k] + 1)
    return start, width


def spec_slot_centers(spec) -> np.ndarray:
    """(N, 3) representative position per slot: pristine positions, then
    each site-group slot at its site coordinate (as
    ``core.static_neighbors.build_static_neighbor_table`` places them)."""
    P, S, G = spec.n_pristine, spec.n_sites, spec.group_size
    centers = np.zeros((P + S * G, 3))
    centers[:P] = spec.pristine_positions
    centers[P:] = np.repeat(np.asarray(spec.site_coords, np.float64), G, axis=0)
    return centers


def _block_candidates(perm, b, n_blk, N, slot_j, valid):
    rows = perm[b * n_blk:(b + 1) * n_blk]
    rows = rows[rows < N]
    if len(rows) == 0:
        return None
    cand = np.concatenate([slot_j[r][valid[r]] for r in rows])
    return cand if len(cand) else None


def build_routing_band(centers: np.ndarray, slot_j: np.ndarray, valid: np.ndarray,
                       n_blk: int, n_pad: int) -> RoutingBand | None:
    """Banding data, or None when the windows would not be narrower than
    ``MIN_SAVING * n_pad`` (the 124-slot flagship cell is fully connected
    laterally at its cutoff).

    Args:
        centers: (N, 3) slot positions.
        slot_j, valid: the static candidate table ((N, Mc) each), the
            superset of every neighbour the rank-select can pick.
        n_blk: centre-block size (:func:`choose_message_block`).
        n_pad: padded slot count, a multiple of n_blk.
    """
    centers = np.asarray(centers, np.float64)
    N = centers.shape[0]
    if N < 2 * n_blk or n_pad % n_blk:
        return None
    # sort along the lateral axis with the largest extent (z is the slab
    # normal: its extent is thickness, not periodic size)
    extents = centers.max(axis=0) - centers.min(axis=0)
    axis = int(np.argmax(extents[:2])) if extents[:2].max() > 0 else 0
    order = np.lexsort((centers[:, 2], centers[:, (axis + 1) % 2], centers[:, axis]))
    perm = np.concatenate([order, np.arange(N, n_pad)]).astype(np.int32)
    rank = np.empty(n_pad, np.int64)
    rank[perm] = np.arange(n_pad)

    n_blocks = n_pad // n_blk
    starts = np.zeros(n_blocks, np.int64)
    width = 0
    for b in range(n_blocks):
        cand = _block_candidates(perm, b, n_blk, N, slot_j, valid)
        if cand is None:
            continue
        s, w = _circular_window(rank[cand], n_pad)
        s8 = (s // 8) * 8
        starts[b] = s8
        width = max(width, w + (s - s8))
    W = int(np.ceil(width / 8.0) * 8)
    if W >= MIN_SAVING * n_pad:
        return None
    halo = int(max(0, (starts + W - n_pad).max()))
    halo = int(np.ceil(halo / 8.0) * 8)
    # verify coverage exactly: every candidate of every block lies in its window
    for b in range(n_blocks):
        cand = _block_candidates(perm, b, n_blk, N, slot_j, valid)
        if cand is None:
            continue
        off = (rank[cand] - starts[b]) % n_pad
        if off.max() >= W:
            raise AssertionError(f"banding coverage bug: block {b} candidate offset "
                                 f"{int(off.max())} >= W={W}")
    return RoutingBand(
        perm=perm,
        inv_perm=np.argsort(perm).astype(np.int32),
        rank=rank.astype(np.int32),
        win_start=starts.astype(np.int32),
        window=W,
        halo=halo,
        n_blk=int(n_blk),
    )


def build_routing_band_for_spec(spec, static_nbr) -> RoutingBand | None:
    """Band for a SurfaceSpec and its static candidate table, over the
    slots padded to a multiple of 16 (``ops.neighbors.padded_rows``) with
    the JAX kernels' block size for that size."""
    from surface_sampling_tpu_torch.ops.neighbors import padded_rows

    centers = spec_slot_centers(spec)
    n_pad = padded_rows(centers.shape[0])
    return build_routing_band(centers, static_nbr.slot_j, static_nbr.valid,
                              choose_message_block(n_pad), n_pad)


class DeviceBand(NamedTuple):
    """A RoutingBand staged on one device: the permutations as int64 index
    tensors, the window starts as the kernels' int32 table, the widths as
    Python ints."""

    perm: torch.Tensor        # (n_pad,) int64
    inv_perm: torch.Tensor    # (n_pad,) int64
    rank: torch.Tensor        # (n_pad,) int64
    win_start: torch.Tensor   # (n_pad // n_blk,) int32
    window: int
    halo: int
    n_blk: int

    @property
    def n_pad(self) -> int:
        return self.perm.shape[0]


def identity_band(n_pad: int, n_blk: int, device) -> DeviceBand:
    """The band on which the banded general and layer-1 messages are the
    unbanded ones: slots in their own order, every window starting at row 0
    and n_pad wide, no halo. The kernels of ``painn_message_fused`` and
    ``painn_message_l1`` run the banded bodies on it; the tests and
    ``chip_smoke.py`` hold each pair equal on it."""
    ident = torch.arange(n_pad, device=device)
    return DeviceBand(perm=ident, inv_perm=ident, rank=ident,
                      win_start=torch.zeros(n_pad // n_blk, dtype=torch.int32, device=device),
                      window=n_pad, halo=0, n_blk=n_blk)


def stage_band(band: RoutingBand | None, device) -> DeviceBand | None:
    """Host RoutingBand -> DeviceBand on ``device`` (None passes through)."""
    if band is None:
        return None

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return DeviceBand(
        perm=i64(band.perm), inv_perm=i64(band.inv_perm), rank=i64(band.rank),
        win_start=torch.as_tensor(np.asarray(band.win_start, np.int32), device=device),
        window=int(band.window), halo=int(band.halo), n_blk=int(band.n_blk),
    )


def window_rows(nbr: torch.Tensor, ws_edge: torch.Tensor, band: DeviceBand):
    """Row of the halo-extended table holding each edge's neighbour (sorted
    rank ``nbr``) for window starts ``ws_edge`` (per edge), and whether it
    lies in the window: row s + ((r - s) mod n_pad) for window start s and
    rank r. Outside the window the TPU kernels' one-hot router matches
    nothing, so such an edge reads zeros (row 0 is returned for it)."""
    off = torch.remainder(nbr.long() - ws_edge, band.n_pad)
    inwin = off < band.window
    return torch.where(inwin, ws_edge + off, 0), inwin


def assert_in_window(selected: torch.Tensor, inwin: torch.Tensor) -> None:
    """The band guarantees that no selected edge lies outside its window
    (:func:`window_rows`); the plain versions of the banded kernels check
    it."""
    if bool((selected & ~inwin).any()):
        raise AssertionError("a selected edge lies outside its routing window: "
                             "the band does not cover this geometry")


def edge_window_starts(band: DeviceBand, M: int) -> torch.Tensor:
    """(n_pad * M,) window start of every edge of the full sorted cell."""
    rows = torch.arange(band.n_pad, device=band.win_start.device) // band.n_blk
    return band.win_start[rows].long().repeat_interleave(M)


def banded_reverse_table(nbr: torch.Tensor, mask: torch.Tensor, band: DeviceBand,
                         depth: int) -> torch.Tensor:
    """Reverse table of the banded message backward, (C, n_pad + halo, D)
    int32 keyed by extended row: row x lists, ascending, the sorted-layout
    edge ids e = i*M + m whose neighbour (sorted rank ``nbr`` (C, E)) is
    read from row x of the halo-extended table, selected edges (``mask``)
    only, then -1. A sorted slot is read as row r or, from a window that
    wraps, as row r + n_pad; both rows lie in one slot's incoming edges, so
    the slot's bound on incoming selected edges (``depth``,
    ``CandidateTable.max_in_degree``) bounds every row."""
    from surface_sampling_tpu_torch.ops.neighbors import reverse_table

    C, E = nbr.shape
    row, inwin = window_rows(nbr, edge_window_starts(band, E // band.n_pad)[None], band)
    return reverse_table(row, mask & inwin, band.n_pad + band.halo, depth)
