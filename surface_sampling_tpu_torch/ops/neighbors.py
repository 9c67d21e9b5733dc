"""Periodic image shifts for a cutoff (host side, numpy) and the dynamic
edge path over a static candidate table (device side, batched over
chains).

The counterpart of ``surface_sampling_tpu/ops/neighbors.py``:
``pair_shifts`` and ``pair_shifts_for`` run once, when a system is built;
``image_distances`` and ``image_pair_mask`` are the dense all-image pair
geometry of the exact classical potentials; ``neighbor_list_from_table``, ``select_edge_topology`` and
``edges_from_topology`` build the edges of displaced geometries, the path
that forces and relaxation take; ``neighbor_list`` builds the edges of a
batch of structures with their own image shifts (training and
prediction), twice differentiable in the positions.

The rank-select is a cumsum plus a scatter of the kept candidates'
indices (as in ``ops/static_edges.py``), not the JAX package's
(N, Mc, M) one-hot einsum: the same edges in the same order with the same
overflow flag. Selection runs on detached positions (it is piecewise
constant); the edge geometry is then recomputed from the selected
topology, differentiable in the positions. Every edge set carries a
reverse-neighbor table (the incoming edges of each slot, in a fixed
order), so that the backward of the neighbor gather, here and in the
message kernel, is a gather with a fixed summation order instead of a
scatter with float atomics: relaxed positions enter the MC state, and
runs must repeat bitwise on the card. Given a supercell's routing band, the
topology also carries the banded message backward's reverse table
(``ops.banding.banded_reverse_table``), built once per topology.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.ops.banding import DeviceBand, banded_reverse_table

# Row padding of the (n_pad, M) edge layout, shared with
# ``ops/static_edges.py``: the JAX package pads slots to its message
# kernel's center block (16), so both packages' arrays have one shape.
ROW_PAD = 16


def padded_rows(n: int) -> int:
    return ((n + ROW_PAD - 1) // ROW_PAD) * ROW_PAD


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


# ----------------------------------------------------------------------
# Dense image pairs (device, batched over chains)
# ----------------------------------------------------------------------
def image_distances(positions: torch.Tensor, shifts: torch.Tensor, eps: float = 1e-12):
    """Distances r[c, k, i, j] = |pos_i - (pos_j + shift_k)| of chain c with
    a safe sqrt, for positions (C, N, 3) and shifts (K, 3).

    Returns (r (C, K, N, N), disp (C, K, N, N, 3)). The self pair of the
    zero shift (k = 0 diagonal) is NOT masked here; see
    :func:`image_pair_mask`.
    """
    disp = positions[:, None, :, None, :] - (positions[:, None, None, :, :]
                                             + shifts[None, :, None, None, :])
    d2 = (disp * disp).sum(dim=-1)
    return torch.sqrt(torch.clamp(d2, min=eps)), disp


def image_pair_mask(alive: torch.Tensor, r: torch.Tensor, cutoff: float) -> torch.Tensor:
    """(C, K, N, N) mask of interacting image pairs: both alive (alive
    (C, N)), within cutoff, and not the self pair of the zero shift."""
    _, k, n, _ = r.shape
    self_pair = torch.zeros((k, n, n), dtype=torch.bool, device=r.device)
    self_pair[0] = torch.eye(n, dtype=torch.bool, device=r.device)
    both = alive[:, None, :, None] & alive[:, None, None, :]
    return both & ~self_pair & (r < cutoff)


# ----------------------------------------------------------------------
# Dynamic edges over a static candidate table (device, batched over chains)
# ----------------------------------------------------------------------
class CandidateTable(NamedTuple):
    """A ``StaticNeighborTable`` staged on the device. Column Mc of
    ``slot_j`` and ``shift`` is a sentinel (slot 0, zero shift) that
    unselected edges read, as the JAX one-hot selection reads zeros."""

    slot_j: torch.Tensor     # (N, Mc + 1) int64
    shift: torch.Tensor      # (N, Mc + 1, 3) f32
    valid: torch.Tensor      # (N, Mc) bool
    cutoff: float
    max_neighbors: int       # M = min(max_neighbors, Mc)
    max_in_degree: int       # bound on any slot's incoming selected edges


class EdgeTopology(NamedTuple):
    nbr_j: torch.Tensor      # (C, N, M) int64
    shift: torch.Tensor      # (C, N, M, 3)
    mask: torch.Tensor       # (C, N, M) bool
    overflow: torch.Tensor   # (C,) bool
    rev: torch.Tensor        # (C, n_pad, D) int32, see reverse_table
    rev_band: torch.Tensor | None = None   # (C, n_pad + halo, D), banded_reverse_table


class Edges(NamedTuple):
    """Edge geometry; the first five fields are the JAX edge tuple."""

    disp: torch.Tensor       # (C, N, M, 3), 0 on unselected edges
    r: torch.Tensor          # (C, N, M), cutoff on unselected edges
    nbr_j: torch.Tensor      # (C, N, M) int64
    mask: torch.Tensor       # (C, N, M) bool
    overflow: torch.Tensor   # (C,) bool
    rev: torch.Tensor        # (C, n_pad, D) int32, see reverse_table
    rev_band: torch.Tensor | None = None   # (C, n_pad + halo, D), banded_reverse_table


def stage_candidate_table(static_nbr, cutoff: float, max_neighbors: int,
                          device) -> CandidateTable:
    """Stage a host ``StaticNeighborTable`` for the dynamic edge path."""
    slot_j = np.asarray(static_nbr.slot_j, np.int64)
    valid = np.asarray(static_nbr.valid, bool)
    N, Mc = slot_j.shape
    shift = np.zeros((N, Mc + 1, 3), np.float32)
    shift[:, :Mc] = np.asarray(static_nbr.shift, np.float32)
    # a selected edge i -> j is a valid candidate of i, so the candidates
    # naming j bound the number of edges that can ever arrive at j
    in_degree = int(np.bincount(slot_j[valid], minlength=N).max()) if valid.any() else 0
    return CandidateTable(
        slot_j=torch.as_tensor(np.pad(slot_j, ((0, 0), (0, 1))), device=device),
        shift=torch.as_tensor(shift, device=device),
        valid=torch.as_tensor(valid, device=device),
        cutoff=float(cutoff),
        max_neighbors=int(min(max_neighbors, Mc)),
        max_in_degree=max(in_degree, 1),
    )


def _candidate_geometry(positions, alive, table: CandidateTable):
    """Shared candidate-pair geometry: disp / r and the in-range mask over
    the static table, (C, N, Mc[, 3])."""
    Mc = table.valid.shape[1]
    slot = table.slot_j[:, :Mc]
    pj = positions[:, slot]                                          # (C, N, Mc, 3)
    disp = positions[:, :, None, :] - (pj + table.shift[:, :Mc])
    r = torch.sqrt(torch.clamp((disp * disp).sum(-1), min=1e-12))
    mask = table.valid & alive[:, :, None] & alive[:, slot] & (r < table.cutoff)
    return disp, r, mask


def _rank_select(mask: torch.Tensor, max_neighbors: int):
    """Masked-cumsum rank-select: the candidate index kept at each rank
    (C, N, M), the first ``max_neighbors`` masked candidates of each row in
    table order, Mc where a rank is unfilled; and the (C,) overflow flag."""
    C, N, Mc = mask.shape
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int64) - 1
    overflow = (rank[..., -1] + 1 > max_neighbors).any(dim=-1)
    keep = mask & (rank < max_neighbors)
    # dropped candidates all land in the extra column M, discarded
    dest = torch.where(keep, rank, max_neighbors)
    cand = torch.arange(Mc, device=mask.device).expand(C, N, Mc)
    idx = torch.full((C, N, max_neighbors + 1), Mc, dtype=torch.int64, device=mask.device)
    idx.scatter_(2, dest, cand)
    return idx[..., :max_neighbors], overflow


def reverse_table(nbr: torch.Tensor, mask: torch.Tensor, n_pad: int,
                  depth: int | None = None) -> torch.Tensor:
    """Reverse-neighbor table (C, n_pad, D) int32 of (C, E) neighbor
    indices over padded rows: row j lists the ids e = i*M + m of the edges
    whose neighbor is j, ascending (a stable sort by neighbor), then -1.
    Only edges under ``mask`` are listed: unselected edges carry nbr = 0
    and would pile thousands of zero-weight entries onto slot 0.

    ``depth`` bounds any row's in-degree (``CandidateTable.max_in_degree``);
    None measures it, which reads a number back from the device."""
    C, E = nbr.shape
    keys = torch.where(mask, nbr.long(), n_pad)
    skeys, order = torch.sort(keys, dim=1, stable=True)
    rows = torch.arange(n_pad + 1, device=nbr.device).expand(C, n_pad + 1).contiguous()
    off = torch.searchsorted(skeys, rows)                            # (C, n_pad + 1)
    if depth is None:
        depth = max(int((off[:, 1:] - off[:, :-1]).max()), 1)
    slot = off[:, :-1, None] + torch.arange(depth, device=nbr.device)
    ok = slot < off[:, 1:, None]
    got = torch.gather(order, 1, slot.clamp(max=E - 1).reshape(C, -1)).reshape(ok.shape)
    return torch.where(ok, got, -1).to(torch.int32).contiguous()


def select_edge_topology(positions, alive, table: CandidateTable,
                         band: DeviceBand | None = None) -> EdgeTopology:
    """Rank-select the candidate pairs once, keeping per-edge image shifts,
    so geometry can be recomputed at displaced positions with the topology
    fixed (the reference's refresh-per-relaxation neighbor semantics).
    ``positions`` (C, N, 3), ``alive`` (C, N) bool. With the routing
    ``band`` of a supercell (built from the same candidate table) the
    topology also carries the banded message backward's reverse table, in
    the band's sorted edge layout."""
    with torch.no_grad():
        _, _, mask = _candidate_geometry(positions.detach(), alive, table)
        idx, overflow = _rank_select(mask, table.max_neighbors)
        rows = torch.arange(idx.shape[1], device=idx.device)[None, :, None]
        nbr_j = table.slot_j[rows, idx]                              # (C, N, M)
        shift = table.shift[rows, idx]
        sel = idx < mask.shape[-1]
        C, N, M = nbr_j.shape
        n_pad = padded_rows(N)
        pad = (0, 0, 0, n_pad - N)
        nbr_p = torch.nn.functional.pad(nbr_j, pad)
        sel_p = torch.nn.functional.pad(sel, pad)
        rev = reverse_table(nbr_p.reshape(C, -1), sel_p.reshape(C, -1), n_pad,
                            table.max_in_degree)
        rev_band = None
        if band is not None:
            rev_band = banded_reverse_table(band.rank[nbr_p[:, band.perm]].reshape(C, -1),
                                            sel_p[:, band.perm].reshape(C, -1), band,
                                            table.max_in_degree)
    return EdgeTopology(nbr_j, shift, sel, overflow, rev, rev_band)


class _GatherRows(torch.autograd.Function):
    """rows[c, nbr_j[c]] of (C, n_rows, D) rows (positions, D = 3, or any
    per-atom features) whose backward sums each slot's incoming edges
    through the reverse table: a gather and a sum over a fixed axis, with
    no float atomics. Unselected edges are left out, which is exact as long
    as their cotangent is 0 (the edge builders mask them; a model masks
    them before it sums over neighbours). Twice differentiable: the
    backward is ``_SumIncoming``, whose own backward is this gather again
    (the two are adjoint linear maps)."""

    @staticmethod
    def forward(ctx, positions, nbr_j, rev_edges):
        ctx.save_for_backward(nbr_j, rev_edges)
        ctx.n_rows = positions.shape[1]
        C, N, M = nbr_j.shape
        D = positions.shape[-1]
        flat = nbr_j.reshape(C, N * M, 1).expand(C, N * M, D)
        return torch.gather(positions, 1, flat).reshape(C, N, M, D)

    @staticmethod
    def backward(ctx, g):
        nbr_j, rev_edges = ctx.saved_tensors
        return _SumIncoming.apply(g, nbr_j, rev_edges, ctx.n_rows), None, None


class _SumIncoming(torch.autograd.Function):
    """Per-edge rows g (C, N, M, W) summed onto their neighbour slots
    (C, n_rows, W) through the reverse table, in its fixed order; the
    adjoint of ``_GatherRows`` (edges the table leaves out get zeros)."""

    @staticmethod
    def forward(ctx, g, nbr_j, rev_edges, n_rows):
        ctx.save_for_backward(nbr_j, rev_edges)
        C, W = g.shape[0], g.shape[-1]
        D = rev_edges.shape[-1]
        gz = torch.cat([g.reshape(C, -1, W), g.new_zeros((C, 1, W))], dim=1)
        idx = rev_edges[:, :n_rows].long()
        idx = torch.where(idx < 0, gz.shape[1] - 1, idx).reshape(C, n_rows * D, 1)
        return torch.gather(gz, 1, idx.expand(-1, -1, W)).reshape(C, n_rows, D, W).sum(2)

    @staticmethod
    def backward(ctx, gg):
        nbr_j, rev_edges = ctx.saved_tensors
        C, N, M = nbr_j.shape
        n_pad = rev_edges.shape[1]
        listed = torch.zeros((C, n_pad * M + 1), dtype=torch.bool, device=nbr_j.device)
        listed.scatter_(1, torch.where(rev_edges < 0, n_pad * M, rev_edges).long()
                        .reshape(C, -1), True)
        listed = listed[:, :N * M].reshape(C, N, M, 1)
        return _GatherRows.apply(gg, nbr_j, rev_edges) * listed, None, None, None


def edges_from_topology(positions, topology: EdgeTopology, cutoff: float) -> Edges:
    """Recompute edge geometry at new ``positions`` under a fixed topology
    from :func:`select_edge_topology`, differentiable in ``positions``.
    Edges that drift past the cutoff stay in the list with their true
    distance: every radial envelope vanishes there."""
    nbr_j, shift, mask, overflow, rev, rev_band = topology
    disp, r = _edge_geometry(positions, nbr_j, shift, mask, rev, cutoff)
    return Edges(disp, r, nbr_j, mask, overflow, rev, rev_band)


def _edge_geometry(positions, nbr_j, shift, mask, rev, cutoff: float):
    """disp (C, N, M, 3) and r (C, N, M) of the edges i -> (nbr_j, shift)
    at ``positions``, twice differentiable, with the neighbour gather's
    backward a fixed-order sum over ``rev``; 0 and ``cutoff`` on unselected
    edges."""
    disp = positions[:, :, None, :] - (_GatherRows.apply(positions, nbr_j, rev) + shift)
    r = torch.sqrt(torch.clamp((disp * disp).sum(-1), min=1e-12))
    r = torch.where(mask, r, torch.full_like(r, cutoff))
    disp = torch.where(mask[..., None], disp, torch.zeros_like(disp))
    return disp, r


def neighbor_list(positions, shifts, alive, cutoff: float, max_neighbors: int) -> Edges:
    """Padded neighbour list of a batch of structures, each with its own
    image shifts: the counterpart of the JAX package's ``neighbor_list``
    (``lax.top_k`` over the fused (shift, atom) axis), batched over
    structures C.

    Each atom keeps its M = min(max_neighbors, K * N) nearest in-range
    image pairs (alive, within ``cutoff``, not the self pair of shift 0),
    nearest first, ties to the lower fused index k * N + j, the rule of
    ``lax.top_k`` that a stable ascending sort of r keeps. Selection runs on
    detached positions; disp and r are recomputed from the chosen (k, j),
    twice differentiable in the positions (force-loss training
    differentiates the forces). Shift slots a structure does not use should
    be parked far away (``models.train.pad_structures`` puts them at 1e6).

    Args:
        positions: (C, N, 3) f32; shifts: (C, K, 3) cartesian image shifts,
            the zero shift first; alive: (C, N) bool.
    Returns:
        ``Edges`` with disp (C, N, M, 3) (0 on padding), r (C, N, M)
        (``cutoff`` on padding), nbr_j (C, N, M) int64 (as ``lax.top_k``'s
        index on padding), mask, overflow (C,) (an atom had more than M
        in-range pairs) and the reverse table of the selected edges over
        padded rows (``reverse_table``).
    """
    C, N, _ = positions.shape
    K = shifts.shape[1]
    M = min(max_neighbors, K * N)                                    # static clamp
    with torch.no_grad():
        pos = positions.detach()
        sh = shifts.detach().to(pos.dtype)
        disp = pos[:, None, :, None, :] - (pos[:, None, None, :, :] + sh[:, :, None, None, :])
        r = torch.sqrt(torch.clamp((disp * disp).sum(-1), min=1e-12))  # (C, K, N, N)
        self_pair = torch.zeros((K, N, N), dtype=torch.bool, device=pos.device)
        self_pair[0] = torch.eye(N, dtype=torch.bool, device=pos.device)
        both = alive[:, None, :, None] & alive[:, None, None, :]
        in_range = both & ~self_pair & (r < cutoff)
        scores = torch.where(in_range, r, torch.full_like(r, float("inf")))
        flat = scores.permute(0, 2, 1, 3).reshape(C, N, K * N)       # fused (k, j) axis
        vals, idx = torch.sort(flat, dim=-1, stable=True)
        vals, idx = vals[..., :M], idx[..., :M]
        mask = torch.isfinite(vals)
        nbr_j, nbr_k = idx % N, idx // N
        overflow = (in_range.sum(dim=(1, 3)) > M).any(dim=-1)
        shift = torch.gather(shifts, 1, nbr_k.reshape(C, N * M, 1).expand(C, N * M, 3))
        n_pad = padded_rows(N)
        pad = (0, 0, 0, n_pad - N)
        rev = reverse_table(torch.nn.functional.pad(nbr_j, pad).reshape(C, -1),
                            torch.nn.functional.pad(mask, pad).reshape(C, -1), n_pad)
    disp, r = _edge_geometry(positions, nbr_j, shift.reshape(C, N, M, 3).to(positions.dtype),
                             mask, rev, cutoff)
    return Edges(disp, r, nbr_j, mask, overflow, rev)


def image_search_edges(positions, alive, shifts, cutoff: float, max_neighbors: int) -> Edges:
    """:func:`neighbor_list` of a (C, N) batch of structures over image
    ``shifts``: one (K, 3) set for every structure, or (C, K, 3). The edge
    path of the potentials built without a static candidate table."""
    if shifts is None:
        raise ValueError("edges by image search need the image shifts")
    sh = torch.as_tensor(shifts, dtype=positions.dtype, device=positions.device)
    if sh.ndim == 2:
        sh = sh.expand(positions.shape[0], *sh.shape)
    return neighbor_list(positions, sh, alive, cutoff, max_neighbors)


def neighbor_list_from_table(positions, alive, table: CandidateTable,
                             band: DeviceBand | None = None) -> Edges:
    """Padded neighbor list from a static candidate table: in-range alive
    candidates in table order, the first M kept. Equal, value for value,
    to the JAX function, whose payload compaction copies the candidate
    disp and r that :func:`edges_from_topology` recomputes here with the
    same arithmetic."""
    return edges_from_topology(positions, select_edge_topology(positions, alive, table, band),
                               table.cutoff)


def make_table_topology_fns(table: CandidateTable, band: DeviceBand | None = None):
    """(topo_fn, geom_fn): ``topo_fn(positions, alive)`` selects the fixed
    topology once (with the banded reverse table under ``band``);
    ``geom_fn(positions, topology)`` rebuilds the edges per force call (the
    relax loop's refresh_edges="once" mode)."""

    def topo_fn(positions, alive):
        return select_edge_topology(positions, alive, table, band)

    def geom_fn(positions, topology):
        return edges_from_topology(positions, topology, table.cutoff)

    return topo_fn, geom_fn


def make_table_edge_fn(table: CandidateTable, band: DeviceBand | None = None):
    """Close :func:`neighbor_list_from_table` over a staged table (and a
    routing band)."""

    def edge_fn(positions, alive):
        return neighbor_list_from_table(positions, alive, table, band)

    return edge_fn
