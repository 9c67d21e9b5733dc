"""Static edge geometry for the rigid-lattice PaiNN MC path.

On a rigid lattice every slot position is fixed, so the whole per-edge
geometry of the candidate table (distances, radial basis, envelope, unit
vectors) is state-independent; a move changes only which slots are alive.
The counterpart of ``surface_sampling_tpu/ops/static_edges.py``:

    mask  = static_in_range & alive_i & alive_j         (C, n_pad, Mc)
    rank  = cumsum(mask) - 1                            inclusive masked rank
    keep  = mask & (rank < M)                           first M live candidates
    edges = payload[row, index of the candidate kept at each rank]

The TPU version writes the rank as a triangular-ones matmul and the
selection as one-hot matmuls over a bf16 hi/lo payload split, because
gathers serialize on the TPU. Here the rank is a cumsum, the kept
candidates' indices are scattered to their ranks, and the f32 payload
(computed on the host in f64) is gathered by index. The selected edges,
their order and ``overflow`` are the same; the values differ from the
TPU payload only by its bf16 split rounding.

With a routing band (supercells, ``ops/banding.py``) the rows are born in
the band's sorted order and the neighbour column carries sorted ranks, as
in the JAX package, so the banded kernels take the geometry without a
per-evaluation permutation; only the excluded-volume edges are returned
in natural slot order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.models.painn import _cosine_envelope, _rbf
from surface_sampling_tpu_torch.ops.banding import DeviceBand, RoutingBand, stage_band
from surface_sampling_tpu_torch.ops.neighbors import padded_rows


class StaticEdgePack(NamedTuple):
    """Static edge tables on the device, rows padded to ``n_pad``, in the
    band's sorted order when ``band`` is set, else in natural slot order.
    Payload columns: [rbf (r_pad) | env | r | unit_x,y,z]; candidate column
    Mc of ``pay`` and ``nbr`` is an all-zero sentinel that unselected
    output edges read."""

    pay: torch.Tensor        # (n_pad, Mc + 1, r_pad + 5) f32
    nbr: torch.Tensor        # (n_pad, Mc + 1) int32 kernel neighbor index:
                             # sorted rank (band) or slot id (no band)
    slot_j: torch.Tensor     # (n_pad, Mc) int64 neighbor slot ids (alive lookup)
    inr: torch.Tensor        # (n_pad, Mc) bool static in-range mask
    row_slot: torch.Tensor   # (n_pad,) int64 slot of each row (pads: N)
    n_pad: int
    N: int
    M: int
    r_pad: int
    cutoff: float
    band: DeviceBand | None = None


def code_independent_geometry(spec) -> bool:
    """True when realized slot positions do not depend on the occupancy
    code, the precondition for static edge geometry."""
    co = np.asarray(spec.code_offsets)
    return co.size == 0 or float(np.ptp(co, axis=0).max()) == 0.0


def static_positions(spec) -> np.ndarray:
    """(N, 3) f64 slot positions of a code-independent spec."""
    pristine = np.asarray(spec.pristine_positions, np.float64)
    site = np.asarray(spec.site_coords, np.float64)
    offs = np.asarray(spec.code_offsets, np.float64)
    ads = site[:, None, :] + offs[0][None, :, :]
    return np.concatenate([pristine, ads.reshape(-1, 3)])


def build_static_edge_pack(spec, static_nbr, cfg, device,
                           band: RoutingBand | None = None) -> StaticEdgePack | None:
    """Precompute the static edge payload of a rigid PaiNN system on the
    host in f64 and stage it on ``device`` as f32.

    Returns None when the geometry is code-dependent (mixed-offset
    adsorbate groups). ``cfg`` is a PaiNNConfig (cutoff, n_rbf,
    max_neighbors); ``band`` a host RoutingBand over the same slots, which
    puts the rows in sorted order and the neighbor ranks in ``nbr``.
    """
    if not code_independent_geometry(spec):
        return None
    pos = torch.as_tensor(static_positions(spec), dtype=torch.float64)
    slot_j = np.asarray(static_nbr.slot_j, np.int64)                 # (N, Mc)
    shift = torch.as_tensor(np.asarray(static_nbr.shift), dtype=torch.float64)
    valid = torch.as_tensor(np.asarray(static_nbr.valid))
    N, Mc = slot_j.shape
    cutoff = float(cfg.cutoff)
    M = int(min(cfg.max_neighbors, Mc))
    n_rbf = int(cfg.n_rbf)
    r_pad = ((n_rbf + 7) // 8) * 8
    n_pad = padded_rows(N)
    if band is not None and len(band.perm) != n_pad:
        raise ValueError(f"the routing band covers {len(band.perm)} rows, the pack {n_pad}")

    disp = pos[:, None, :] - (pos[torch.as_tensor(slot_j)] + shift)  # (N, Mc, 3)
    r = torch.sqrt(torch.clamp((disp**2).sum(-1), min=1e-24))
    inr = valid & (r < cutoff)
    dsafe = torch.clamp(r, min=1e-8)

    pay = torch.zeros((n_pad, Mc + 1, r_pad + 5), dtype=torch.float64)
    pay[:N, :Mc, :n_rbf] = _rbf(r, n_rbf, cutoff)
    pay[:N, :Mc, r_pad] = _cosine_envelope(r, cutoff)
    pay[:N, :Mc, r_pad + 1] = r
    pay[:N, :Mc, r_pad + 2:] = disp / dsafe[..., None]
    pay[:N, :Mc][~inr] = 0.0                                         # never selectable

    nbr = np.zeros((n_pad, Mc + 1), np.int32)
    nbr[:N, :Mc] = slot_j if band is None else np.asarray(band.rank)[slot_j]
    slot_p = np.zeros((n_pad, Mc), np.int64)
    slot_p[:N] = slot_j
    inr_p = np.zeros((n_pad, Mc), bool)
    inr_p[:N] = inr.numpy()
    row_slot = np.concatenate([np.arange(N), np.full(n_pad - N, N)])
    if band is not None:                                             # rows born sorted
        take = np.asarray(band.perm)
        pay, nbr, slot_p = pay[torch.as_tensor(take, dtype=torch.int64)], nbr[take], slot_p[take]
        inr_p, row_slot = inr_p[take], row_slot[take]

    return StaticEdgePack(
        pay=pay.to(device=device, dtype=torch.float32),
        nbr=torch.as_tensor(nbr, device=device),
        slot_j=torch.as_tensor(slot_p, device=device),
        inr=torch.as_tensor(inr_p, device=device),
        row_slot=torch.as_tensor(row_slot, dtype=torch.int64, device=device),
        n_pad=n_pad, N=N, M=M, r_pad=r_pad, cutoff=cutoff,
        band=stage_band(band, device),
    )


def static_edge_geometry(pack: StaticEdgePack, alive: torch.Tensor):
    """Per-evaluation edge build from a (C, N) alive mask.

    Returns ``(msg_geom, edges)``:
        msg_geom = (rbf (C, E, r_pad), envm (C, E), nbr (C, E) int32,
                    unit (C, 3, n_pad, M), n_pad) with E = n_pad * M, the
                    inputs of the message kernels (envm = envelope on
                    selected edges, 0 elsewhere), rows in the pack's order
                    (sorted under a band, nbr then holding ranks);
        edges    = (r (C, N, M), mask (C, N, M), overflow (C,)) in natural
                    slot order for the excluded-volume term (r = cutoff on
                    unselected edges).
    """
    C = alive.shape[0]
    N, M, n_pad, r_pad = pack.N, pack.M, pack.n_pad, pack.r_pad
    Mc = pack.inr.shape[1]

    a = torch.nn.functional.pad(alive, (0, 1))                       # column N = pad, dead
    ai = a[:, pack.row_slot]                                         # (C, n_pad)
    aj = a[:, pack.slot_j]                                           # (C, n_pad, Mc)
    mask = pack.inr & ai[..., None] & aj
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int64) - 1         # inclusive
    overflow = (rank[..., -1] + 1 > M).any(dim=-1)                   # (C,)
    keep = mask & (rank < M)

    # candidate index kept at each rank; unfilled ranks keep the sentinel
    # Mc. Dropped candidates all land in the extra column M, discarded.
    dest = torch.where(keep, rank, M)
    cand = torch.arange(Mc, device=alive.device).expand(C, n_pad, Mc)
    idx = torch.full((C, n_pad, M + 1), Mc, dtype=torch.int64, device=alive.device)
    idx.scatter_(2, dest, cand)
    idx = idx[..., :M]                                               # (C, n_pad, M)

    rows = torch.arange(n_pad, device=alive.device)[None, :, None]
    g = pack.pay[rows, idx]                                          # (C, n_pad, M, P)
    flag = idx < Mc
    rbf = g[..., :r_pad].reshape(C, n_pad * M, r_pad).contiguous()
    envm = g[..., r_pad].reshape(C, n_pad * M).contiguous()
    r_s = torch.where(flag, g[..., r_pad + 1], pack.cutoff)
    unit = g[..., r_pad + 2:].permute(0, 3, 1, 2).contiguous()       # (C, 3, n_pad, M)
    nbr = pack.nbr[rows, idx].reshape(C, n_pad * M)

    msg_geom = (rbf, envm, nbr, unit, n_pad)
    if pack.band is not None:                                        # back to slot order
        r_s, flag = r_s[:, pack.band.inv_perm], flag[:, pack.band.inv_perm]
    edges = (r_s[:, :N], flag[:, :N], overflow)
    return msg_geom, edges
