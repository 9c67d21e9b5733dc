"""Operations and bytes of the port's kernels and of a whole evaluation,
from the states a cell evaluates, and their least times on one H100.

Frozen copies of the arithmetic of ``chip_smoke.py`` (``msg_flops_per_edge``,
``l1_binned_work``, ``update_work``, ``conv_flops_per_edge``,
``conv_products_per_edge``, ``conv_bytes``, ``bwd_bounds`` as
``bound_tc_s``), counted here from the occupancies alone (the reference's
geometry: every alive pair under the cutoff), never from the program's
tables. A kernel's least time is the larger of its bytes over the HBM
bandwidth and its operations, the tensor-core products at three TF32 passes
(f32-accurate) and the rest at the f32 rate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.common import Lattice, edge_list, image_shifts, realise

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
ROW_PAD = 16            # the program's padded rows: ceil(N / 16) * 16


def bound_tc_s(products: float, rest: float, nbytes: float) -> float:
    """Least seconds: products at 3 TF32 passes plus the rest at f32,
    against bytes at the HBM bandwidth."""
    return max(nbytes / PEAK_BYTES_PER_S, 3 * products / PEAK_TF32_FLOPS + rest / PEAK_F32_FLOPS)


def bound_f32_s(flops: float, nbytes: float) -> float:
    """Least seconds of a kernel with no tensor-core product."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


class StateCounts(NamedTuple):
    """What one evaluation of a batch of occupancies computes on."""

    chains: int
    slots: int            # N
    alive: int            # alive atoms over the batch
    live_edges: int       # directed pairs under the cutoff
    present: int          # (chain, centre, neighbour species present) triples


def state_counts(lat: Lattice, site_state: torch.Tensor, cutoff: float) -> StateCounts:
    """Counts of one batch of (C, S) occupancies."""
    numbers, positions = realise(lat, site_state)
    alive = numbers > 0
    e = edge_list(positions, alive, image_shifts(lat.cell, lat.pbc, cutoff), cutoff)
    nb = numbers.reshape(-1)[e.neighbour]
    key = e.centre * 128 + nb
    present = int(torch.unique(key).numel())
    return StateCounts(site_state.shape[0], numbers.shape[1], int(alive.sum()), e.r.numel(),
                       present)


def n_pad(n: int) -> int:
    return (n + ROW_PAD - 1) // ROW_PAD * ROW_PAD


# ----------------------------------------------------------------------
# PaiNN rows 1-3 (rigid trunk, no band): one launch's least seconds
# ----------------------------------------------------------------------
def msg_flops_per_edge(F: int, R: int) -> int:
    """General message per contributing edge and member (3F channels)."""
    return 3 * F * (2 * R + 2) + 3 * F + F + 12 * F


def painn_l1_s(c: StateCounts, K: int, F: int, R: int, r_pad: int, M: int, n_species: int) -> float:
    """Row 1 (species-binned layer-1 message): 8 (R + 1) per live edge for
    the bins and 8 (R + 1) + 8 per (chain, centre, member, channel, species
    present) for the products; bytes: every slot's envelope, a live edge's
    rbf row, unit vector, neighbour and species, the weights and tables,
    the outputs. No tensor-core product."""
    flops = c.live_edges * 8 * (R + 1) + K * F * c.present * (8 * (R + 1) + 8)
    rows = n_pad(c.slots)
    tables = K * (n_species + 1) * 2 * F + K * r_pad * 2 * F + K * 2 * F + rows // 8
    nbytes = 4 * (c.chains * rows * M + c.live_edges * (r_pad + 5)
                  + c.chains * K * rows * 4 * F + tables)
    return bound_f32_s(flops, nbytes)


def painn_msg_s(c: StateCounts, K: int, F: int, R: int, r_pad: int, M: int) -> float:
    """Row 2 (general message): every argument and output whole; the
    filter (3F channels x 2R per edge and member) at 3 TF32 passes."""
    flops = K * c.live_edges * msg_flops_per_edge(F, R)
    products = K * c.live_edges * 6 * F * R
    rows = n_pad(c.slots)
    E = c.chains * rows * M
    nbytes = 4 * (2 * c.chains * K * rows * 3 * F + E * (r_pad + 2) + c.chains * 3 * rows * M
                  + K * r_pad * 3 * F + K * 3 * F + c.chains * K * rows * 4 * F)
    return bound_tc_s(products, flops - products, nbytes)


def painn_update_s(c: StateCounts, K: int, F: int) -> float:
    """Row 3 (update): 22 F^2 of products and ~30 F elementwise per alive
    row and member; an alive row's s and vcat read, every row written, the
    mask and the weights once."""
    rows = K * c.alive
    padded = c.chains * K * n_pad(c.slots)
    weights = K * (F * F * 2 + 2 * F * F + F + F * 3 * F + 3 * F)
    nbytes = 4 * (rows * 4 * F + padded * 4 * F + weights + c.chains * n_pad(c.slots))
    return bound_tc_s(rows * 22 * F * F, rows * 30 * F, nbytes)


def painn_eval_flops(c: StateCounts, K: int, F: int, R: int, n_layers: int, hidden: int) -> float:
    """Operations of one rigid PaiNN ensemble evaluation as the trunk runs
    it: layer 1's binned message, then per further layer the filter
    network on alive atoms and the general message; every layer's update;
    the readout."""
    l1 = c.live_edges * 8 * (R + 1) + K * F * c.present * (8 * (R + 1) + 8)
    filt = K * c.alive * 2 * (F * F + F * 3 * F)
    msg = K * c.live_edges * msg_flops_per_edge(F, R)
    upd = K * c.alive * (22 * F * F + 30 * F)
    readout = K * c.alive * 2 * (F * hidden + hidden)
    return l1 + (n_layers - 1) * (filt + msg) + n_layers * upd + readout


# ----------------------------------------------------------------------
# CHGNet row 10 (atom conv) and a whole evaluation
# ----------------------------------------------------------------------
def conv_flops_per_edge(F: int) -> int:
    """Row 10 per edge: be @ w2 (F x 2F) and h0 @ [wc1 | wg1] (2 x F x F)
    multiply-adds, ~30 F of activations, LayerNorms and gates."""
    return 8 * F * F + 30 * F


def chgnet_conv_s(c: StateCounts, F: int, M: int) -> float:
    """Row 10: the products (8 F^2 per live edge) at 3 TF32 passes; bytes:
    be and bw of the live edges, maskf and nbr of every edge slot, ai2 / aj2
    and the output of every row, the weights."""
    flops = c.live_edges * conv_flops_per_edge(F)
    products = c.live_edges * 8 * F * F
    rows = c.chains * n_pad(c.slots)
    weights = F * 2 * F + 2 * F * F + 2 * F + 4 * F
    nbytes = 4 * (rows * 2 * F * 2 + rows * M * 2 + weights + rows * F + c.live_edges * 2 * F)
    return bound_tc_s(products, flops - products, nbytes)


def chgnet_eval_flops(c: StateCounts, F: int, n_conv: int, hidden: int) -> float:
    """Operations of one CHGNet evaluation as the model runs it: per atom
    conv the per-atom pre-activations (8 F^2), the fused conv on live
    edges and the output layer (2 F^2); the readout MLP. The published
    model's bond graph and bond / angle updates reach no output, and the
    model does not run them."""
    atom = c.alive * (8 * F * F + 2 * F * F) + c.live_edges * conv_flops_per_edge(F)
    readout = c.alive * 2 * (F * hidden + 2 * hidden * hidden + hidden)
    return n_conv * atom + readout


def painn_general_flops(c: StateCounts, K: int, F: int, R: int, n_layers: int,
                        hidden: int) -> float:
    """Operations of one forward of the general (differentiable) PaiNN
    trunk: every layer's filter network and general message, update and
    the readout."""
    filt = K * c.alive * 2 * (F * F + F * 3 * F)
    msg = K * c.live_edges * msg_flops_per_edge(F, R)
    upd = K * c.alive * (22 * F * F + 30 * F)
    readout = K * c.alive * 2 * (F * hidden + hidden)
    return n_layers * (filt + msg + upd) + readout
