"""PaiNN forward, batched over chains and ensemble members: the rigid
static-edge trunk of the MC path and the general trunk of forces,
relaxation and the delta engine.

The counterpart of ``surface_sampling_tpu/models/painn.py``: the
configuration, the radial basis and envelope, the rigid trunk
(``painn_features_rigid``, banded for supercells, where it can also
collect every layer's inputs for the delta engine), the general,
differentiable trunk (``painn_features`` in the JAX package's "pallas"
message mode, without the layer-1 species table; banded for supercells) and
the readout with the excluded-volume term and the overflow override, the
parameter initialisation (``init_painn``, ``init_ensemble``) and the forward
of a padded batch of structures with their own image shifts
(``painn_apply_structures``: training and prediction). Parameters are a tree
of tensors with a leading member axis K (``models/weights.py``); features
carry two batch axes, chains C and members K: s is (C, K, n_pad, F) and
the vector features are kept x-major as vcat (C, K, n_pad, 3F) =
[v_x | v_y | v_z], the layout of the JAX package's fused kernels.

On the rigid trunk the three blocks of every layer run through
``ops/painn_kernels.py``: the layer-1 message from a per-species table,
the general message for layers 2+, and the update block. With a routing
band (supercells, ``ops/banding.py``) the trunk runs in the band's sorted
row order and the two messages are their banded kernels. The general trunk
runs the general message at every layer (layer 1 with v = 0, as the JAX
package does on a differentiated path), whose backward is the message
backward kernel (the banded one under a band); its update block is plain
PyTorch, as the JAX package leaves it to XLA there. Between the blocks only
the per-atom dense layers run here, as batched matrix products.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as tnf

from surface_sampling_tpu_torch.ops.neighbors import Edges, neighbor_list, padded_rows
from surface_sampling_tpu_torch.ops.banding import DeviceBand
from surface_sampling_tpu_torch.ops.painn_kernels import (
    painn_message_fused,
    painn_message_fused_banded,
    painn_message_l1,
    painn_message_l1_banded,
    painn_update_fused,
)


@dataclass(frozen=True)
class PaiNNConfig:
    feat_dim: int = 128
    n_rbf: int = 20
    cutoff: float = 5.0
    n_layers: int = 3
    max_z: int = 100
    excl_vol: bool = False
    power: float = 12.0
    sigma: float = 1.5
    readout_hidden: int = 64
    max_neighbors: int = 64


# ----------------------------------------------------------------------
# Parameter initialisation (training from scratch and tests; checkpoints
# override it)
# ----------------------------------------------------------------------
def _dense_init(gen: torch.Generator, n_in: int, n_out: int, bias: bool = True) -> dict:
    scale = 1.0 / math.sqrt(n_in)
    w = (torch.rand((n_in, n_out), generator=gen, device=gen.device) * 2.0 - 1.0) * scale
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(n_out, device=gen.device)
    return p


def init_painn(generator: torch.Generator, cfg: PaiNNConfig) -> dict:
    """One model's parameters (no member axis), drawn from ``generator``
    on its device with the JAX package's distributions (``init_painn``):
    atom embeddings N(0, 0.1^2), dense weights U(-1/sqrt(n_in),
    1/sqrt(n_in)), zero biases. The values differ from JAX's (another
    generator); the tree, shapes and distributions are the same."""
    F = cfg.feat_dim
    gen = generator
    params = {"atom_embed": torch.randn((cfg.max_z, F), generator=gen, device=gen.device) * 0.1,
              "message": [], "update": []}
    for _ in range(cfg.n_layers):
        params["message"].append({
            "inv_dense0": _dense_init(gen, F, F),
            "inv_dense1": _dense_init(gen, F, 3 * F),
            "dist_embed": _dense_init(gen, cfg.n_rbf, 3 * F),
        })
        params["update"].append({
            "u_mat": _dense_init(gen, F, F, bias=False),
            "v_mat": _dense_init(gen, F, F, bias=False),
            "s_dense0": _dense_init(gen, 2 * F, F),
            "s_dense1": _dense_init(gen, F, 3 * F),
        })
    params["readout"] = {"dense0": _dense_init(gen, F, cfg.readout_hidden),
                         "dense1": _dense_init(gen, cfg.readout_hidden, 1)}
    return params


def tree_map(fn, *trees):
    """``fn`` over the leaves of parameter trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a parameter tree in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def stack_members(trees) -> dict:
    """Models of one configuration stacked along a leading member axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_ensemble(generator: torch.Generator, cfg: PaiNNConfig, n_members: int) -> dict:
    """``n_members`` independently drawn models stacked along a leading
    member axis (the JAX package's ``init_ensemble``)."""
    return stack_members([init_painn(generator, cfg) for _ in range(n_members)])


def _rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel/sinc radial basis: sin(n pi d / rc) / d."""
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    dsafe = torch.clamp(d, min=1e-8)[..., None]
    return torch.sin(n * math.pi * dsafe / cutoff) / dsafe


def _cosine_envelope(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(d < cutoff, 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0),
                       torch.zeros_like(d))


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-member dense layer: x (..., K, n, i) @ w (K, i, o) + b (K, o),
    batched over the member axis (a broadcast matmul would copy w once per
    leading index)."""
    y = torch.einsum("...kni,kio->...kno", x, p["w"])
    if "b" in p:
        y = y + p["b"][:, None, :]
    return y


def painn_update(s, vcat, u, v, w0, b0, w1, b1, alive):
    """PaiNN update block over padded rows, batched over chains and members
    (the JAX package's ``_painn_update``): differentiable PyTorch, for the
    general trunk, whose forces and training differentiate through it, and
    the plain version of the rigid trunk's kernel
    (``ops.painn_kernels.painn_update_fused``, same arguments and layout).

        Uv_x = v_x @ u,  Vv_x = v_x @ v                 per axis x
        a    = silu([s, |Vv|] @ w0 + b0) @ w1 + b1      split a_vv | a_sv | a_ss
        s'   = (s + a_sv * <Uv, Vv> + a_ss) * alive
        v'_x = (v_x + a_vv * Uv_x) * alive

    with |Vv| = sqrt(sum_x Vv_x^2 + 1e-16); s (C, K, n_pad, F), vcat (C, K,
    n_pad, 3F) x-major, alive (C, n_pad) 0 on dead and padded rows.
    """
    C, K, n_pad, F = s.shape
    vx = vcat.reshape(C, K, n_pad, 3, F)
    # einsum batches the member axis: a broadcast matmul would copy each
    # member's weights once per (chain, row)
    uv = torch.einsum("cknxf,kfg->cknxg", vx, u)                     # (C, K, n, 3, F)
    vv = torch.einsum("cknxf,kfg->cknxg", vx, v)
    vv_norm = torch.sqrt((vv * vv).sum(dim=3) + 1e-16)
    h = tnf.silu(torch.einsum("ckni,kio->ckno", torch.cat([s, vv_norm], dim=-1), w0)
                 + b0[:, None, :])
    a = torch.einsum("ckni,kio->ckno", h, w1) + b1[:, None, :]
    a_vv, a_sv, a_ss = a[..., :F], a[..., F:2 * F], a[..., 2 * F:]
    inner = (uv * vv).sum(dim=3)
    am = alive[:, None, :, None]
    s_out = (s + a_sv * inner + a_ss) * am
    v_out = (vx + a_vv[..., None, :] * uv) * am[..., None]
    return s_out, v_out.reshape(C, K, n_pad, 3 * F)


def update_weights(up: dict) -> tuple:
    """A layer's update weights in the order of ``painn_update_fused``."""
    return (up["u_mat"]["w"], up["v_mat"]["w"], up["s_dense0"]["w"], up["s_dense0"]["b"],
            up["s_dense1"]["w"], up["s_dense1"]["b"])


def message_weights(mp: dict, cfg: PaiNNConfig, r_pad: int) -> tuple:
    """A layer's dist_embed weights, the radial axis zero-padded to r_pad."""
    dw = tnf.pad(mp["dist_embed"]["w"], (0, 0, 0, r_pad - cfg.n_rbf)).contiguous()
    return dw, mp["dist_embed"]["b"].contiguous()


def filter_features(mp: dict, s: torch.Tensor) -> torch.Tensor:
    """phi = inv_dense1(silu(inv_dense0(s))), the message block's filter
    side."""
    return _dense(mp["inv_dense1"], tnf.silu(_dense(mp["inv_dense0"], s)))


def with_halo(x: torch.Tensor, halo: int, dim: int) -> torch.Tensor:
    """A sorted table extended by the band's halo: rows [0, halo) along
    ``dim`` appended after the last row."""
    if halo == 0:
        return x.contiguous()
    return torch.cat([x, x.narrow(dim, 0, halo)], dim=dim)


def rigid_member_weights(params: dict, cfg: PaiNNConfig, l1_types, r_pad: int) -> dict:
    """Weights of the rigid trunk derived once per potential.

    ``philt`` (K, T+1, 2F) is the layer-1 phi of each species, sliced to
    the live s|unit channels (v == 0 at layer 1 kills the vv third); row T
    is zero and stands for dead and padded slots. ``dw``/``db`` are every
    layer's dist_embed weights with the radial axis zero-padded to
    ``r_pad``; ``dw2``/``db2`` layer 1's, sliced like ``philt``.
    """
    F = cfg.feat_dim
    emb = params["atom_embed"]                                       # (K, max_z, F)
    types = torch.as_tensor([min(max(int(z), 0), cfg.max_z - 1) for z in l1_types],
                            device=emb.device)
    mp0 = params["message"][0]
    phi_t = filter_features(mp0, emb[:, types])                      # (K, T, 3F)
    philt = tnf.pad(phi_t[..., F:], (0, 0, 0, 1)).contiguous()       # (K, T+1, 2F)
    dw, db = zip(*(message_weights(mp, cfg, r_pad) for mp in params["message"]))
    return {
        "philt": philt,
        "dw": dw,
        "db": db,
        "dw2": dw[0][..., F:].contiguous(),
        "db2": db[0][..., F:].contiguous(),
        "species_of_z": _species_table(l1_types, cfg.max_z, emb.device),
    }


def _species_table(l1_types, max_z: int, device) -> torch.Tensor:
    """(max_z,) int32 map from atomic number to its row of ``philt``; every
    other number (0 = dead slot included) maps to the zero row T."""
    table = torch.full((max_z,), len(l1_types), dtype=torch.int32)
    for t, z in enumerate(l1_types):
        table[int(z)] = t
    return table.to(device)


def species_rows(rw: dict, cfg: PaiNNConfig, numbers: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(C, n_pad) int32 row of ``rw["philt"]`` for every slot of a (C, N)
    batch of atomic numbers; padded rows get the zero row."""
    z = torch.clamp(numbers, 0, cfg.max_z - 1)
    return tnf.pad(rw["species_of_z"][z], (0, n_pad - numbers.shape[1]),
                   value=rw["philt"].shape[1] - 1)


def painn_features_rigid(params: dict, rw: dict, cfg: PaiNNConfig,
                          numbers: torch.Tensor, alive: torch.Tensor,
                          msg_geom, band=None, collect_layers: bool = False):
    """Rigid trunk over padded rows; returns s (C, K, N, F).

    ``numbers``/``alive`` are (C, N); ``msg_geom`` comes from
    ``ops.static_edges.static_edge_geometry``. With ``band`` (the pack's
    ``DeviceBand``) the geometry is in sorted order, every layer runs on
    sorted rows through the banded message kernels, and s is put back in
    slot order at the end.

    ``collect_layers`` returns instead ``(s, (s_l, phi_l, vcat_l))``: the
    final s and the inputs of every message block (L tensors (C, K, n_pad,
    .) each, layer 1's phi included), all padded and in the band's sorted
    row order where there is a band: the caches of ``core/incremental.py``.
    Layer 1's message then runs the general message kernel on phi and v = 0
    (not the species table), the body of the subset kernel with which the
    delta engine recomputes those rows, so that they come out bitwise the
    same; of ``rw`` it reads only ``dw`` and ``db``."""
    rbf, envm, nbr, unit, n_pad = msg_geom
    C, N = numbers.shape
    K = params["atom_embed"].shape[0]
    F = cfg.feat_dim
    pad_n = n_pad - N

    z = torch.clamp(numbers, 0, cfg.max_z - 1)
    # the layer-1 species rows (collect_layers runs layer 1 without them)
    species = None if collect_layers else species_rows(rw, cfg, numbers, n_pad)
    alive_f = tnf.pad(alive.to(torch.float32), (0, pad_n))           # (C, n_pad)
    s = params["atom_embed"][:, z].transpose(0, 1)                   # (C, K, N, F)
    s = tnf.pad(s * alive_f[:, None, :N, None], (0, 0, 0, pad_n))
    if band is not None:
        alive_f, s = alive_f[:, band.perm], s[:, :, band.perm]
        species = None if species is None else species[:, band.perm]
    s = s.contiguous()
    vcat = torch.zeros((C, K, n_pad, 3 * F), dtype=s.dtype, device=s.device)

    layers = ([], [], [])
    for li, (mp, up) in enumerate(zip(params["message"], params["update"])):
        # layer 1 reads phi from the species table; only the caches need it
        phi = filter_features(mp, s) if li > 0 or collect_layers else None
        if collect_layers:
            for store, x in zip(layers, (s, phi, vcat)):
                store.append(x)
        if li == 0 and band is None and not collect_layers:
            ds, dv = painn_message_l1(species, rw["philt"], rbf, envm, nbr, unit,
                                      rw["dw2"], rw["db2"])
        elif li == 0 and not collect_layers:
            ds, dv = painn_message_l1_banded(with_halo(species, band.halo, 1), rw["philt"],
                                             rbf, envm, nbr, unit, rw["dw2"], rw["db2"], band)
        elif band is None:
            ds, dv = painn_message_fused(phi.contiguous(), vcat, rbf, envm, nbr, unit,
                                         rw["dw"][li], rw["db"][li])
        else:
            ds, dv = painn_message_fused_banded(
                with_halo(phi, band.halo, 2), with_halo(vcat, band.halo, 2),
                rbf, envm, nbr, unit, rw["dw"][li], rw["db"][li], band)
        s, vcat = painn_update_fused(s + ds, vcat + dv, *update_weights(up), alive_f)
    if collect_layers:
        return s, layers
    if band is not None:
        s = s[:, :, band.inv_perm]
    return s[:, :, :N]


def prepare_message_geometry(cfg: PaiNNConfig, edges: Edges, band: DeviceBand | None = None):
    """Pad and flatten edge geometry for the message kernels, once per
    structure batch (it is layer- and member-invariant). Differentiable in
    ``edges.disp`` and ``edges.r``.

    Returns ``(rbf (C, E, r_pad), envm (C, E), nbr (C, E) int32,
    unit (C, 3, n_pad, M), n_pad, rev)`` with E = n_pad * M and
    envm = envelope * edge mask. Without ``band``: slot order, nbr the
    neighbour's slot, rev the (C, n_pad, D) reverse table. With the routing
    ``band`` of a supercell (the JAX package's ``prepare_fused_geometry``
    with a band): rows in the band's sorted order (``band.perm``), nbr the
    neighbour's sorted rank, rev the banded reverse table keyed by extended
    row that the edges carry (``edges.rev_band``)."""
    disp, d, nbr_j, nbr_mask = edges[:4]
    C, N, M = d.shape
    n_pad = padded_rows(N)
    r_pad = ((cfg.n_rbf + 7) // 8) * 8
    pad_n = n_pad - N
    unit = disp / torch.clamp(d, min=1e-8)[..., None]                # (C, N, M, 3)
    rbf = _rbf(d, cfg.n_rbf, cfg.cutoff)                             # (C, N, M, R)
    envm = _cosine_envelope(d, cfg.cutoff) * nbr_mask.to(d.dtype)
    rbf_p = tnf.pad(rbf, (0, r_pad - cfg.n_rbf, 0, 0, 0, pad_n))
    envm_p = tnf.pad(envm, (0, 0, 0, pad_n))
    nbr_p = tnf.pad(nbr_j, (0, 0, 0, pad_n))
    unit_p = tnf.pad(unit, (0, 0, 0, 0, 0, pad_n))
    rev = edges.rev
    if band is not None:
        if band.n_pad != n_pad:
            raise ValueError(f"the band covers {band.n_pad} padded slots, the edges {n_pad}")
        if edges.rev_band is None:
            raise ValueError("banded message geometry needs edges built with the band "
                             "(their banded reverse table)")
        p = band.perm
        rbf_p, envm_p, unit_p = rbf_p[:, p], envm_p[:, p], unit_p[:, p]
        nbr_p = band.rank[nbr_p[:, p]]
        rev = edges.rev_band
    return (rbf_p.reshape(C, n_pad * M, r_pad).contiguous(),
            envm_p.reshape(C, n_pad * M).contiguous(),
            nbr_p.reshape(C, n_pad * M).to(torch.int32).contiguous(),
            unit_p.permute(0, 3, 1, 2).contiguous(), n_pad, rev)


def painn_features(params: dict, cfg: PaiNNConfig, numbers: torch.Tensor,
                   alive: torch.Tensor, msg_geom, band: DeviceBand | None = None,
                   collect_layers: bool = False):
    """General trunk over padded rows, differentiable in the edge
    geometry; returns s (C, K, N, F). ``msg_geom`` comes from
    :func:`prepare_message_geometry` (with the same ``band``).

    ``collect_layers`` returns instead ``(s, (layer_s, layer_v))``: the
    inputs of every message block, layer_s (C, K, L, N, F) and layer_v
    (C, K, L, N, 3F) x-major, in slot order (the JAX package's layer_s and
    layer_v, whose v is (L, N, F, 3)): the frozen far field of
    ``core/ff_relax.py``.

    With the routing ``band`` of a supercell every layer runs on the
    band's sorted rows: the message is the banded kernel over the tables
    extended by the halo (whose cotangents fold back through the
    concatenation's own backward), and the update and dense layers act row
    by row, so the trunk permutes s once on the way in and once on the way
    out instead of phi, vcat, ds and dv at every layer as the JAX package
    does (the same function)."""
    rbf, envm, nbr, unit, n_pad, rev = msg_geom
    C, N = numbers.shape
    K = params["atom_embed"].shape[0]
    F = cfg.feat_dim
    pad_n = n_pad - N

    z = torch.clamp(numbers, 0, cfg.max_z - 1)
    alive_f = tnf.pad(alive.to(torch.float32), (0, pad_n))           # (C, n_pad)
    s = params["atom_embed"][:, z].transpose(0, 1)                   # (C, K, N, F)
    s = tnf.pad(s * alive_f[:, None, :N, None], (0, 0, 0, pad_n))
    if band is not None:
        if band.n_pad != n_pad:
            raise ValueError(f"the band covers {band.n_pad} padded slots, the geometry {n_pad}")
        s, alive_f = s[:, :, band.perm], alive_f[:, band.perm]
    vcat = torch.zeros((C, K, n_pad, 3 * F), dtype=s.dtype, device=s.device)

    layers = ([], [])
    for mp, up in zip(params["message"], params["update"]):
        if collect_layers:
            layers[0].append(s)
            layers[1].append(vcat)
        dw, db = message_weights(mp, cfg, rbf.shape[-1])
        phi = filter_features(mp, s)
        if band is None:
            ds, dv = painn_message_fused(phi.contiguous(), vcat.contiguous(), rbf, envm, nbr,
                                         unit, dw, db, rev)
        else:
            ds, dv = painn_message_fused_banded(with_halo(phi, band.halo, 2),
                                                with_halo(vcat, band.halo, 2), rbf, envm, nbr,
                                                unit, dw, db, band, rev)
        s, vcat = painn_update(s + ds, vcat + dv, *update_weights(up), alive_f)
    if band is not None:
        s = s[:, :, band.inv_perm]
    if not collect_layers:
        return s[:, :, :N]
    order = band.inv_perm[:N] if band is not None else slice(0, N)
    return s[:, :, :N], tuple(torch.stack(x, dim=2)[:, :, :, order] for x in layers)


def atom_energies(params: dict, s: torch.Tensor) -> torch.Tensor:
    """Readout: raw per-atom energies (..., K, n) of features s
    (..., K, n, F)."""
    h = tnf.silu(_dense(params["readout"]["dense0"], s))
    return _dense(params["readout"]["dense1"], h)[..., 0]


def excluded_volume(cfg: PaiNNConfig, r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-atom (sigma/d)^power summed over the selected directed edges,
    (C, n) from r and mask (C, n, M); zero without ``excl_vol``."""
    if not cfg.excl_vol:
        return torch.zeros(r.shape[:-1], dtype=r.dtype, device=r.device)
    r_pow = (cfg.sigma / torch.clamp(r, min=1e-3)) ** cfg.power
    return torch.where(mask, r_pow, torch.zeros_like(r_pow)).sum(dim=-1)


def _readout(params: dict, cfg: PaiNNConfig, s: torch.Tensor, alive: torch.Tensor,
             r: torch.Tensor, nbr_mask: torch.Tensor, overflow: torch.Tensor) -> dict:
    """Per-atom energies from the final features s (C, K, N, F), the
    excluded-volume term over the selected edges, and the overflow
    override. A chain whose neighbor graph overflowed gets the energy 1e6
    in place of the sum: a truncated graph makes the network emit
    arbitrary values, and an override (not a penalty) lets the
    Metropolis/OOB machinery reject the state whatever they are."""
    e_atom = atom_energies(params, s)                                # (C, K, N)
    e_atom = torch.where(alive[:, None, :], e_atom, torch.zeros_like(e_atom))
    if cfg.excl_vol:
        e_atom = e_atom + excluded_volume(cfg, r, nbr_mask)[:, None, :]
    e_tot = torch.where(overflow[:, None], torch.full_like(e_atom[..., 0], 1e6),
                        e_atom.sum(dim=-1))
    return {"energy": e_tot, "per_atom_energy": e_atom}


def painn_apply_rigid(params: dict, rw: dict, cfg: PaiNNConfig,
                      numbers: torch.Tensor, alive: torch.Tensor,
                      msg_geom, edges, band=None) -> dict:
    """Full rigid forward of every member (training units): ``energy``
    (C, K) per member and ``per_atom_energy`` (C, K, N). ``edges`` is
    (r, mask, overflow) from ``ops.static_edges.static_edge_geometry``;
    ``band`` the pack's ``DeviceBand``, if it has one."""
    s = painn_features_rigid(params, rw, cfg, numbers, alive, msg_geom, band)
    return _readout(params, cfg, s, alive, *edges)


def painn_apply(params: dict, cfg: PaiNNConfig, numbers: torch.Tensor,
                alive: torch.Tensor, msg_geom, edges: Edges,
                band: DeviceBand | None = None, collect_layers: bool = False) -> dict:
    """Full general forward of every member, differentiable in the
    positions the edges were built from: ``energy`` (C, K) and
    ``per_atom_energy`` (C, K, N) in training units, and ``embedding``
    (C, K, N, F), the final scalar features; banded under ``band``
    (``msg_geom`` then built with it). ``collect_layers`` adds
    ``layer_s`` / ``layer_v``, the inputs of every message block
    (:func:`painn_features`)."""
    s = painn_features(params, cfg, numbers, alive, msg_geom, band, collect_layers)
    if collect_layers:
        s, (layer_s, layer_v) = s
    out = _readout(params, cfg, s, alive, edges.r, edges.mask, edges.overflow)
    out["embedding"] = s
    if collect_layers:
        out["layer_s"], out["layer_v"] = layer_s, layer_v
    return out


def painn_apply_structures(params: dict, cfg: PaiNNConfig, positions: torch.Tensor,
                           numbers: torch.Tensor, shifts: torch.Tensor) -> dict:
    """Forward of every member on a padded batch of structures, each with
    its own image shifts: the JAX package's ``painn_apply`` batched over
    structures C (and members K), twice differentiable in the positions.

    It builds the edges (``ops.neighbors.neighbor_list``: the M =
    ``cfg.max_neighbors`` nearest in-range image pairs), then the padded
    message geometry, the general trunk (the message kernel and its
    backward kernels) and the readout.

    Args:
        params: a stacked tree (leading member axis K).
        positions: (C, N, 3) f32; numbers: (C, N) int, 0 = padding;
            shifts: (C, Ks, 3) f32 image shifts, unused slots far away.
    Returns:
        ``energy`` (C, K) (1e6 where the neighbour list overflowed, as in
        the JAX package), ``per_atom_energy`` (C, K, N), ``embedding``
        (C, K, N, F) (the final scalar features) and ``overflow`` (C,), in
        training units.
    """
    edges, msg_geom = structure_edges(cfg, positions, numbers, shifts)
    out = painn_apply(params, cfg, numbers, numbers > 0, msg_geom, edges)
    out["overflow"] = edges.overflow
    return out


def structure_edges(cfg: PaiNNConfig, positions: torch.Tensor, numbers: torch.Tensor,
                    shifts: torch.Tensor):
    """The member-invariant part of :func:`painn_apply_structures`: the
    edges of a padded batch of structures and their padded message
    geometry, ``(edges, msg_geom)`` for :func:`painn_apply`."""
    edges = neighbor_list(positions, shifts, numbers > 0, cfg.cutoff, cfg.max_neighbors)
    return edges, prepare_message_geometry(cfg, edges)
