"""MACE-style equivariant model, batched over chains: the third model
family of the port.

The counterpart of ``surface_sampling_tpu/models/mace.py`` (a from-paper
MACE-style architecture, Batatia et al., NeurIPS 2022, with L_max <= 3 and
correlation order nu <= 3). Per layer, with per-channel atomic bases built
from the neighbours' projected features (k = channel):

    A^0_i,k = sum_j R^0_k(r_ij) (W0 h_j)_k                    (scalars)
    A^1_i,k = sum_j R^1_k(r_ij) rhat_ij (W1 h_j)_k            (l = 1)
    A^2_i,k = sum_j R^2_k(r_ij) Y2(rhat_ij) (W2 h_j)_k        (l = 2, a 3x3
              symmetric traceless matrix T per channel)
    A^3_i,k = sum_j R^3_k(r_ij) Y3(rhat_ij) (W3 h_j)_k        (l = 3)
    B_i     = the exact rotation invariants up to nu = 3 of the JAX
              package (9 for l_max 2, 13 for l_max 3)
    h_i    += MLP(B_i),  E_i += readout(h_i)

and, with ``equivariant_messages``, the JAX package's equivariant node
features V (N, F, 3) and T (N, F, 3, 3) carried across layers through
every parity-even Clebsch-Gordan path. Every function carries a leading
chain axis C; parameters are the JAX package's tree of tensors
(``models/weights.from_jax_params``), one model with no member axis.

The JAX package has no Pallas kernel for MACE: its "dense" message mode
routes the neighbour features by one one-hot matrix product, which selects
rows and so computes the gather form exactly. Here every mode computes the
gather form. The neighbour rows of a layer go through one fixed-order
gather (``ops.neighbors._GatherRows`` over the edges' reverse table), whose
backward is a gather and a sum in a fixed order instead of a float
scatter-add with atomics, so that forces and relaxed runs repeat bitwise on
the card; the per-centre sums over neighbours are contractions over a fixed
axis. Matrix products run in f32 without TF32 (``device.resolve_device``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tnf

from surface_sampling_tpu_torch.models.chgnet import polynomial_envelope
from surface_sampling_tpu_torch.models.nn_calculator import UNIT_FACTORS, TablePotential
from surface_sampling_tpu_torch.ops.neighbors import (
    Edges,
    _GatherRows,
    image_search_edges,
    stage_candidate_table,
)

MESSAGE_MODES = ("auto", "gather", "dense")


@dataclass(frozen=True)
class MACEConfig:
    """The JAX package's configuration, every field. ``message_mode``
    chooses the JAX package's routing of neighbour features; here every
    mode computes the same gather."""

    feat_dim: int = 64
    n_rbf: int = 8
    cutoff: float = 5.0
    n_layers: int = 2
    max_z: int = 94
    max_neighbors: int = 64
    readout_hidden: int = 16
    envelope_p: int = 6
    l_max: int = 2               # 1, 2 or 3
    equivariant_messages: bool = False   # carry V/T node features across layers
    message_mode: str = "auto"


def _n_invariants(l_max: int) -> int:
    return {1: 5, 2: 9, 3: 13}[l_max]


# ----------------------------------------------------------------------
# Parameter initialisation
# ----------------------------------------------------------------------
def _init_lin(gen: torch.Generator, n_in: int, n_out: int, bias: bool = True) -> dict:
    s = 1.0 / math.sqrt(n_in)
    p = {"w": (torch.rand((n_in, n_out), generator=gen, device=gen.device) * 2.0 - 1.0) * s}
    if bias:
        p["b"] = torch.zeros(n_out, device=gen.device)
    return p


def init_mace(generator: torch.Generator, cfg: MACEConfig) -> dict:
    """One model's parameters drawn from ``generator`` on its device with
    the JAX package's tree, shapes and laws (``init_mace``): atom
    embeddings N(0, 0.2^2), zero per-element reference energies, linear
    weights U(-1/sqrt(n_in), 1/sqrt(n_in)), zero biases. The values differ
    from JAX's (another generator)."""
    if cfg.l_max not in (1, 2, 3):
        raise ValueError(f"l_max must be 1, 2 or 3, got {cfg.l_max}")
    gen, dev = generator, generator.device
    F, R = cfg.feat_dim, cfg.n_rbf
    params = {
        "atom_embed": torch.randn((cfg.max_z, F), generator=gen, device=dev) * 0.2,
        "atom_ref": torch.zeros(cfg.max_z, device=dev),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "w0": _init_lin(gen, F, F, bias=False),
            "w1": _init_lin(gen, F, F, bias=False),
            "rad0": _init_lin(gen, R, F),
            "rad1": _init_lin(gen, R, F),
            "update0": _init_lin(gen, _n_invariants(cfg.l_max) * F, F),
            "update1": _init_lin(gen, F, F),
            "readout": _init_lin(gen, F, 1),
        }
        if cfg.l_max >= 2:
            layer["w2"] = _init_lin(gen, F, F, bias=False)
            layer["rad2"] = _init_lin(gen, R, F)
        if cfg.l_max >= 3:
            layer["w3"] = _init_lin(gen, F, F, bias=False)
            layer["rad3"] = _init_lin(gen, R, F)
        if cfg.equivariant_messages:
            for name, bias in (("w0v", False), ("rad0v", True), ("w1v", False), ("rad1v", True),
                               ("v_upd", False), ("v_gate", True)):
                layer[name] = _init_lin(gen, R if name.startswith("rad") else F, F, bias)
            if cfg.l_max >= 2:
                for name, bias in (("w1t", False), ("rad1t", True), ("w2v", False),
                                   ("rad2v", True), ("w2t", False), ("rad2t", True),
                                   ("t_upd", False), ("t_prod", False), ("t_gate", True)):
                    layer[name] = _init_lin(gen, R if name.startswith("rad") else F, F, bias)
        params["layers"].append(layer)
    return params


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def _apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _bessel(r: torch.Tensor, n_rbf: int, cutoff: float, p_env: int) -> torch.Tensor:
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rs = torch.clamp(r, min=1e-8)[..., None]
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rs / cutoff) / rs
    return basis * polynomial_envelope(r, cutoff, p_env)[..., None]


def _y2_matrix(unit: torch.Tensor) -> torch.Tensor:
    """u u^T - I/3 of unit vectors (..., 3): the rank-2 spherical tensor."""
    eye = torch.eye(3, dtype=unit.dtype, device=unit.device) / 3.0
    return unit[..., :, None] * unit[..., None, :] - eye


def _y3_tensor(unit: torch.Tensor) -> torch.Tensor:
    """The symmetric traceless part of u o u o u (l = 3)."""
    u = unit
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    uuu = u[..., :, None, None] * u[..., None, :, None] * u[..., None, None, :]
    tr = (eye[:, :, None] * u[..., None, None, :] + eye[:, None, :] * u[..., None, :, None]
          + eye[None, :, :] * u[..., :, None, None]) / 5.0
    return uuu - tr


def _route(xs: dict, nbr_j: torch.Tensor, rev: torch.Tensor) -> dict:
    """Node tensors (C, N, ...) -> their rows at every edge's neighbour
    (C, N, M, ...), all of a layer's in one fixed-order gather."""
    C, N = nbr_j.shape[:2]
    flats = [x.reshape(C, N, -1) for x in xs.values()]
    routed = _GatherRows.apply(torch.cat(flats, dim=-1), nbr_j, rev)
    out, o = {}, 0
    for (k, x), f in zip(xs.items(), flats):
        out[k] = routed[..., o:o + f.shape[-1]].reshape(routed.shape[:3] + x.shape[2:])
        o += f.shape[-1]
    return out


def mace_apply(params: dict, cfg: MACEConfig, positions: torch.Tensor, numbers: torch.Tensor,
               alive: torch.Tensor, shifts=None, edges: Edges | None = None) -> dict:
    """Forward over a (C, N) batch of structures, differentiable in the
    positions the edges were built from: ``per_atom_energy`` (C, N),
    ``energy`` (C,) (plus 1e6 where a chain's neighbour graph overflowed,
    as in the JAX package) and ``embedding`` (C, N, F), the final scalar
    features. ``edges`` come from a static candidate table
    (``ops.neighbors.make_table_edge_fn``, the MC path) or, when None, from
    image search over ``shifts`` ((K, 3) or (C, K, 3))."""
    if cfg.message_mode not in MESSAGE_MODES:
        raise ValueError(f"message_mode must be one of {MESSAGE_MODES}, got {cfg.message_mode!r}")
    if edges is None:
        edges = image_search_edges(positions, alive, shifts, cfg.cutoff, cfg.max_neighbors)
    disp, r, nbr_j, nbr_mask, overflow = edges[:5]
    dtype = r.dtype
    fmask = nbr_mask.to(dtype)[..., None]                             # (C, N, M, 1)
    unit = disp / torch.clamp(r, min=1e-8)[..., None]                 # (C, N, M, 3)
    rbf = _bessel(r, cfg.n_rbf, cfg.cutoff, cfg.envelope_p)           # (C, N, M, R)

    z_idx = torch.clamp(numbers - 1, 0, cfg.max_z - 1)
    alive_f = alive.to(dtype)
    h = params["atom_embed"][z_idx] * alive_f[..., None]               # (C, N, F)
    e_atom = params["atom_ref"][z_idx] * alive_f
    y2 = _y2_matrix(unit) if cfg.l_max >= 2 else None                 # (C, N, M, 3, 3)
    y3 = _y3_tensor(unit) if cfg.l_max >= 3 else None                 # (C, N, M, 3, 3, 3)
    eq = cfg.equivariant_messages
    C, N, F = h.shape
    eye3 = torch.eye(3, dtype=dtype, device=h.device)
    v_feat = torch.zeros((C, N, F, 3), dtype=dtype, device=h.device) if eq else None
    t_feat = (torch.zeros((C, N, F, 3, 3), dtype=dtype, device=h.device)
              if eq and cfg.l_max >= 2 else None)
    for lp in params["layers"]:
        # mix channels at the node, then route the whole set once
        proj = {"h0": _apply(lp["w0"], h), "h1": _apply(lp["w1"], h)}
        if cfg.l_max >= 2:
            proj["h2"] = _apply(lp["w2"], h)
        if cfg.l_max >= 3:
            proj["h3"] = _apply(lp["w3"], h)
        if eq:
            proj["v0"] = torch.einsum("cnfx,fg->cngx", v_feat, lp["w0v"]["w"])
            proj["v1"] = torch.einsum("cnfx,fg->cngx", v_feat, lp["w1v"]["w"])
            if t_feat is not None:
                proj["t1"] = torch.einsum("cnfab,fg->cngab", t_feat, lp["w1t"]["w"])
                proj["v2"] = torch.einsum("cnfx,fg->cngx", v_feat, lp["w2v"]["w"])
                proj["t2n"] = torch.einsum("cnfab,fg->cngab", t_feat, lp["w2t"]["w"])
        rj = _route(proj, nbr_j, edges.rev)

        a0 = (_apply(lp["rad0"], rbf) * rj["h0"] * fmask).sum(dim=2)  # (C, N, F)
        a1 = torch.einsum("cnmf,cnmx->cnfx", _apply(lp["rad1"], rbf) * rj["h1"] * fmask, unit)
        if eq:
            r0v = _apply(lp["rad0v"], rbf) * fmask                     # (C, N, M, F)
            a0 = a0 + (r0v * (rj["v0"] * unit[:, :, :, None, :]).sum(-1)).sum(dim=2)
            r1v = (_apply(lp["rad1v"], rbf) * fmask)[..., None]
            a1 = a1 + (r1v * rj["v1"]).sum(dim=2)
            if t_feat is not None:
                r1t = (_apply(lp["rad1t"], rbf) * fmask)[..., None]
                a1 = a1 + (r1t * torch.einsum("cnmfab,cnmb->cnmfa", rj["t1"], unit)).sum(dim=2)
        a1n2 = (a1 * a1).sum(-1)                                       # (C, N, F)
        feats = [a0, a0 * a0, a0 ** 3, a1n2, a0 * a1n2]
        t2 = None
        if cfg.l_max >= 2:
            w2 = _apply(lp["rad2"], rbf) * rj["h2"] * fmask            # (C, N, M, F)
            t2 = torch.einsum("cnmf,cnmab->cnfab", w2, y2)             # (C, N, F, 3, 3)
            if eq:
                # 1 x 1 -> 2: symmetric-traceless (V_j o rhat)
                v2 = rj["v2"]
                r2v = (_apply(lp["rad2v"], rbf) * fmask)[..., None, None]
                outer = 0.5 * (v2[..., :, None] * unit[:, :, :, None, None, :]
                               + v2[..., None, :] * unit[:, :, :, None, :, None])
                trce = (v2 * unit[:, :, :, None, :]).sum(-1)           # (C, N, M, F)
                outer = outer - (trce[..., None, None] / 3.0) * eye3
                t2 = t2 + (r2v * outer).sum(dim=2)
                # 2 x 0 -> 2: neighbour tensor features carried through
                r2t = (_apply(lp["rad2t"], rbf) * fmask)[..., None, None]
                t2 = t2 + (r2t * rj["t2n"]).sum(dim=2)
            t2n2 = (t2 * t2).sum(dim=(-2, -1))
            v_t_v = torch.einsum("cnfa,cnfab,cnfb->cnf", a1, t2, a1)
            t3 = torch.einsum("cnfab,cnfbd,cnfda->cnf", t2, t2, t2)   # tr(T^3)
            feats += [t2n2, a0 * t2n2, v_t_v, t3]
        if cfg.l_max >= 3:
            # the l = 3 basis is layer-local: |A3|^2, A0 |A3|^2, A3:A1:T, A3:A3:T
            w3 = _apply(lp["rad3"], rbf) * rj["h3"] * fmask
            a3 = torch.einsum("cnmf,cnmabd->cnfabd", w3, y3)           # (C, N, F, 3, 3, 3)
            a3n2 = (a3 * a3).sum(dim=(-3, -2, -1))
            feats += [a3n2, a0 * a3n2,
                      torch.einsum("cnfabd,cnfa,cnfbd->cnf", a3, a1, t2),
                      torch.einsum("cnfabe,cnfabd,cnfed->cnf", a3, a3, t2)]
        b = torch.cat(feats, dim=-1)
        h = h + _apply(lp["update1"], tnf.silu(_apply(lp["update0"], b)))
        h = torch.where(alive[..., None], h, torch.zeros_like(h))
        if eq:
            # residual equivariant node updates, gated by the invariant h
            gate_v = torch.sigmoid(_apply(lp["v_gate"], h))
            v_feat = (torch.einsum("cnfx,fg->cngx", a1, lp["v_upd"]["w"])
                      + gate_v[..., None] * v_feat)
            v_feat = torch.where(alive[..., None, None], v_feat, torch.zeros_like(v_feat))
            if t_feat is not None:
                gate_t = torch.sigmoid(_apply(lp["t_gate"], h))
                prod = a1[..., :, None] * a1[..., None, :] - (a1n2[..., None, None] / 3.0) * eye3
                t_feat = (torch.einsum("cnfab,fg->cngab", t2, lp["t_upd"]["w"])
                          + torch.einsum("cnfab,fg->cngab", prod, lp["t_prod"]["w"])
                          + gate_t[..., None, None] * t_feat)
                t_feat = torch.where(alive[..., None, None, None], t_feat,
                                     torch.zeros_like(t_feat))
        e_layer = _apply(lp["readout"], tnf.silu(h))[..., 0]
        e_atom = e_atom + torch.where(alive, e_layer, torch.zeros_like(e_layer))

    total = e_atom.sum(dim=1) + torch.where(overflow, 1e6, 0.0).to(dtype)
    return {"per_atom_energy": e_atom, "energy": total, "embedding": h}


# ----------------------------------------------------------------------
# Potential
# ----------------------------------------------------------------------
class MACEPotential(TablePotential):
    """MACE energy of (C, N) batches of structures: ``energy(positions,
    type_idx, alive, shifts)`` (C,) in eV, forces by one backward pass,
    edges over a static table (with the relaxation hooks) or by image
    search (``models.nn_calculator.TablePotential``)."""

    name = "mace"

    def __init__(self, params: dict, cfg: MACEConfig, znums, factor, table):
        self.params, self.cfg = params, cfg
        self.cutoff = cfg.cutoff
        self.znums, self.factor = znums, factor
        self._init_edges(table)

    def outputs(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """Model outputs (:func:`mace_apply`), training units."""
        if edges is None:
            edges = self.edges(positions, alive, shifts)
        numbers = self.znums[type_idx] * alive.to(torch.int64)
        return mace_apply(self.params, self.cfg, positions, numbers, alive, edges=edges)

    def energy(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """(C,) potential energies in eV of positions (C, N, 3)."""
        return self.outputs(positions, type_idx, alive, shifts, edges)["energy"] * self.factor

    def per_atom(self, positions, type_idx, alive, shifts=None):
        """(C, N) per-atom energies in eV."""
        return self.outputs(positions, type_idx, alive, shifts)["per_atom_energy"] * self.factor


def make_mace_potential(params: dict, cfg: MACEConfig, type_numbers, units: str = "eV",
                        static_nbr=None, device: torch.device | None = None):
    """Wrap a MACE model (a tree of tensors, no member axis) as a potential.

    ``static_nbr``: the spec's ``StaticNeighborTable`` (positions passed in
    must then be slot-realized geometries of that spec; the potential
    carries the relaxation hooks); None finds the edges by image search on
    every call and keeps ``mace_args``, the rebuild hook. ``device``: where
    the tables live (default: the parameters')."""
    device = device if device is not None else params["atom_embed"].device
    table = (None if static_nbr is None
             else stage_candidate_table(static_nbr, cfg.cutoff, cfg.max_neighbors, device))
    znums = torch.as_tensor(np.asarray(type_numbers), dtype=torch.int64, device=device)
    pot = MACEPotential(params, cfg, znums, UNIT_FACTORS[units], table)
    if static_nbr is None:
        pot.mace_args = dict(params=params, cfg=cfg, type_numbers=type_numbers, units=units)
    return pot


# ----------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------
def save_mace_npz(path, params: dict, cfg: MACEConfig) -> None:
    """Write a model in the JAX package's flat npz scheme (dotted keys,
    ``__cfg__<field>``), which its ``load_mace_npz`` reads."""
    from surface_sampling_tpu_torch.models.weights import _flatten

    meta = {f"__cfg__{k}": np.asarray(v) for k, v in cfg.__dict__.items()}
    np.savez_compressed(path, **_flatten(params), **meta)


def load_mace_npz(path) -> tuple[dict, MACEConfig]:
    """(params as a tree of numpy arrays, MACEConfig) of a file written by
    either package's ``save_mace_npz``
    (``models.weights.from_jax_params`` makes the tensors)."""
    from surface_sampling_tpu_torch.models.weights import _unflatten

    with np.load(path) as d:
        flat = {k: d[k] for k in d.files if not k.startswith("__cfg__")}
        kw = {k[len("__cfg__"):]: d[k].item() for k in d.files if k.startswith("__cfg__")}
    for int_key in ("feat_dim", "n_rbf", "n_layers", "max_z", "max_neighbors",
                    "readout_hidden", "envelope_p", "l_max"):
        if int_key in kw:
            kw[int_key] = int(kw[int_key])
    if "cutoff" in kw:
        kw["cutoff"] = float(kw["cutoff"])
    if "equivariant_messages" in kw:
        kw["equivariant_messages"] = bool(kw["equivariant_messages"])
    return _unflatten(flat), MACEConfig(**kw)
