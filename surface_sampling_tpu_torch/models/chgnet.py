"""CHGNet forward, batched over chains: the second model family of the
port.

The counterpart of ``surface_sampling_tpu/models/chgnet.py`` (a
reconstruction of the published CHGNet v0.3.0 architecture: atom graph
with radial-Bessel bond bases under a polynomial cutoff, bond graph of the
bonds under 3 A with Fourier angle bases, interleaved gated-MLP atom, bond
and angle convolutions with LayerNorm, a magmom head and an averaged
readout MLP plus a per-element composition model). Parameters are the JAX
package's tree of tensors, one model with no member axis
(``models/weights.load_chgnet_npz``); every function carries a leading
chain axis C.

The forward computes only what its outputs read. In this reconstruction
each atom conv reads the atom graph's bond embeddings and weights, which
are the same at every layer, and the readout reads only the atom
features, so the bond graph, its angles and the bond and angle updates
reach no output: XLA deletes them from the JAX package's compiled
forward, and the port never builds them. Their parameters
(``bond_convs``, ``angle_layers``, ``bond_weights_bg``,
``angle_embedding``, ``angle_freq``, ``rbf_freq_bg``) stay in the tree,
as the JAX package's and the checkpoints' format has them.

The atom trunk runs the JAX package's fused formulation ("pallas" conv
mode): per-atom pre-activations ai2 / aj2 of the centre and neighbour
thirds of each atom conv's first layer, and the fused per-edge op
``ops.chgnet_kernels.chgnet_conv`` (its CUDA kernel on the card, its plain
version on the CPU), whose backward is a kernel too. With a routing band
(rigid supercells) the conv runs in the band's sorted row order through
``chgnet_conv_banded``. The readout is plain PyTorch, as the JAX package
leaves it to XLA. ``chgnet_apply_structures`` is the JAX package's
``chgnet_apply`` entry from positions, which training differentiates
twice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as tnf

from surface_sampling_tpu_torch.models.painn import with_halo
from surface_sampling_tpu_torch.ops.banding import DeviceBand
from surface_sampling_tpu_torch.ops.chgnet_kernels import (
    chgnet_conv,
    chgnet_conv_banded,
    layer_norm,
)
from surface_sampling_tpu_torch.ops.neighbors import Edges, neighbor_list, padded_rows
from surface_sampling_tpu_torch.utils.tracing import span


@dataclass(frozen=True)
class CHGNetConfig:
    """The JAX package's configuration without its ``conv_mode`` and
    ``pallas_routing``, which select TPU execution paths and routing
    precision: the port has one path and computes in float32."""

    atom_fea_dim: int = 64
    bond_fea_dim: int = 64
    angle_fea_dim: int = 64
    num_radial: int = 31
    num_angular: int = 31        # 2*order + 1
    n_conv: int = 4
    atom_graph_cutoff: float = 6.0
    bond_graph_cutoff: float = 3.0
    cutoff_coeff: int = 8        # polynomial envelope exponent p
    max_z: int = 94
    max_neighbors: int = 96      # atom-graph padding
    max_bond_neighbors: int = 12  # bond-graph padding
    mlp_hidden_dims: tuple = (64, 64, 64)
    is_intensive: bool = True


# ----------------------------------------------------------------------
# bases
# ----------------------------------------------------------------------
def polynomial_envelope(r: torch.Tensor, cutoff: float, p: int) -> torch.Tensor:
    """Smooth cutoff: 1 - (p+1)(p+2)/2 x^p + p(p+2) x^(p+1) - p(p+1)/2 x^(p+2)."""
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    return (1.0 - 0.5 * (p + 1) * (p + 2) * x ** p + p * (p + 2) * x ** (p + 1)
            - 0.5 * p * (p + 1) * x ** (p + 2))


def radial_bessel(r: torch.Tensor, frequencies: torch.Tensor, cutoff: float,
                  p: int) -> torch.Tensor:
    """sqrt(2/rc) sin(f_n r / rc) / r under the polynomial envelope."""
    rs = torch.clamp(r, min=1e-8)[..., None]
    basis = math.sqrt(2.0 / cutoff) * torch.sin(frequencies * rs / cutoff) / rs
    return basis * polynomial_envelope(r, cutoff, p)[..., None]


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _ln_params(p: dict) -> torch.Tensor:
    """(2, F) gain and bias rows of a LayerNorm."""
    return torch.stack([p["g"], p["b"]])


def conv_weights(gmlp: dict, F: int) -> tuple:
    """An atom conv's weights in the order of ``chgnet_conv``: w2 (F, 2F)
    the bond third of both branches' first layers, the live second-layer
    halves wc1 / wg1 (F, F), their biases, and the two LayerNorms."""
    w2 = torch.cat([gmlp["core0"]["w"][2 * F:], gmlp["gate0"]["w"][2 * F:]], dim=1)
    return (w2.contiguous(), gmlp["core1"]["w"].contiguous(), gmlp["gate1"]["w"].contiguous(),
            gmlp["core1"]["b"].contiguous(), gmlp["gate1"]["b"].contiguous(),
            _ln_params(gmlp["ln_core"]), _ln_params(gmlp["ln_gate"]))


def atom_preactivations(gmlp: dict, atom: torch.Tensor, F: int):
    """Per-atom pre-activations (..., 2F) of the [a_i | a_j | bond] concat's
    centre rows (with both branches' first-layer biases) and neighbour
    rows, [core | gate] each."""
    w0c, w0g = gmlp["core0"]["w"], gmlp["gate0"]["w"]
    ai2 = torch.cat([atom @ w0c[:F] + gmlp["core0"]["b"], atom @ w0g[:F] + gmlp["gate0"]["b"]],
                    dim=-1)
    aj2 = torch.cat([atom @ w0c[F:2 * F], atom @ w0g[F:2 * F]], dim=-1)
    return ai2, aj2


# ----------------------------------------------------------------------
# parameter initialisation (training from scratch and tests; checkpoints
# override it)
# ----------------------------------------------------------------------
def _init_linear(gen: torch.Generator, n_in: int, n_out: int, bias: bool = True) -> dict:
    s = 1.0 / math.sqrt(n_in)
    p = {"w": (torch.rand((n_in, n_out), generator=gen, device=gen.device) * 2.0 - 1.0) * s}
    if bias:
        p["b"] = torch.zeros(n_out, device=gen.device)
    return p


def _init_norm(dim: int, device) -> dict:
    return {"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)}


def _init_gated(gen: torch.Generator, n_in: int, dim: int, single: bool = False) -> dict:
    p = {"core0": _init_linear(gen, n_in, dim)}
    if not single:
        p["core1"] = _init_linear(gen, dim, dim)
    p["gate0"] = _init_linear(gen, n_in, dim)
    if not single:
        p["gate1"] = _init_linear(gen, dim, dim)
    p["ln_core"] = _init_norm(dim, gen.device)
    p["ln_gate"] = _init_norm(dim, gen.device)
    return p


def init_chgnet(generator: torch.Generator, cfg: CHGNetConfig) -> dict:
    """One model's parameters drawn from ``generator`` on its device with
    the JAX package's tree, shapes and laws (``init_chgnet``): atom
    embeddings N(0, 0.1^2), linear weights U(-1/sqrt(n_in), 1/sqrt(n_in)),
    zero biases and composition, unit LayerNorm gains, radial frequencies
    n pi and angle frequencies n. The values differ from JAX's (another
    generator)."""
    gen, dev = generator, generator.device
    F, R = cfg.atom_fea_dim, cfg.num_radial
    order = (cfg.num_angular - 1) // 2
    hid = cfg.mlp_hidden_dims
    params = {
        "composition": torch.zeros(cfg.max_z, device=dev),
        "atom_embedding": torch.randn((cfg.max_z, F), generator=gen, device=dev) * 0.1,
        "rbf_freq_ag": torch.arange(1, R + 1, dtype=torch.float32, device=dev) * math.pi,
        "rbf_freq_bg": torch.arange(1, R + 1, dtype=torch.float32, device=dev) * math.pi,
        "angle_freq": torch.arange(1, order + 1, dtype=torch.float32, device=dev),
        "bond_embedding": _init_linear(gen, R, F, bias=False),
        "bond_weights_ag": _init_linear(gen, R, F, bias=False),
        "bond_weights_bg": _init_linear(gen, R, F, bias=False),
        "angle_embedding": _init_linear(gen, cfg.num_angular, F, bias=False),
        "atom_convs": [{"gmlp": _init_gated(gen, 3 * F, F), "out": _init_linear(gen, F, F, False)}
                       for _ in range(cfg.n_conv)],
        "bond_convs": [{"gmlp": _init_gated(gen, 4 * F, F), "out": _init_linear(gen, F, F, False)}
                       for _ in range(cfg.n_conv - 1)],
        "angle_layers": [_init_gated(gen, 4 * F, F, single=True) for _ in range(cfg.n_conv - 1)],
        "site_wise": _init_linear(gen, F, 1),
        "readout_norm": _init_norm(F, dev),
        "mlp": [_init_linear(gen, F, hid[0]), _init_linear(gen, hid[0], hid[1]),
                _init_linear(gen, hid[1], hid[2]), _init_linear(gen, hid[2], 1)],
    }
    return params


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def atom_graph_edges(params: dict, cfg: CHGNetConfig, edges: Edges,
                     band: DeviceBand | None = None):
    """The fused conv's layer-invariant edge tensors: be, bw (C, E, F), the
    bond embeddings and bond weights of the atom graph's radial bases,
    maskf (C, E) and nbr (C, E) int32, over n_pad padded centre rows
    (E = n_pad * M), in the band's sorted order with neighbour ranks under
    ``band``. Returns (be, bw, maskf, nbr, n_pad)."""
    r, nbr_j, nbr_mask = edges[1], edges[2], edges[3]
    C, N, M = r.shape
    F = cfg.atom_fea_dim
    rbf = radial_bessel(r, params["rbf_freq_ag"], cfg.atom_graph_cutoff, cfg.cutoff_coeff)
    n_pad = band.n_pad if band is not None else padded_rows(N)
    pad = (0, 0, 0, 0, 0, n_pad - N)
    be = tnf.pad(rbf @ params["bond_embedding"]["w"], pad)
    bw = tnf.pad(rbf @ params["bond_weights_ag"]["w"], pad)
    maskf = tnf.pad(nbr_mask.to(r.dtype), pad[2:])
    nbr = tnf.pad(nbr_j, pad[2:])
    if band is not None:
        p = band.perm
        be, bw, maskf, nbr = be[:, p], bw[:, p], maskf[:, p], band.rank[nbr[:, p]]
    return (be.reshape(C, n_pad * M, F).contiguous(), bw.reshape(C, n_pad * M, F).contiguous(),
            maskf.reshape(C, n_pad * M).contiguous(),
            nbr.reshape(C, n_pad * M).to(torch.int32).contiguous(), n_pad)


def initial_atoms(params: dict, cfg: CHGNetConfig, numbers: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """(C, N, F) atom features before the first conv: the embedding of
    each atomic number, zero on dead slots."""
    z_idx = torch.clamp(numbers - 1, 0, cfg.max_z - 1)
    return params["atom_embedding"][z_idx] * alive[..., None].to(params["atom_embedding"].dtype)


def chgnet_apply(params: dict, cfg: CHGNetConfig, numbers: torch.Tensor, alive: torch.Tensor,
                 edges: Edges, band: DeviceBand | None = None) -> dict:
    """Forward pass over a (C, N) batch, differentiable in the positions
    the edges were built from (unbanded). Returns ``per_atom_energy`` (C, N),
    ``energy`` (C,) (1e6 where a chain's neighbour graph overflowed),
    ``energy_per_atom``, ``magmom`` (C, N) and ``embedding`` (C, N, F), as
    the JAX function does for one structure.

    ``band`` (a staged ``ops.banding.DeviceBand`` built over the same
    padded slots) runs every atom conv in the band's sorted order through
    the banded conv, which is forward only: the rigid MC path of
    supercells.

    The bond graph, its angles and the bond and angle updates are not
    computed: each atom conv reads the atom graph's layer-invariant
    ``be`` / ``bw`` and the readout reads only the atom features, so no
    output reads them (XLA removes them from the JAX function's compiled
    forward too), and every output and its derivatives are those of the
    full model.

    The stages are spans (``utils.tracing.span``: ``chgnet.bases``,
    ``chgnet.atom_conv``, ``chgnet.readout``), so that a trace splits the
    forward between them; they are on only while a ``torch.profiler``
    runs."""
    F = cfg.atom_fea_dim
    r, overflow = edges.r, edges.overflow
    N = r.shape[1]

    with span("chgnet.bases"):
        be, bw, maskf, nbr, n_pad = atom_graph_edges(params, cfg, edges, band)
        atom = initial_atoms(params, cfg, numbers, alive)
    pad_n = n_pad - N

    for layer in range(cfg.n_conv):
        with span("chgnet.atom_conv"):
            ac = params["atom_convs"][layer]
            ai2, aj2 = (tnf.pad(x, (0, 0, 0, pad_n))
                        for x in atom_preactivations(ac["gmlp"], atom, F))
            weights = conv_weights(ac["gmlp"], F)
            if band is None:
                agg = chgnet_conv(ai2.contiguous(), aj2.contiguous(), be, bw, maskf, nbr,
                                  *weights, edges.rev)
            else:
                agg = chgnet_conv_banded(ai2[:, band.perm].contiguous(),
                                         with_halo(aj2[:, band.perm], band.halo, 1), be, bw,
                                         maskf, nbr, *weights, band)[:, band.inv_perm]
            atom = atom + agg[:, :N] @ ac["out"]["w"]
            atom = torch.where(alive[..., None], atom, torch.zeros_like(atom))

    with span("chgnet.readout"):
        site_val = _linear(params["site_wise"], atom)[..., 0]        # magmom head
        h = layer_norm(_ln_params(params["readout_norm"]), atom)
        for lin in params["mlp"][:-1]:
            h = tnf.silu(_linear(lin, h))
        e_atom_nn = _linear(params["mlp"][-1], h)[..., 0]
        alive_e = alive.to(r.dtype)
        z_idx = torch.clamp(numbers - 1, 0, cfg.max_z - 1)
        e_atom = (e_atom_nn + params["composition"][z_idx]) * alive_e
        n_alive = torch.clamp(alive_e.sum(dim=1), min=1.0)
        # a truncated neighbour graph makes the network emit arbitrary
        # values: override (not penalise) so that the MC machinery rejects
        # the state
        total = torch.where(overflow, torch.full_like(n_alive, 1e6), e_atom.sum(dim=1))
    return {
        "per_atom_energy": e_atom,
        "energy": total,
        "energy_per_atom": total / n_alive,
        "magmom": torch.where(alive, site_val, torch.zeros_like(site_val)),
        "embedding": atom,
    }


def chgnet_apply_structures(params: dict, cfg: CHGNetConfig, positions: torch.Tensor,
                            numbers: torch.Tensor, alive: torch.Tensor,
                            shifts: torch.Tensor) -> dict:
    """The JAX package's ``chgnet_apply(params, cfg, positions, numbers,
    alive, shifts)`` batched over structures C: the edges of each structure
    by image search over its own shifts (``ops.neighbors.neighbor_list``,
    the ``cfg.max_neighbors`` nearest pairs within the atom-graph cutoff),
    then :func:`chgnet_apply`. Twice differentiable in the positions, the
    path of force-loss training.

    Args:
        positions: (C, N, 3) f32; numbers: (C, N) int, 0 = padding; alive:
            (C, N) bool; shifts: (C, K, 3) image shifts, unused slots far
            away (``models.train.pad_structures``).
    Returns:
        :func:`chgnet_apply`'s outputs, ``energy`` and ``magmom`` among them.
    """
    edges = neighbor_list(positions, shifts, alive, cfg.atom_graph_cutoff, cfg.max_neighbors)
    return chgnet_apply(params, cfg, numbers, alive, edges)
