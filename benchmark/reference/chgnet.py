"""Plain CHGNet energy (Deng et al., Nat. Mach. Intell. 2023, v0.3.0
architecture, as converted into the reference's npz checkpoint).

Atom graph: every pair under ``atom_graph_cutoff``, radial Bessel bases
sqrt(2/rc) sin(f_n r / rc) / r under the polynomial envelope of order p,
be = rbf E_b (bond features), bw = rbf W_ag (bond weights). Bond graph: each
atom's bonds under ``bond_graph_cutoff``, at most ``max_bond_neighbors``
nearest, with their own bases (rbf' E_b, rbf' W_bg) and, for each ordered
pair (m, k) of an atom's bonds with m != k, the angle between them in
Fourier bases [1/sqrt2, sin(n t), cos(n t)] / sqrt(pi) times E_angle.

Gated MLP g(x) = silu(LN(C1 silu(C0 x))) * sigmoid(LN(G1 silu(G0 x))) (the
angle update's one-layer form drops C1 and G1 and their silu). Per layer:

    a_i += (sum_j g_atom([a_i | a_j | be_ij]) * bw_ij) O_atom
    then, but for the last layer, at every atom c and bond pair (m, k):
    b_m += (sum_k g_bond([a_c | b_m | b_k | t_mk]) * bw'_k) O_bond
    t_mk += g_angle([a_c | b_m | b_k | t_mk])   (both from the old b, t)

E = sum_i (MLP(LN(a_i)) + composition(Z_i)), 1e6 where an atom has more
than ``max_neighbors`` pairs. LayerNorms take eps 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tnf

from benchmark.reference.common import (
    FP32,
    Precision,
    edge_list,
    image_shifts,
    load_npz_tree,
    segment_sum,
)


def _envelope(r: torch.Tensor, rc: float, p: int) -> torch.Tensor:
    x = torch.clamp(r / rc, 0.0, 1.0)
    return (1.0 - 0.5 * (p + 1) * (p + 2) * x ** p + p * (p + 2) * x ** (p + 1)
            - 0.5 * p * (p + 1) * x ** (p + 2))


def _bessel(r: torch.Tensor, freq: torch.Tensor, rc: float, p: int) -> torch.Tensor:
    return (math.sqrt(2.0 / rc) * torch.sin(freq * r[:, None] / rc) / r[:, None]
            * _envelope(r, rc, p)[:, None])


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


class CHGNetReference:
    """One CHGNet checkpoint on ``device``; ``cfg`` holds the configuration
    file's sizes (``atom_fea_dim``, ``n_conv``, ``atom_graph_cutoff``,
    ``bond_graph_cutoff``, ``cutoff_coeff``, ``max_neighbors``,
    ``max_bond_neighbors``)."""

    def __init__(self, path, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.w = load_npz_tree(path, device)

    def _lin(self, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        y = prec.mm(x, self.w[f"{name}.w"])
        b = self.w.get(f"{name}.b")
        return y if b is None else y + b

    def _gated(self, name: str, x: torch.Tensor, prec: Precision, single: bool = False):
        core, gate = self._lin(f"{name}.core0", x, prec), self._lin(f"{name}.gate0", x, prec)
        if not single:
            core = self._lin(f"{name}.core1", tnf.silu(core), prec)
            gate = self._lin(f"{name}.gate1", tnf.silu(gate), prec)
        w = self.w
        return (tnf.silu(_layer_norm(core, w[f"{name}.ln_core.g"], w[f"{name}.ln_core.b"]))
                * torch.sigmoid(_layer_norm(gate, w[f"{name}.ln_gate.g"], w[f"{name}.ln_gate.b"])))

    def potential_energy(self, numbers: torch.Tensor, positions: torch.Tensor, cell, pbc,
                         prec: Precision = FP32) -> torch.Tensor:
        """(C,) potential energies in eV."""
        cfg, w = self.cfg, self.w
        C, N = numbers.shape
        F, p = cfg["atom_fea_dim"], cfg["cutoff_coeff"]
        rc, rb, mb = cfg["atom_graph_cutoff"], cfg["bond_graph_cutoff"], cfg["max_bond_neighbors"]
        alive = numbers > 0
        e = edge_list(positions, alive, image_shifts(cell, pbc, rc), rc)
        i, j, r = e.centre, e.neighbour, e.r
        rbf = _bessel(r, w["rbf_freq_ag"], rc, p)
        be, bw = prec.mm(rbf, w["bond_embedding.w"]), prec.mm(rbf, w["bond_weights_ag.w"])

        # bond graph: each centre's nearest bonds under rb, as a padded
        # (rows, mb) table of edge ids
        bond = torch.nonzero(r < rb, as_tuple=True)[0]
        order = torch.argsort(i[bond].double() * (2 * rc) + r[bond].double(), stable=True)
        bond = bond[order]
        first = torch.searchsorted(i[bond], i[bond], right=False)
        rank = torch.arange(bond.numel(), device=r.device) - first
        keep = rank < mb
        table = torch.full((e.n_rows, mb), -1, dtype=torch.int64, device=r.device)
        table[i[bond[keep]], rank[keep]] = bond[keep]
        has = table >= 0
        tb = table.clamp(min=0)
        rbf_b = _bessel(r[tb].reshape(-1), w["rbf_freq_bg"], rb, p)
        bond_w = prec.mm(rbf_b, w["bond_weights_bg.w"]).reshape(e.n_rows, mb, F)
        bond_f = prec.mm(rbf_b, w["bond_embedding.w"]).reshape(e.n_rows, mb, F)
        unit = (e.disp / r[:, None])[tb]                                     # (rows, mb, 3)
        cos = torch.clamp((unit[:, :, None, :] * unit[:, None, :, :]).sum(-1), -1 + 1e-6,
                          1 - 1e-6)
        t = torch.arccos(cos)[..., None] * w["angle_freq"]
        basis = torch.cat([torch.full_like(t[..., :1], 1.0 / math.sqrt(2.0)), torch.sin(t),
                           torch.cos(t)], dim=-1) / math.sqrt(math.pi)
        angle = prec.mm(basis, w["angle_embedding.w"])                        # (rows, mb, mb, F)
        eye = torch.eye(mb, dtype=torch.bool, device=r.device)
        pair = (has[:, :, None] & has[:, None, :] & ~eye)[..., None].float()

        z = (numbers.reshape(-1) - 1).clamp(0, w["atom_embedding"].shape[0] - 1)
        alive_f = alive.reshape(-1, 1).float()
        atom = w["atom_embedding"][z] * alive_f
        for layer in range(cfg["n_conv"]):
            name = f"atom_convs.{layer}"
            msg = self._gated(f"{name}.gmlp", torch.cat([atom[i], atom[j], be], dim=-1), prec) * bw
            atom = (atom + prec.mm(segment_sum(msg, i, e.n_rows), w[f"{name}.out.w"])) * alive_f
            if layer == cfg["n_conv"] - 1:
                break
            x = torch.cat([atom[:, None, None, :].expand(-1, mb, mb, -1),
                           bond_f[:, :, None, :].expand(-1, -1, mb, -1),
                           bond_f[:, None, :, :].expand(-1, mb, -1, -1), angle], dim=-1)
            bmsg = self._gated(f"bond_convs.{layer}.gmlp", x, prec) * bond_w[:, None] * pair
            angle = angle + self._gated(f"angle_layers.{layer}", x, prec, single=True) * pair
            bond_f = bond_f + prec.mm(bmsg.sum(dim=2), w[f"bond_convs.{layer}.out.w"])
        h = _layer_norm(atom, w["readout_norm.g"], w["readout_norm.b"])
        for k in range(3):
            h = tnf.silu(self._lin(f"mlp.{k}", h, prec))
        e_atom = (self._lin("mlp.3", h, prec)[:, 0] + w["composition"][z]) * alive_f[:, 0]
        total = e_atom.reshape(C, N).sum(dim=1)
        overflow = (e.count > cfg["max_neighbors"]).any(dim=1)
        return torch.where(overflow, torch.full_like(total, 1e6), total)
