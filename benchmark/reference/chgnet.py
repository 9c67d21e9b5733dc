"""Plain CHGNet energy (Deng et al., Nat. Mach. Intell. 2023, v0.3.0
architecture, as converted into the reference's npz checkpoint).

Atom graph: every pair under ``atom_graph_cutoff``, radial Bessel bases
sqrt(2/rc) sin(f_n r / rc) / r under the polynomial envelope of order p,
be = rbf E_b (bond features), bw = rbf W_ag (bond weights).

Gated MLP g(x) = silu(LN(C1 silu(C0 x))) * sigmoid(LN(G1 silu(G0 x))). Per
layer:

    a_i += (sum_j g_atom([a_i | a_j | be_ij]) * bw_ij) O_atom

E = sum_i (MLP(LN(a_i)) + composition(Z_i)), 1e6 where an atom has more
than ``max_neighbors`` pairs. LayerNorms take eps 1e-5.

The published model also carries a bond graph (each atom's nearest bonds
under ``bond_graph_cutoff``), angle bases between them, and per layer but
the last a bond and an angle update. None of it reaches the energy: the
atom convs read the atom graph's ``be`` / ``bw``, which no layer changes,
and the readout reads only the atoms. So it is left out here, and its
weights in the checkpoint are not read.
"""

from __future__ import annotations

import math
from pathlib import Path

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
    file's sizes (``n_conv``, ``atom_graph_cutoff``, ``cutoff_coeff``,
    ``max_neighbors``)."""

    def __init__(self, path, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.w = load_npz_tree(path, device)

    def _lin(self, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        y = prec.mm(x, self.w[f"{name}.w"])
        b = self.w.get(f"{name}.b")
        return y if b is None else y + b

    def _gated(self, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        core = self._lin(f"{name}.core1", tnf.silu(self._lin(f"{name}.core0", x, prec)), prec)
        gate = self._lin(f"{name}.gate1", tnf.silu(self._lin(f"{name}.gate0", x, prec)), prec)
        w = self.w
        return (tnf.silu(_layer_norm(core, w[f"{name}.ln_core.g"], w[f"{name}.ln_core.b"]))
                * torch.sigmoid(_layer_norm(gate, w[f"{name}.ln_gate.g"], w[f"{name}.ln_gate.b"])))

    def potential_energy(self, numbers: torch.Tensor, positions: torch.Tensor, cell, pbc,
                         prec: Precision = FP32) -> torch.Tensor:
        """(C,) potential energies in eV."""
        cfg, w = self.cfg, self.w
        C, N = numbers.shape
        p, rc = cfg["cutoff_coeff"], cfg["atom_graph_cutoff"]
        alive = numbers > 0
        e = edge_list(positions, alive, image_shifts(cell, pbc, rc), rc)
        i, j, r = e.centre, e.neighbour, e.r
        rbf = _bessel(r, w["rbf_freq_ag"], rc, p)
        be, bw = prec.mm(rbf, w["bond_embedding.w"]), prec.mm(rbf, w["bond_weights_ag.w"])
        z = (numbers.reshape(-1) - 1).clamp(0, w["atom_embedding"].shape[0] - 1)
        alive_f = alive.reshape(-1, 1).float()
        atom = w["atom_embedding"][z] * alive_f
        for layer in range(cfg["n_conv"]):
            name = f"atom_convs.{layer}"
            msg = self._gated(f"{name}.gmlp", torch.cat([atom[i], atom[j], be], dim=-1), prec) * bw
            atom = (atom + prec.mm(segment_sum(msg, i, e.n_rows), w[f"{name}.out.w"])) * alive_f
        h = _layer_norm(atom, w["readout_norm.g"], w["readout_norm.b"])
        for k in range(3):
            h = tnf.silu(self._lin(f"mlp.{k}", h, prec))
        e_atom = (self._lin("mlp.3", h, prec)[:, 0] + w["composition"][z]) * alive_f[:, 0]
        total = e_atom.reshape(C, N).sum(dim=1)
        overflow = (e.count > cfg["max_neighbors"]).any(dim=1)
        return torch.where(overflow, torch.full_like(total, 1e6), total)


def make_model(cfg: dict, root: Path, device) -> CHGNetReference:
    """The configuration's checkpoint (``weights[0]``, a path under
    ``root``)."""
    return CHGNetReference(root / cfg["weights"][0], cfg, device)
