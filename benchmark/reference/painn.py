"""Plain PaiNN ensemble energy (Schuett et al., ICML 2021, as trained with
the reference's NFF models): the forward of each member over every pair
under the cutoff, the member mean in eV, and the per-element composition
offset.

Per layer l, with s (atoms, F) and v (atoms, 3, F), v = 0 at the start:

    phi  = W1 silu(W0 s + b0) + b1                            (3F)
    w_ij = (sin(n pi r / rc) / r) Wd + bd, times 0.5 (cos(pi r / rc) + 1)
    x_ij = phi_j * w_ij = [x_vv | x_s | x_u]
    s_i += sum_j x_s;   v_i += sum_j x_u (r_ij / r) + x_vv v_j
    Uv = v U, Vv = v V;  a = A1 silu(A0 [s, |Vv|] + c0) + c1 = [a_vv | a_sv | a_ss]
    s += a_sv <Uv, Vv> + a_ss;   v += a_vv Uv

then E = sum_i (R1 silu(R0 s_i + r0) + r1) + sum_ij (sigma / r)^p (the
excluded volume), 1e6 where an atom has more than ``max_neighbors`` pairs
(the configuration's neighbour budget), and the potential energy is
mean_members(E) x units + sum_i offset(Z_i) + offset. Dead slots are not
atoms.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch
import torch.nn.functional as tnf

from benchmark.reference.common import (
    FP32,
    EdgeList,
    Precision,
    edge_list,
    image_shifts,
    load_npz_tree,
    segment_sum,
)
from benchmark.reference.surface import HARTREE_TO_EV, Z_OF


class PaiNNReference:
    """An ensemble of PaiNN checkpoints on ``device``.

    ``cfg`` holds the configuration file's sizes: ``feat_dim``, ``n_rbf``,
    ``cutoff``, ``n_layers``, ``power``, ``sigma``, ``max_neighbors`` and
    ``units_to_ev``; ``offsets_ev`` the composition offsets ({Z: eV} and
    ``"const"``)."""

    def __init__(self, paths, cfg: dict, device, offsets_ev: dict):
        self.cfg, self.device = cfg, device
        trees = [load_npz_tree(p, device) for p in paths]
        self.w = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}   # (K, ...)
        self.K = len(trees)
        self.z_offset = torch.zeros(128, device=device)
        for z, e in offsets_ev.items():
            if z != "const":
                self.z_offset[int(z)] = e
        self.const_offset = float(offsets_ev["const"])

    def _dense(self, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        """Per-member x (K, n, i) @ w (K, i, o) + b (K, o)."""
        y = prec.mm(x, self.w[f"{name}.w"])
        b = self.w.get(f"{name}.b")
        return y if b is None else y + b[:, None, :]

    def network_energy(self, numbers: torch.Tensor, positions: torch.Tensor, cell, pbc,
                       prec: Precision = FP32) -> torch.Tensor:
        """(C,) member-mean network energies in the checkpoint's units, 1e6
        where a neighbour list overflows."""
        cfg = self.cfg
        C, N = numbers.shape
        F, R, rc = cfg["feat_dim"], cfg["n_rbf"], cfg["cutoff"]
        alive = numbers > 0
        shifts = image_shifts(cell, pbc, rc)
        e: EdgeList = edge_list(positions, alive, shifts, rc)
        i, j, r = e.centre, e.neighbour, e.r
        unit = e.disp / r[:, None]
        n = torch.arange(1, R + 1, dtype=torch.float32, device=r.device)
        rbf = torch.sin(n * math.pi * r[:, None] / rc) / r[:, None]          # (E, R)
        env = 0.5 * (torch.cos(math.pi * r / rc) + 1.0)
        alive_f = alive.reshape(-1).float()[None, :, None]                  # (1, rows, 1)
        s = self.w["atom_embed"][:, numbers.reshape(-1).clamp(0, 99)] * alive_f   # (K, rows, F)
        v = torch.zeros((self.K, e.n_rows, 3, F), device=s.device)
        for layer in range(cfg["n_layers"]):
            m, u = f"message.{layer}", f"update.{layer}"
            phi = self._dense(f"{m}.inv_dense1", tnf.silu(self._dense(f"{m}.inv_dense0", s, prec)),
                              prec)
            w = (self._dense(f"{m}.dist_embed", rbf.expand(self.K, -1, -1), prec)
                 * env[None, :, None])                                      # (K, E, 3F)
            x = phi[:, j] * w
            x_vv, x_s, x_u = x[..., :F], x[..., F:2 * F], x[..., 2 * F:]
            ds = segment_sum(x_s.transpose(0, 1), i, e.n_rows).transpose(0, 1)
            dv_e = x_u[:, :, None, :] * unit[None, :, :, None] + x_vv[:, :, None, :] * v[:, j]
            dv = segment_sum(dv_e.transpose(0, 1), i, e.n_rows).transpose(0, 1)
            s, v = s + ds, v + dv
            vf = v.reshape(self.K, -1, F)
            uv = prec.mm(vf, self.w[f"{u}.u_mat.w"]).reshape(v.shape)
            vv = prec.mm(vf, self.w[f"{u}.v_mat.w"]).reshape(v.shape)
            vv_norm = torch.sqrt((vv * vv).sum(dim=2) + 1e-16)
            h = tnf.silu(self._dense(f"{u}.s_dense0", torch.cat([s, vv_norm], dim=-1), prec))
            a = self._dense(f"{u}.s_dense1", h, prec)
            a_vv, a_sv, a_ss = a[..., :F], a[..., F:2 * F], a[..., 2 * F:]
            s = (s + a_sv * (uv * vv).sum(dim=2) + a_ss) * alive_f
            v = (v + a_vv[:, :, None, :] * uv) * alive_f[..., None]
        e_atom = self._dense("readout.dense1", tnf.silu(self._dense("readout.dense0", s, prec)),
                             prec)[..., 0] * alive_f[..., 0]                # (K, rows)
        excl = segment_sum((cfg["sigma"] / r.clamp(min=1e-3)) ** cfg["power"], i, e.n_rows)
        total = (e_atom + excl[None] * alive_f[..., 0]).reshape(self.K, C, N).sum(-1)
        overflow = (e.count > cfg["max_neighbors"]).any(dim=1)
        return torch.where(overflow, torch.full_like(total[0], 1e6), total.mean(dim=0))

    def potential_energy(self, numbers, positions, cell, pbc, prec: Precision = FP32):
        """(C,) potential energies in eV."""
        net = self.network_energy(numbers, positions, cell, pbc, prec)
        comp = (self.z_offset[numbers] * (numbers > 0)).sum(dim=1) + self.const_offset
        return net * self.cfg["units_to_ev"] + comp


def make_model(cfg: dict, root: Path, device) -> PaiNNReference:
    """The configuration's ensemble (``weights``, paths under ``root``) with
    its composition offsets (``composition_offset_data``'s ``stoidict``, in
    Hartree)."""
    stoi = json.loads((root / cfg["composition_offset_data"]).read_text())["stoidict"]
    offsets = {Z_OF[k] if k != "offset" else "const": v * HARTREE_TO_EV for k, v in stoi.items()}
    return PaiNNReference([root / p for p in cfg["weights"]], cfg, device, offsets)
