"""Tersoff bond-order potential (LAMMPS pair_style tersoff compatible),
batched over chains.

The counterpart of ``surface_sampling_tpu/potentials/tersoff.py``: the GaN
tutorial's potential (Nord, Albe, Erhart & Nordlund, J. Phys.: Condens.
Matter 15, 5649 (2003)).

    E      = 1/2 sum_i sum_{j!=i} fC(r_ij) [ fR(r_ij) + b_ij fA(r_ij) ]
    fR     = A exp(-lambda1 r);   fA = -B exp(-lambda2 r)
    fC     = 1                                r < R - D
             1/2 - 1/2 sin(pi/2 (r-R)/D)      |r - R| <= D
             0                                r > R + D
    b_ij   = (1 + (beta zeta_ij)^n)^(-1/(2n))
    zeta   = sum_{k!=i,j} fC(r_ik) g(theta_ijk) exp([lambda3 (r_ij-r_ik)]^m)
    g      = gamma (1 + c^2/d^2 - c^2/(d^2 + (h - cos theta)^2))

Two-body parameters come from the (ti, tj, tj) table entry, three-body
(zeta) ones from (ti, tj, tk), the LAMMPS convention. Dense masked tensors
over a padded (C, N, M) neighbour list; parameter lookups are flat gathers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.ops.neighbors import (
    make_table_topology_fns,
    neighbor_list,
    neighbor_list_from_table,
    stage_candidate_table,
)
from surface_sampling_tpu_torch.potentials.base import Potential, TopologyPotential

# the JAX package's bundled tables, read by path (data, not modules)
DATA_DIR = Path(__file__).resolve().parents[2] / "surface_sampling_tpu" / "potentials" / "data"

_FIELDS = (
    "m", "gamma", "lam3", "c", "d", "h", "n", "beta",
    "lam2", "B", "R", "D", "lam1", "A",
)


@dataclass
class TersoffTables:
    """Parameter tables indexed [ti, tj, tk] (numpy)."""

    elements: tuple[str, ...]
    params: dict[str, np.ndarray]    # each (T, T, T)

    @property
    def cutoff(self) -> float:
        return float((self.params["R"] + self.params["D"]).max())


def parse_tersoff(text: str, elements: list[str] | None = None) -> TersoffTables:
    """Parse a LAMMPS .tersoff parameter file (14 numbers per entry)."""
    tokens: list[str] = []
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if line:
            tokens.extend(line.split())
    entries = {}
    i = 0
    while i < len(tokens):
        e1, e2, e3 = tokens[i: i + 3]
        entries[(e1, e2, e3)] = dict(zip(_FIELDS, (float(x) for x in tokens[i + 3: i + 17])))
        i += 17
    if elements is None:
        elements = sorted({e for key in entries for e in key})
    T = len(elements)
    params = {f: np.zeros((T, T, T)) for f in _FIELDS}
    for (e1, e2, e3), vals in entries.items():
        if e1 in elements and e2 in elements and e3 in elements:
            t1, t2, t3 = (elements.index(e) for e in (e1, e2, e3))
            for f in _FIELDS:
                params[f][t1, t2, t3] = vals[f]
    return TersoffTables(elements=tuple(elements), params=params)


def load_tersoff(path: str | Path, elements: list[str] | None = None) -> TersoffTables:
    return parse_tersoff(Path(path).read_text(), elements)


def save_tersoff_npz(path: str | Path, tables: TersoffTables) -> None:
    np.savez_compressed(path, elements=np.array(tables.elements), **tables.params)


def load_tersoff_npz(path: str | Path) -> TersoffTables:
    d = np.load(path)
    return TersoffTables(elements=tuple(str(e) for e in d["elements"]),
                         params={f: d[f] for f in _FIELDS})


def builtin_tersoff(name: str) -> TersoffTables:
    """A bundled Tersoff table set (e.g. 'GaN_nord2003')."""
    return load_tersoff_npz(DATA_DIR / f"{name}.tersoff.npz")


def _make_edge_fn(static_nbr, cutoff: float, max_neighbors: int, device):
    """``edge_fn(positions, alive, shifts) -> Edges`` (shared by Tersoff and
    SW): the candidates of a static table ranked when one is given (the
    table carries its image shifts), else the all-image search of the
    (K, 3) ``shifts``. Also returns the staged table (None without one)."""
    if static_nbr is None:
        def edge_fn(positions, alive, shifts):
            C = positions.shape[0]
            sh = torch.as_tensor(shifts, dtype=positions.dtype, device=positions.device)
            return neighbor_list(positions, sh.expand(C, *sh.shape), alive, cutoff,
                                 max_neighbors)

        return edge_fn, None
    table = stage_candidate_table(static_nbr, cutoff, max_neighbors, device)

    def edge_fn(positions, alive, shifts=None):
        return neighbor_list_from_table(positions, alive, table)

    return edge_fn, table


def _with_hooks(energy, per_atom, cutoff: float, name: str, table) -> Potential:
    """The potential, with the relax loop's fixed-topology hooks
    (``refresh_edges="once"``) when its edges rank a static table: its
    cutoff functions vanish smoothly at the true cutoffs, so edges that
    drift out during a relaxation are safe."""
    if table is None:
        return Potential(energy=energy, per_atom_energy=per_atom, cutoff=cutoff, name=name)
    topo_fn, geom_fn = make_table_topology_fns(table)
    return TopologyPotential(energy=energy, per_atom_energy=per_atom, cutoff=cutoff, name=name,
                             edge_topology=topo_fn, edges_of=geom_fn, energy_with_edges=energy)


def _neighbor_types(type_idx: torch.Tensor, nbr_j: torch.Tensor) -> torch.Tensor:
    C, N, M = nbr_j.shape
    return torch.gather(type_idx, 1, nbr_j.reshape(C, N * M)).view(C, N, M)


def _fc(r, R, D):
    """Tersoff cutoff function."""
    mid = 0.5 - 0.5 * torch.sin(0.5 * math.pi * (r - R) / torch.clamp(D, min=1e-12))
    return torch.where(r < (R - D), 1.0, torch.where(r > (R + D), 0.0, mid))


def make_tersoff(tables: TersoffTables, max_neighbors: int = 16, dtype=None, static_nbr=None,
                 device: str | torch.device = "cuda") -> Potential:
    """The Tersoff potential of (C, N) batches.

    ``static_nbr`` (a ``core.static_neighbors.StaticNeighborTable``) ranks
    only the spec's candidate pairs instead of searching all image pairs
    (MC hot paths over slot-realized geometries), and gives the potential
    the relax loop's topology hooks. ``dtype`` must be None or
    ``torch.float32``; ``device`` defaults to "cuda" and raises without a
    card."""
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    dev = resolve_device(device)
    T = len(tables.elements)
    cutoff = tables.cutoff
    p3 = {f: torch.as_tensor(tables.params[f].reshape(-1), dtype=torch.float32, device=dev)
          for f in _FIELDS}
    edge_fn, table = _make_edge_fn(static_nbr, cutoff, max_neighbors, dev)

    def flat3(ti, tj, tk):
        return (ti * T + tj) * T + tk

    def per_atom(positions, type_idx, alive, shifts=None, edges=None):
        disp, r, nbr_j, nbr_mask = (edges if edges is not None
                                    else edge_fn(positions, alive, shifts))[:4]
        fmask = nbr_mask.to(r.dtype)
        ti = type_idx[:, :, None]                               # (C, N, 1)
        tj = _neighbor_types(type_idx, nbr_j)                   # (C, N, M)
        # two-body: parameters of (i, j, j)
        idx2 = flat3(ti, tj, tj)
        fc_ij = _fc(r, p3["R"][idx2], p3["D"][idx2]) * fmask
        fr = p3["A"][idx2] * torch.exp(-p3["lam1"][idx2] * r)
        fa = -p3["B"][idx2] * torch.exp(-p3["lam2"][idx2] * r)
        # zeta over k: parameters of (i, j, k), k on the last axis
        idx3 = flat3(ti[..., None], tj[..., None], tj[:, :, None, :])   # (C, N, M, M)
        r_ik = r[:, :, None, :]
        fc_ik = _fc(r_ik, p3["R"][idx3], p3["D"][idx3])
        unit = disp / torch.clamp(r, min=1e-12)[..., None]
        cos_t = torch.einsum("cnmx,cnkx->cnmk", unit, unit)
        c2, d2 = p3["c"][idx3] ** 2, p3["d"][idx3] ** 2
        g = p3["gamma"][idx3] * (1.0 + c2 / d2 - c2 / (d2 + (p3["h"][idx3] - cos_t) ** 2))
        base = p3["lam3"][idx3] * (r[..., None] - r_ik)         # lam3 (r_ij - r_ik)
        arg = torch.where(p3["m"][idx3] > 2.0, base ** 3, base)  # LAMMPS takes m = 1 or 3
        ex_delr = torch.exp(torch.clamp(arg, -60.0, 60.0))
        # k valid, k != j (the same list position)
        M = r.shape[2]
        not_same = ~torch.eye(M, dtype=torch.bool, device=r.device)
        kmask = nbr_mask[:, :, None, :] & not_same & nbr_mask[..., None]
        zeta = torch.where(kmask, fc_ik * g * ex_delr, 0.0).sum(dim=3)
        # bond order
        nn = p3["n"][idx2]
        bz = torch.clamp(p3["beta"][idx2] * zeta, min=1e-30)
        b_ij = (1.0 + bz ** nn) ** (-1.0 / (2.0 * torch.clamp(nn, min=1e-12)))
        e_pair = 0.5 * fc_ij * (fr + b_ij * fa)
        return torch.where(alive, e_pair.sum(dim=2), 0.0)

    def energy(positions, type_idx, alive, shifts=None, edges=None):
        return per_atom(positions, type_idx, alive, shifts, edges=edges).sum(dim=1)

    return _with_hooks(energy, per_atom, cutoff, "tersoff", table)
