"""Rigid-lattice forms of the many-body potentials (Tersoff, SW), batched
over chains.

The counterpart of ``surface_sampling_tpu/potentials/rigid_manybody.py``.
Without relaxation every slot position is a static template, so every pair
distance, bond angle and hence every radial and angular factor is known in
float64 when the system is built. What remains per evaluation is
occupancy algebra over the (C, N, T) alive-masked one-hot species
occupancy x:

  Tersoff:  zeta[c, pair, ti, tj] = C[pair, ti, tj, :] @ x[c].flat  (one matmul)
            b = (1 + (beta zeta)^n)^(-1/2n)                          (elementwise)
            E = sum_pair x_i x_j . [1/2 fc (fR + b fA)](ti, tj)      (contraction)

  SW:       E = sum_pair x_i x_j . (Phi2 / 2 + C3[pair] @ x.flat)(ti, tj)

The species axes keep multi-type chemistry (GaN: Ga / N adsorbates)
exact, and the tables enumerate every in-range image pair (no truncation).
Positions passed in are ignored; single-atom adsorbate vocabularies only
(code-independent slot positions), like ``potentials.eam.make_eam_rigid``.
Each atom's energy sums its pairs in a fixed order (a gather over a padded
per-centre pair table), so repeated runs agree bitwise on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.potentials.base import Potential, summed
from surface_sampling_tpu_torch.potentials.sw import SWTables
from surface_sampling_tpu_torch.potentials.tersoff import TersoffTables


def _require_rigid_vocab(spec) -> None:
    G = spec.code_offsets.shape[1]
    if G != 1 or np.abs(spec.code_offsets).max() > 1e-12:
        raise ValueError(
            "rigid many-body paths require single-atom adsorbates with "
            "code-independent slot positions (group vocabularies move atoms)"
        )


# Refuse precomputed tables beyond this budget: the C table is
# (n_pairs, T, T, N*T) ~ O(N^2 * nbr * T^3) and the per-center f64
# temporaries are (M, M, T, T, T); on large slabs both can exhaust host
# memory long before any allocation error points at the cause. A caller
# can catch the ValueError and keep the dynamic path.
MAX_RIGID_TABLE_BYTES = 4 << 30


def _check_rigid_budget(spec, cutoff: float, T: int, itemsize: int,
                        max_bytes: int = MAX_RIGID_TABLE_BYTES) -> None:
    valid = np.asarray(build_static_neighbor_table(spec, cutoff, relax_slack=0.0).valid)
    n_pairs = int(valid.sum())
    max_nbr = int(valid.sum(axis=1).max()) if n_pairs else 0
    table = n_pairs * T * T * spec.n_slots * T * itemsize
    temp = max_nbr * max_nbr * T**3 * 8
    if table + temp > max_bytes:
        raise ValueError(
            f"rigid many-body tables would need ~{(table + temp) / 2**30:.1f} GiB "
            f"(n_slots={spec.n_slots}, pairs={n_pairs}, T={T}) — beyond the "
            f"{max_bytes / 2**30:.0f} GiB budget; use the dynamic geometry path"
        )


def _static_pairs(spec, cutoff: float):
    """Enumerate every in-range static (center, neighbor-image) pair.

    Yields (i, js, shifts, r, unit) per center with float64 geometry.
    """
    nbr = build_static_neighbor_table(spec, cutoff, relax_slack=0.0)
    centers = np.concatenate([spec.pristine_positions, spec.site_coords])
    for i in range(spec.n_slots):
        sel = np.asarray(nbr.valid[i])
        js = np.asarray(nbr.slot_j[i])[sel]
        shs = np.asarray(nbr.shift[i])[sel]
        dvec = centers[js] + shs - centers[i]
        r = np.linalg.norm(dvec, axis=1)
        within = r < cutoff
        js, dvec, r = js[within], dvec[within], r[within]
        unit = dvec / np.maximum(r, 1e-300)[:, None]
        yield i, js, r, unit


def _fc_np(r, R, D):
    """Vectorized Tersoff cutoff (broadcasts r against R/D tables)."""
    mid = 0.5 - 0.5 * np.sin(0.5 * np.pi * (r - R) / np.maximum(D, 1e-12))
    return np.where(r < R - D, 1.0, np.where(r > R + D, 0.0, mid))


def _centre_pairs(pair_i: list, N: int) -> torch.Tensor:
    """(N, Mmax) index of each centre's pairs in the pair axis (pairs are
    grouped by centre, ascending), padded with the index of an extra zero
    pair."""
    pi = np.asarray(pair_i, np.int64)
    n_per = np.bincount(pi, minlength=N)
    tbl = np.full((N, max(int(n_per.max()) if len(pi) else 0, 1)), len(pi), np.int64)
    start = np.concatenate([[0], np.cumsum(n_per)[:-1]])
    for i in range(N):
        tbl[i, :n_per[i]] = start[i] + np.arange(n_per[i])
    return torch.as_tensor(tbl)


def _pair_rigid(T: int, N: int, pair_i, pair_j, dev, e_pairs):
    """The per-atom energy of pair tables: ``e_pairs(x (C, N, T)) -> (C,
    pairs, T, T)`` pair energies by species, contracted with x_i x_j and
    summed per centre in pair order."""
    pi = torch.as_tensor(np.asarray(pair_i, np.int64), device=dev)
    pj = torch.as_tensor(np.asarray(pair_j, np.int64), device=dev)
    per_centre = _centre_pairs(pair_i, N).to(dev)

    def per_atom(positions, type_idx, alive, shifts=None):
        x = (torch.nn.functional.one_hot(type_idx, T).to(torch.float32)
             * alive.to(torch.float32)[..., None])                        # (C, N, T)
        sel = x[:, pi, :, None] * x[:, pj, None, :]                       # (C, P, T, T)
        e_p = (e_pairs(x) * sel).sum(dim=(2, 3))                          # (C, P)
        e_p = torch.cat([e_p, e_p.new_zeros((e_p.shape[0], 1))], dim=1)
        return e_p[:, per_centre].sum(dim=2)

    return per_atom


def make_tersoff_rigid(tables: TersoffTables, spec, dtype=None,
                       device: str | torch.device = "cuda") -> Potential:
    """Tersoff on a rigid lattice as occupancy algebra over exact-f64
    precomputed radial and angular factors (see the module docstring).
    ``dtype`` must be None or ``torch.float32``."""
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    _require_rigid_vocab(spec)
    T = len(tables.elements)
    _check_rigid_budget(spec, tables.cutoff, T, 4)
    dev = resolve_device(device)
    N = spec.n_slots
    P = tables.params
    cutoff = tables.cutoff

    # diagonal (ti, tj, tj) two-body tables, (T, T)
    idx = np.arange(T)
    R2, D2 = P["R"][:, idx, idx], P["D"][:, idx, idx]
    A2, lam1 = P["A"][:, idx, idx], P["lam1"][:, idx, idx]
    B2, lam2 = P["B"][:, idx, idx], P["lam2"][:, idx, idx]

    pair_i, pair_j = [], []
    fc2_l, fr2_l, fa2_l, C_l = [], [], [], []
    for i, js, r, unit in _static_pairs(spec, cutoff):
        M = len(js)
        cos = unit @ unit.T                                   # (M, M)
        ra = r[:, None, None]                                 # (M, 1, 1)
        fc_ab = _fc_np(ra, R2, D2)                            # (M, T, T)
        fr_ab = A2 * np.exp(-lam1 * ra)
        fa_ab = -B2 * np.exp(-lam2 * ra)
        # triple factors, broadcast over (b, ti, tj, tk)
        rb = r[:, None, None, None]                           # (M, 1, 1, 1)
        fc3 = _fc_np(rb, P["R"], P["D"])                      # (M, T, T, T)
        c2 = P["c"] ** 2
        d2 = P["d"] ** 2
        dcos = P["h"] - cos[:, :, None, None, None]           # (M, M, T, T, T)
        g = P["gamma"] * (1.0 + c2 / d2 - c2 / (d2 + dcos**2))
        base = P["lam3"] * (r[:, None] - r[None, :])[:, :, None, None, None]
        arg = np.where(P["m"] > 2.0, base**3, base)
        contrib = fc3[None, :] * g * np.exp(np.clip(arg, -60.0, 60.0))  # (M,M,T,T,T)
        contrib[np.arange(M), np.arange(M)] = 0.0             # k != j (same entry)
        rows = np.zeros((M, T, T, N, T))
        np.add.at(
            rows.transpose(3, 0, 1, 2, 4), js, np.transpose(contrib, (1, 0, 2, 3, 4))
        )
        pair_i.extend([i] * M)
        pair_j.extend(int(j) for j in js)
        fc2_l.append(fc_ab)
        fr2_l.append(fr_ab)
        fa2_l.append(fa_ab)
        C_l.append(rows.reshape(M, T, T, N * T))

    def f32(parts, shape):
        return torch.as_tensor(np.concatenate(parts) if parts else np.zeros(shape),
                               dtype=torch.float32, device=dev)

    Cm = f32(C_l, (0, T, T, N * T))
    n_pairs = Cm.shape[0]
    C_flat = Cm.reshape(n_pairs * T * T, N * T).T.contiguous()        # (N T, P T T)
    fc2, fr2, fa2 = f32(fc2_l, (0, T, T)), f32(fr2_l, (0, T, T)), f32(fa2_l, (0, T, T))
    beta2 = torch.as_tensor(np.array([[P["beta"][a, b, b] for b in range(T)] for a in range(T)]),
                            dtype=torch.float32, device=dev)
    n2 = torch.as_tensor(np.array([[P["n"][a, b, b] for b in range(T)] for a in range(T)]),
                         dtype=torch.float32, device=dev)

    def e_pairs(x):
        C = x.shape[0]
        zeta = (x.reshape(C, N * T) @ C_flat).view(C, n_pairs, T, T)
        bz = torch.clamp(beta2 * zeta, min=1e-30)
        b = (1.0 + bz ** n2) ** (-1.0 / (2.0 * torch.clamp(n2, min=1e-12)))
        return 0.5 * fc2 * (fr2 + b * fa2)

    per_atom = _pair_rigid(T, N, pair_i, pair_j, dev, e_pairs)
    return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                     name="tersoff-rigid")


def make_sw_rigid(tables: SWTables, spec, dtype=None,
                  device: str | torch.device = "cuda") -> Potential:
    """Stillinger-Weber on a rigid lattice in the pair-grouped form of
    Tersoff's: the triple sum over k collapses into a per-pair product,

        S_ij(ti, tj) = C3[pair, ti, tj, :] @ x.flat
        E            = sum_pair x_i x_j . (Phi2 / 2 + S)[pair, ti, tj]

    one matmul and one contraction per evaluation. ``dtype`` must be None
    or ``torch.float32``."""
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    _require_rigid_vocab(spec)
    T = len(tables.elements)
    _check_rigid_budget(spec, tables.cutoff, T, 4)
    dev = resolve_device(device)
    N = spec.n_slots
    P = tables.params
    cutoff = tables.cutoff

    pair_i, pair_j, phi2_l, C3_l = [], [], [], []
    idx = np.arange(T)
    sig2, a2 = P["sig"][:, idx, idx], P["a"][:, idx, idx]       # (T, T)
    A2, eps2 = P["A"][:, idx, idx], P["eps"][:, idx, idx]
    B2, p2, q2 = P["B"][:, idx, idx], P["p"][:, idx, idx], P["q"][:, idx, idx]

    for i, js, r, unit in _static_pairs(spec, cutoff):
        M = len(js)
        cos = unit @ unit.T
        ra = r[:, None, None]                                   # (M, 1, 1)
        gap2 = ra - a2 * sig2
        in2 = gap2 < -1e-9
        sr = sig2 / np.maximum(ra, 1e-12)
        rad2 = np.where(in2, np.exp(sig2 / np.where(in2, gap2, -1.0)), 0.0)
        with np.errstate(invalid="ignore"):
            tab2 = np.where(
                in2, 0.5 * A2 * eps2 * (B2 * sr**p2 - sr**q2) * rad2, 0.0
            )                                                   # (M, T, T)
        # per-leg gamma-scaled radial factor of the (ti,tj,tk) entry
        rb = r[:, None, None, None]                             # (M, 1, 1, 1)
        gap3 = rb - P["a"] * P["sig"]
        in3 = gap3 < -1e-9
        hrad = np.where(in3, np.exp(P["gam"] * P["sig"] / np.where(in3, gap3, -1.0)), 0.0)
        dcos = cos[:, :, None, None, None] - P["cos0"]          # (M, M, T, T, T)
        # leg ij uses r[a] (axis 0), leg ik uses r[b] (axis 1)
        contrib = 0.5 * P["lam"] * P["eps"] * dcos * dcos * hrad[:, None] * hrad[None, :]
        contrib[np.arange(M), np.arange(M)] = 0.0
        rows = np.zeros((M, T, T, N, T))
        np.add.at(
            rows.transpose(3, 0, 1, 2, 4), js, np.transpose(contrib, (1, 0, 2, 3, 4))
        )
        keep = (np.abs(tab2).sum(axis=(1, 2)) > 0) | (
            np.abs(rows).sum(axis=(1, 2, 3, 4)) > 0
        )
        kept = np.where(keep)[0]
        pair_i.extend([i] * len(kept))
        pair_j.extend(int(js[a]) for a in kept)
        phi2_l.append(tab2[kept])
        C3_l.append(rows[kept].reshape(len(kept), T, T, N * T))

    def f32(parts, shape):
        return torch.as_tensor(np.concatenate(parts) if parts else np.zeros(shape),
                               dtype=torch.float32, device=dev)

    phi2 = f32(phi2_l, (0, T, T))
    C3 = f32(C3_l, (0, T, T, N * T))
    n_pairs = C3.shape[0]
    C3_flat = C3.reshape(n_pairs * T * T, N * T).T.contiguous()       # (N T, P T T)

    def e_pairs(x):
        C = x.shape[0]
        return phi2 + (x.reshape(C, N * T) @ C3_flat).view(C, n_pairs, T, T)

    per_atom = _pair_rigid(T, N, pair_i, pair_j, dev, e_pairs)
    return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                     name="sw-rigid")
