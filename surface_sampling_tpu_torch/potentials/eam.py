"""Embedded-atom-method (EAM) potential, DYNAMO funcfl compatible, batched
over chains.

The counterpart of ``surface_sampling_tpu/potentials/eam.py`` (itself the
replacement of the reference's LAMMPS ``pair_style eam`` path). Tables are
parsed on the host and turned into LAMMPS-identical local cubic splines
(``ops/splines.py``); the energy is

    rho_i = sum_j rho_tj(r_ij);  E = sum_i F_ti(rho_i) + 1/2 sum_ij phi(r_ij)

with phi(r) = z2r(r) / r and z2r = 27.2*0.529 Z_i(r) Z_j(r) for funcfl.
Three evaluators, as in the JAX package:

* :func:`make_eam` — exact splines over every periodic image pair (dense
  (C, K, N, N)); needs the image shifts.
* :func:`make_eam_static` — over a static candidate-pair table, with the
  pair tables as fitted piecewise polynomials (``"poly"``), exact splines
  (``"spline"``) or global Chebyshev series (``"cheb"``, the plain math of
  the EAM kernel, ``ops/eam_kernels.cheb_rho_ep``).
* :func:`make_eam_rigid` — rigid lattices: host-f64 quadratic forms, then
  two f32 einsums per evaluation.

All are differentiable in plain PyTorch (forces by autograd).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import EAM_QQR2E
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.ops.eam_kernels import (
    DEGREE,
    R_LO,
    ChebRange,
    cheb_fit,
    cheb_rho_ep,
)
from surface_sampling_tpu_torch.ops.neighbors import image_distances, image_pair_mask
from surface_sampling_tpu_torch.ops.splines import (
    lammps_spline_coeffs,
    spline_eval,
    spline_eval_np,
    spline_eval_onehot,
)
from surface_sampling_tpu_torch.potentials.base import Potential, summed

# the JAX package's bundled tables, read by path (data, not modules)
DATA_DIR = Path(__file__).resolve().parents[2] / "surface_sampling_tpu" / "potentials" / "data"


@dataclass
class EAMTables:
    """Host-side EAM tables on common grids (numpy)."""

    numbers: np.ndarray          # (T,) atomic numbers
    nrho: int
    drho: float
    nr: int
    dr: float
    cutoff: float
    frho: np.ndarray             # (T, nrho) embedding energy F(rho), eV
    rhor: np.ndarray             # (T, nr) electron density rho(r)
    z2r: np.ndarray              # (T, T, nr) pair table, eV*Angstrom


def parse_funcfl(path: str | Path) -> dict:
    """Parse a single-element DYNAMO funcfl file (e.g. Cu_u3.eam).

    Layout: comment line; "Z mass alat lattice"; "nrho drho nr dr cutoff";
    then nrho F(rho) values, nr Z(r) values, nr rho(r) values.
    """
    lines = Path(path).read_text().split("\n")
    z = int(float(lines[1].split()[0]))
    h = lines[2].split()
    nrho, drho, nr, dr, cutoff = int(h[0]), float(h[1]), int(h[2]), float(h[3]), float(h[4])
    vals = np.array(" ".join(lines[3:]).split(), dtype=np.float64)
    if len(vals) < nrho + 2 * nr:
        raise ValueError(f"funcfl file {path} truncated: {len(vals)} values")
    return {"number": z, "nrho": nrho, "drho": drho, "nr": nr, "dr": dr, "cutoff": cutoff,
            "frho": vals[:nrho], "zr": vals[nrho:nrho + nr], "rhor": vals[nrho + nr:nrho + 2 * nr]}


def _resample(f: np.ndarray, delta: float, n_new: int, delta_new: float) -> np.ndarray:
    if len(f) == n_new and np.isclose(delta, delta_new):
        return f
    return spline_eval_np(lammps_spline_coeffs(f), np.arange(n_new) * delta_new, delta)


def tables_from_funcfl(elements: list[dict]) -> EAMTables:
    """Combine one or more parsed funcfl elements into alloy tables. For one
    element this is exact LAMMPS behaviour; several files with differing
    grids are resampled onto the finest common grid with the same splines."""
    nrho = max(e["nrho"] for e in elements)
    nr = max(e["nr"] for e in elements)
    drho = min(e["drho"] for e in elements)
    dr = min(e["dr"] for e in elements)
    cutoff = max(e["cutoff"] for e in elements)
    T = len(elements)
    frho, rhor, zr = np.zeros((T, nrho)), np.zeros((T, nr)), np.zeros((T, nr))
    for t, e in enumerate(elements):
        frho[t] = _resample(e["frho"], e["drho"], nrho, drho)
        rhor[t] = _resample(e["rhor"], e["dr"], nr, dr)
        zr[t] = _resample(e["zr"], e["dr"], nr, dr)
    return EAMTables(numbers=np.array([e["number"] for e in elements], dtype=np.int32),
                     nrho=nrho, drho=drho, nr=nr, dr=dr, cutoff=cutoff, frho=frho, rhor=rhor,
                     z2r=EAM_QQR2E * np.einsum("ik,jk->ijk", zr, zr))


def combine_tables(parts: list[EAMTables]) -> EAMTables:
    """Alloy tables from single-element table sets (LAMMPS listing several
    funcfl files in one pair_coeff): each element's Z(r) is recovered from
    its z2r diagonal (z2r = qqr2e Z_i Z_j >= 0 for funcfl data) and all are
    resampled onto the finest common grid."""
    elements = []
    for t in parts:
        if len(t.numbers) != 1:
            raise ValueError("combine_tables takes single-element table sets")
        elements.append({"number": int(t.numbers[0]), "nrho": t.nrho, "drho": t.drho,
                         "nr": t.nr, "dr": t.dr, "cutoff": t.cutoff, "frho": t.frho[0],
                         "zr": np.sqrt(np.maximum(t.z2r[0, 0], 0.0) / EAM_QQR2E),
                         "rhor": t.rhor[0]})
    return tables_from_funcfl(elements)


def save_tables_npz(path: str | Path, tables: EAMTables) -> None:
    np.savez_compressed(path, **{k: getattr(tables, k) for k in tables.__dataclass_fields__})


def load_tables_npz(path: str | Path) -> EAMTables:
    d = np.load(path)
    return EAMTables(numbers=d["numbers"], nrho=int(d["nrho"]), drho=float(d["drho"]),
                     nr=int(d["nr"]), dr=float(d["dr"]), cutoff=float(d["cutoff"]),
                     frho=d["frho"], rhor=d["rhor"], z2r=d["z2r"])


def builtin_eam(name: str) -> EAMTables:
    """Load a bundled EAM table set ('Cu_u3', 'Au_u3')."""
    return load_tables_npz(DATA_DIR / f"{name}.eam.npz")


def _check_dtype(dtype) -> None:
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")


def _spline_stack(tables_1d, device) -> torch.Tensor:
    """(T', n, 4) f32 spline coefficients of a list of 1-D tables."""
    return torch.as_tensor(np.stack([lammps_spline_coeffs(t) for t in tables_1d]),
                           dtype=torch.float32, device=device)


def _frho_stack(tables: EAMTables, device) -> torch.Tensor:
    return _spline_stack([tables.frho[t] for t in range(len(tables.numbers))], device)


def _z2r_list(tables: EAMTables) -> list:
    T = len(tables.numbers)
    return [tables.z2r[i, j] for i in range(T) for j in range(T)]


def make_eam(tables: EAMTables, dtype=None, device: str | torch.device = "cuda") -> Potential:
    """The exact EAM Potential: LAMMPS splines over every image pair of
    positions (C, N, 3) under shifts (K, 3)."""
    _check_dtype(dtype)
    dev = resolve_device(device)
    T = len(tables.numbers)
    frho_c = _frho_stack(tables, dev)
    rhor_c = _spline_stack(list(tables.rhor), dev)
    z2r_c = _spline_stack(_z2r_list(tables), dev)                 # (T*T, nr, 4)
    inv_dr, inv_drho = 1.0 / tables.dr, 1.0 / tables.drho
    cutoff = float(tables.cutoff)

    def per_atom(positions, type_idx, alive, shifts):
        if shifts is None:
            raise ValueError("make_eam needs the periodic image shifts (DeviceSpec.shifts)")
        r, _ = image_distances(positions, shifts)                # (C, K, N, N)
        mask = image_pair_mask(alive, r, cutoff)
        rsafe = torch.where(mask, r, torch.full_like(r, cutoff))
        fmask = mask.to(r.dtype)
        # density at i from neighbour images j: the table of j's species
        rho_kij = spline_eval(rhor_c, rsafe, inv_dr, table_idx=type_idx[:, None, None, :])
        rho_i = (rho_kij * fmask).sum(dim=(1, 3))
        F_i = spline_eval_onehot(frho_c, rho_i, inv_drho, table_idx=type_idx)
        F_i = torch.where(alive, F_i, torch.zeros_like(F_i))
        pair_t = (type_idx[:, :, None] * T + type_idx[:, None, :])[:, None]
        phi = spline_eval(z2r_c, rsafe, inv_dr, table_idx=pair_t) / rsafe * fmask
        return F_i + 0.5 * phi.sum(dim=(1, 3))

    return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                     name="eam")


# ----------------------------------------------------------------------
# Static candidate pairs with fitted pair tables
# ----------------------------------------------------------------------
def _fit_piecewise_poly(xs: np.ndarray, ys: np.ndarray, n_seg: int, degree: int):
    """Least-squares piecewise polynomial on uniform segments of [0, xmax]:
    (n_seg, degree + 1) coefficients in the local t in [0, 1), highest
    power first (Horner order)."""
    seg_w = xs[-1] / n_seg
    coeffs = np.zeros((n_seg, degree + 1))
    for s in range(n_seg):
        lo, hi = s * seg_w, (s + 1) * seg_w
        m = (xs >= lo) & (xs <= hi)
        coeffs[s] = np.linalg.lstsq(np.vander((xs[m] - lo) / seg_w, degree + 1), ys[m],
                                    rcond=None)[0]
    return coeffs


def _poly_eval(tables: torch.Tensor, table_idx, x, inv_xmax: float, n_seg: int):
    """Piecewise-polynomial evaluation, tables (T, S, D+1): the segment's
    coefficient row by one direct gather (the JAX package's one-hot
    matmul), then Horner."""
    T, S, D1 = tables.shape
    p = torch.clamp(x * inv_xmax * S, 0.0, S - 1e-6)
    seg = p.to(torch.int64)
    t = p - seg.to(p.dtype)
    c = tables.reshape(T * S, D1)[seg if T == 1 else table_idx * S + seg]
    acc = c[..., 0]
    for k in range(1, D1):
        acc = acc * t + c[..., k]
    return acc


def make_eam_static(tables: EAMTables, nbr_table, mode: str = "poly", n_seg: int = 32,
                    degree: int = 6, dtype=None, gather_via_matmul: bool = False,
                    device: str | torch.device = "cuda") -> Potential:
    """EAM over a static candidate-pair table (``core/static_neighbors.py``);
    positions must be slot-realized geometries of the table's spec.

    mode="poly" replaces the pair splines by piecewise polynomials fitted
    to them (32 segments x degree 6, ~1e-6 eV deviation); "spline" keeps
    the exact LAMMPS interpolation on the reduced pairs; "cheb" fits one
    degree-24 Chebyshev series per pair table on [0.8 A, nr * dr] and adds
    a quartic repulsion wall below 0.8 A, so overlap states stay rejected.
    F(rho) is always the exact spline.

    ``gather_via_matmul`` selects the JAX package's MXU routing of the cheb
    mode (constant 0/1 matmuls in place of the neighbour gather and the
    per-atom sum). It computes the same function, so here it is accepted
    (cheb mode only, as in JAX) and the direct gather runs.
    """
    _check_dtype(dtype)
    if gather_via_matmul and mode != "cheb":
        raise ValueError("gather_via_matmul is implemented for the cheb mode")
    dev = resolve_device(device)
    T = len(tables.numbers)
    cutoff = float(tables.cutoff)
    slot_j = torch.as_tensor(np.asarray(nbr_table.slot_j, np.int64), device=dev)
    shift = torch.as_tensor(np.asarray(nbr_table.shift, np.float32), device=dev)
    valid = torch.as_tensor(np.asarray(nbr_table.valid, bool), device=dev)
    frho_c = _frho_stack(tables, dev)
    inv_drho = 1.0 / tables.drho

    if mode == "cheb":
        rng = ChebRange(cutoff, R_LO, float(tables.nr * tables.dr))

        def fits(tabs):
            return torch.as_tensor(
                np.stack([cheb_fit(t, tables.dr, rng.r_lo, rng.r_hi, DEGREE) for t in tabs]),
                dtype=torch.float32, device=dev)

        rhor_u, z2r_u = fits(list(tables.rhor)), fits(_z2r_list(tables))

        def per_atom(positions, type_idx, alive, shifts_unused=None):
            if T == 1:
                rho_sel = z2r_sel = None
            else:
                rho_sel = type_idx[:, slot_j]
                z2r_sel = type_idx[:, :, None] * T + rho_sel
            rho_i, ep = cheb_rho_ep(positions, alive, slot_j, shift, valid, rhor_u, z2r_u, rng,
                                    rho_sel, z2r_sel)
            F_i = spline_eval_onehot(frho_c, rho_i, inv_drho, table_idx=type_idx)
            return torch.where(alive, F_i, torch.zeros_like(F_i)) + ep

        return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                         name="eam")

    if mode == "spline":
        rhor_c = _spline_stack(list(tables.rhor), dev)
        z2r_c = _spline_stack(_z2r_list(tables), dev)
        inv_dr = 1.0 / tables.dr

        def eval_rhor(r, tj):
            return spline_eval(rhor_c, r, inv_dr, table_idx=tj)

        def eval_z2r(r, pair_t):
            return spline_eval(z2r_c, r, inv_dr, table_idx=pair_t)

    elif mode == "poly":
        r_grid = np.linspace(0.0, tables.nr * tables.dr, 16 * tables.nr)

        def fit(tabs):
            return torch.as_tensor(np.stack([
                _fit_piecewise_poly(r_grid, spline_eval_np(lammps_spline_coeffs(t), r_grid,
                                                           tables.dr), n_seg, degree)
                for t in tabs]), dtype=torch.float32, device=dev)

        rhor_p, z2r_p = fit(list(tables.rhor)), fit(_z2r_list(tables))
        inv_rmax = 1.0 / float(r_grid[-1])

        def eval_rhor(r, tj):
            return _poly_eval(rhor_p, tj, r, inv_rmax, n_seg)

        def eval_z2r(r, pair_t):
            return _poly_eval(z2r_p, pair_t, r, inv_rmax, n_seg)

    else:
        raise ValueError(f"unknown mode {mode!r}: poly, spline or cheb")

    def per_atom(positions, type_idx, alive, shifts_unused=None):
        pj = positions[:, slot_j]                                # (C, N, M, 3)
        disp = positions[:, :, None, :] - (pj + shift)
        r = torch.sqrt(torch.clamp((disp * disp).sum(dim=-1), min=1e-12))
        tj = type_idx[:, slot_j]
        mask = valid & alive[:, :, None] & alive[:, slot_j] & (r < cutoff)
        fmask = mask.to(r.dtype)
        rsafe = torch.where(mask, r, torch.full_like(r, cutoff))
        rho_i = (eval_rhor(rsafe, tj) * fmask).sum(dim=2)
        F_i = spline_eval_onehot(frho_c, rho_i, inv_drho, table_idx=type_idx)
        F_i = torch.where(alive, F_i, torch.zeros_like(F_i))
        phi = eval_z2r(rsafe, type_idx[:, :, None] * T + tj) / rsafe * fmask
        return F_i + 0.5 * phi.sum(dim=2)

    return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                     name="eam")


# ----------------------------------------------------------------------
# Rigid lattices: every pair distance is a constant of the system, so the
# energy is a pair of dense quadratic forms over the occupancy
# ----------------------------------------------------------------------
def make_eam_rigid(tables: EAMTables, spec, dtype=None,
                   device: str | torch.device = "cuda") -> Potential:
    """EAM for rigid (unrelaxed) MC as precomputed quadratic forms.

    Slot positions are static templates, so the exact spline values of
    every candidate pair (i, j) over all images are summed on the host in
    float64 into per-source-type density matrices W_rho[t'] (N, N) and pair
    matrices Phi[t, t'] (N, N). For the one-hot occupancy a (C, N, T):

        rho_i = sum_t' (W_rho[t'] a_t')_i
        E     = sum_i sum_t a_t,i F_t(rho_i) + 1/2 a_t,i (Phi[t, t'] a_t')_i

    two f32 einsums and the embedding lookup per evaluation, with exact
    LAMMPS table values. Requires single-atom adsorbates (code-independent
    slot positions); positions passed in are ignored.
    """
    _check_dtype(dtype)
    K1, G = spec.code_offsets.shape[:2]
    if G != 1 or np.abs(spec.code_offsets).max() > 1e-12:
        raise ValueError("make_eam_rigid requires single-atom adsorbates with code-"
                         "independent slot positions (group vocabularies move atoms)")
    dev = resolve_device(device)
    T = len(tables.numbers)
    N = spec.n_slots
    nbr = build_static_neighbor_table(spec, tables.cutoff, relax_slack=0.0)
    centers = np.concatenate([spec.pristine_positions, spec.site_coords])
    rho_c = [lammps_spline_coeffs(tables.rhor[t]) for t in range(T)]
    z2r_c = {(a, b): lammps_spline_coeffs(tables.z2r[a, b]) for a in range(T) for b in range(T)}
    W_rho = np.zeros((T, N, N))
    Phi = np.zeros((T, T, N, N))
    cutoff = float(tables.cutoff)
    for i in range(N):
        js = nbr.slot_j[i][nbr.valid[i]]
        shs = nbr.shift[i][nbr.valid[i]]
        r = np.linalg.norm(centers[i] - (centers[js] + shs), axis=1)
        within = r < cutoff
        js, r = js[within], r[within]
        for tsrc in range(T):
            np.add.at(W_rho[tsrc][i], js, spline_eval_np(rho_c[tsrc], r, tables.dr))
        for ta in range(T):
            for tb in range(T):
                np.add.at(Phi[ta, tb][i], js, spline_eval_np(z2r_c[(ta, tb)], r, tables.dr) / r)
    W = torch.as_tensor(W_rho, dtype=torch.float32, device=dev)        # (T, N, N)
    Ph = torch.as_tensor(Phi, dtype=torch.float32, device=dev)         # (T, T, N, N)
    frho_c = _frho_stack(tables, dev)
    inv_drho = 1.0 / tables.drho

    def per_atom(positions, type_idx, alive, shifts_unused=None):
        a = (torch.nn.functional.one_hot(type_idx, T).to(torch.float32)
             * alive.to(torch.float32)[..., None])                     # (C, N, T)
        rho = torch.einsum("tij,cjt->ci", W, a)
        F = spline_eval_onehot(frho_c, rho, inv_drho, table_idx=type_idx)
        pair = torch.einsum("stij,cjt->cis", Ph, a)                    # (C, N, T)
        e_pair = 0.5 * (a * pair).sum(dim=2)
        return torch.where(alive, F, torch.zeros_like(F)) + e_pair

    return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                     name="eam-rigid")
