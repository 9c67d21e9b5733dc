"""Stillinger-Weber potential (LAMMPS pair_style sw compatible), batched
over chains.

The counterpart of ``surface_sampling_tpu/potentials/sw.py``: the Si(111)
5x5 tutorial's potential.

    E    = sum_{i<j} phi2(r_ij) + sum_i sum_{j<k} phi3(r_ij, r_ik, theta)
    phi2 = A eps [B (sig/r)^p - (sig/r)^q] exp(sig / (r - a sig))
    phi3 = lam eps [cos(theta) - cos0]^2
           exp(gam_ij sig_ij / (r_ij - a_ij sig_ij))
           exp(gam_ik sig_ik / (r_ik - a_ik sig_ik))

Two-body parameters from the (i, j, j) entry, three-body from (i, j, k),
the LAMMPS conventions. Ships the original Si parameterization
(Stillinger & Weber, PRB 31, 5262 (1985)) and reads parameter tables of
modified variants (LAMMPS ``.sw`` files and OpenKIM ThreeBodyCluster
parameter files).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.potentials.base import Potential
from surface_sampling_tpu_torch.potentials.tersoff import (
    _make_edge_fn,
    _neighbor_types,
    _with_hooks,
)

_FIELDS = ("eps", "sig", "a", "lam", "gam", "cos0", "A", "B", "p", "q", "tol")

# Stillinger & Weber PRB 31, 5262 (1985), table I (LAMMPS Si.sw values).
SW_SI_1985 = {
    "elements": ("Si",),
    "entries": {
        ("Si", "Si", "Si"): dict(
            eps=2.1683, sig=2.0951, a=1.80, lam=21.0, gam=1.20,
            cos0=-1.0 / 3.0, A=7.049556277, B=0.6022245584, p=4.0, q=0.0, tol=0.0,
        )
    },
}


@dataclass
class SWTables:
    elements: tuple[str, ...]
    params: dict[str, np.ndarray]   # (T, T, T) each

    @property
    def cutoff(self) -> float:
        return float((self.params["a"] * self.params["sig"]).max())


def sw_tables(data: dict | None = None) -> SWTables:
    """Build parameter tensors from an entries dict (default: SW85 Si)."""
    data = data or SW_SI_1985
    elements = tuple(data["elements"])
    T = len(elements)
    params = {f: np.zeros((T, T, T)) for f in _FIELDS}
    for (e1, e2, e3), vals in data["entries"].items():
        t1, t2, t3 = (elements.index(e) for e in (e1, e2, e3))
        for f in _FIELDS:
            params[f][t1, t2, t3] = vals[f]
    return SWTables(elements=elements, params=params)


def parse_sw(text: str, elements: list[str] | None = None) -> SWTables:
    """Parse a LAMMPS .sw file (11 numbers per entry)."""
    tokens: list[str] = []
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if line:
            tokens.extend(line.split())
    entries = {}
    i = 0
    while i < len(tokens):
        e1, e2, e3 = tokens[i : i + 3]
        vals = [float(x) for x in tokens[i + 3 : i + 14]]
        entries[(e1, e2, e3)] = dict(zip(_FIELDS, vals))
        i += 14
    elements = elements or sorted({e for k in entries for e in k})
    return sw_tables({"elements": elements, "entries": entries})


def load_sw(path: str | Path, elements=None) -> SWTables:
    return parse_sw(Path(path).read_text(), elements)


# OpenKIM ThreeBodyCluster-driver parameter names, per triplet entry.
_KIM_FIELDS = ("A", "B", "p", "q", "sigma", "lambda", "gamma", "cutoff")


def sw_tables_from_kim(data: dict) -> SWTables:
    """Build SWTables from parameters in the OpenKIM *ThreeBodyCluster*
    driver convention — the form the reference's Si(111) 5x5 relaxation
    model publishes its constants in
    (``ThreeBodyCluster_SRS_StephensonRadnySmith_1996_Si``,
    the tutorial's Si_111_5x5_lammps_opt_template.txt:18).

    ThreeBodyCluster writes the potential un-reduced (energies/lengths
    absorbed into the constants)::

        phi2(r)  = A (B r^-p - r^-q) exp[sigma / (r - cutoff)]
        phi3     = lambda (cos theta_jik - costheta0)^2
                   exp[gamma / (r_ij - cutoff)] exp[gamma / (r_ik - cutoff)]

    while SWTables stores the LAMMPS ``pair_style sw`` reduced form (see
    module docstring). The exact mapping (with eps := 1, so A and lam
    carry the energy scale):

        sig = sigma            a   = cutoff / sigma
        gam = gamma / sigma    lam = lambda
        A   = A_kim / sigma**q B   = B_kim * sigma**(q - p)

    Sanity anchor: KIM's SW85 Si file (A=15.2848479197914 = 7.049556277
    * eps with eps=2.1682 eV, B=A*B_red*sigma**4/A, gamma=1.2*sigma,
    cutoff=1.8*sigma) maps back to the SW_SI_1985 table above to within
    the eps rounding KIM itself uses (2.1682 vs LAMMPS's 2.1683).

    ``data``: {"elements": [...], "entries": {(e1,e2,e3): {A, B, p, q,
    sigma, lambda, gamma, cutoff[, costheta0]}}}; ``costheta0`` defaults
    to -1/3. To run the reference's SRS relaxation model, transcribe the
    KIM model's parameter file into this dict and pass the result as
    ``systems.si111_sw(relax_model=...)``.
    """
    elements = tuple(data["elements"])
    entries = {}
    for key, kv in data["entries"].items():
        missing = [f for f in _KIM_FIELDS if f not in kv]
        if missing:
            raise ValueError(f"KIM SW entry {key} missing fields {missing}")
        sig = float(kv["sigma"])
        p, q = float(kv["p"]), float(kv["q"])
        entries[key] = dict(
            eps=1.0,
            sig=sig,
            a=float(kv["cutoff"]) / sig,
            lam=float(kv["lambda"]),
            gam=float(kv["gamma"]) / sig,
            cos0=float(kv.get("costheta0", -1.0 / 3.0)),
            A=float(kv["A"]) / sig**q,
            B=float(kv["B"]) * sig ** (q - p),
            p=p,
            q=q,
            tol=0.0,
        )
    return sw_tables({"elements": elements, "entries": entries})


# canonical ThreeBodyCluster per-triplet field order (with costheta0;
# 8-number files omit it and default to the SW tetrahedral -1/3)
_KIM_FILE_FIELDS9 = ("A", "B", "p", "q", "sigma", "lambda", "gamma",
                     "costheta0", "cutoff")
_KIM_ALIASES = {
    "costheta_0": "costheta0", "cos0": "costheta0", "costheta": "costheta0",
    "lam": "lambda", "gam": "gamma", "sig": "sigma", "rcut": "cutoff",
    "cut": "cutoff", "a_kim": "A", "b_kim": "B",
}


def _kim_header_fields(text: str):
    """Field order declared in a comment header, if any: a comment line
    naming >= 6 of the known ThreeBodyCluster fields fixes the column
    order (many KIM parameter files carry exactly such a line)."""
    known = set(_KIM_FILE_FIELDS9)
    for line in text.splitlines():
        s = line.strip()
        if not s.startswith(("#", "!", "//")):
            continue
        toks = [
            _KIM_ALIASES.get(t.strip("():,[]").lower(), t.strip("():,[]"))
            for t in s.lstrip("#!/ ").replace("=", " ").split()
        ]
        named = [t if t in ("A", "B") else t.lower() for t in toks]
        hits = [t for t in named if t in known or t in ("A", "B")]
        if len([h for h in hits if h in known]) >= 6:
            return tuple(h for h in hits if h in known)
    return None


def parse_kim_threebody(text: str, elements=None, fields=None) -> SWTables:
    """Parse an OpenKIM *ThreeBodyCluster* model parameter file — the
    format the reference's Si(111) 5x5 relaxation model ships its
    constants in (``ThreeBodyCluster_SRS_StephensonRadnySmith_1996_Si``;
    the tutorial's lammps_opt_template.txt:18 names
    the model, whose ``.params`` file is not redistributable here — drop
    it next to the tutorial).

    Layout handled (whitespace/comment tolerant):

      * optional leading species block: an integer count followed by
        that many element symbols (the common KIM convention);
      * per-triplet entries, either LABELED (``E1 E2 E3`` followed by
        the numbers, any triplet order — LAMMPS-.sw style) or BARE
        numbers (single-species files: exactly one entry);
      * 9 numbers per entry in the driver order A B p q sigma lambda
        gamma costheta0 cutoff, or 8 with costheta0 omitted (defaults
        to -1/3). A comment header naming the columns overrides the
        order; ``fields=`` overrides both.

    Returns SWTables in the LAMMPS reduced convention via
    :func:`sw_tables_from_kim` (exact mapping documented there).
    """
    if fields is None:
        fields = _kim_header_fields(text) or _KIM_FILE_FIELDS9
    fields = tuple(fields)
    tokens: list[str] = []
    for line in text.splitlines():
        for stop in ("#", "!", "//"):
            line = line.split(stop)[0]
        tokens.extend(line.split())

    def is_num(t):
        try:
            float(t)
            return True
        except ValueError:
            return False

    pos = 0
    species = None
    # optional "N species..." prologue: integer then N non-numeric symbols
    if tokens and is_num(tokens[0]) and float(tokens[0]).is_integer():
        n = int(float(tokens[0]))
        cand = tokens[1 : 1 + n]
        if len(cand) == n and all(not is_num(t) for t in cand):
            species = [t for t in cand]
            pos = 1 + n
    entries = {}
    labeled = pos < len(tokens) and not is_num(tokens[pos])
    nf, nf8 = len(fields), len(fields) - (1 if "costheta0" in fields else 0)
    while pos < len(tokens):
        if labeled:
            e1, e2, e3 = tokens[pos : pos + 3]
            pos += 3
        else:
            if species is None or len(species) != 1:
                raise ValueError(
                    "bare-number KIM entries need a single-species file "
                    "(or label each triplet E1 E2 E3 ...)"
                )
            e1 = e2 = e3 = species[0]
        nums = []
        while pos < len(tokens) and is_num(tokens[pos]) and len(nums) < nf:
            nums.append(float(tokens[pos]))
            pos += 1
        if len(nums) == nf:
            kv = dict(zip(fields, nums))
        elif len(nums) == nf8:
            kv = dict(zip([f for f in fields if f != "costheta0"], nums))
        else:
            raise ValueError(
                f"KIM entry ({e1},{e2},{e3}) has {len(nums)} numbers; "
                f"expected {nf} ({' '.join(fields)}) or {nf8} (costheta0 "
                "defaulting to -1/3)"
            )
        entries[(e1, e2, e3)] = kv
    if not entries:
        raise ValueError("no parameter entries found in KIM file")
    elements = list(elements) if elements else (
        species or sorted({e for k in entries for e in k}))
    return sw_tables_from_kim({"elements": elements, "entries": entries})


def load_kim_threebody(path: str | Path, elements=None, fields=None) -> SWTables:
    return parse_kim_threebody(Path(path).read_text(), elements, fields)


def load_sw_any(path: str | Path, elements=None) -> SWTables:
    """Load either a LAMMPS ``.sw`` file or a KIM ThreeBodyCluster
    parameter file, sniffing by extension then content: ``.sw`` parses as
    LAMMPS; anything else tries the KIM layout first and falls back to
    LAMMPS. This is what ``systems.si111_sw(relax_model=path)`` uses, so
    the SRS drop-in works with the file in either convention."""
    p = Path(path)
    text = p.read_text()
    if p.suffix == ".sw":
        return parse_sw(text, elements)
    try:
        return parse_kim_threebody(text, elements)
    except (ValueError, IndexError):
        return parse_sw(text, elements)


def make_sw(tables: SWTables, max_neighbors: int = 16, dtype=None, static_nbr=None,
            device: str | torch.device = "cuda") -> Potential:
    """The Stillinger-Weber potential of (C, N) batches. ``static_nbr`` ranks
    only the spec's candidate pairs and gives the potential the relax
    loop's topology hooks (see ``potentials.tersoff.make_tersoff``).
    ``dtype`` must be None or ``torch.float32``; ``device`` defaults to
    "cuda" and raises without a card."""
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

    def _radial(r, sig, a, inside):
        """exp(sig / (r - a sig)), 0 at and beyond the cutoff a sig."""
        return torch.where(inside, torch.exp(sig / torch.where(inside, r - a * sig, -1.0)), 0.0)

    def per_atom(positions, type_idx, alive, shifts=None, edges=None):
        disp, r, nbr_j, nbr_mask = (edges if edges is not None
                                    else edge_fn(positions, alive, shifts))[:4]
        ti = type_idx[:, :, None]
        tj = _neighbor_types(type_idx, nbr_j)
        # two-body (i, j, j)
        idx2 = flat3(ti, tj, tj)
        sig, aa = p3["sig"][idx2], p3["a"][idx2]
        inside2 = nbr_mask & (r < aa * sig - 1e-9)
        sr = sig / torch.clamp(r, min=1e-12)
        phi2 = (p3["A"][idx2] * p3["eps"][idx2]
                * (p3["B"][idx2] * sr ** p3["p"][idx2] - sr ** p3["q"][idx2])
                * _radial(r, sig, aa, inside2))
        e2 = 0.5 * torch.where(inside2, phi2, 0.0).sum(dim=2)
        # three-body (i, j, k): both legs take gamma / sigma / a of (i, j, k)
        idx3 = flat3(ti[..., None], tj[..., None], tj[:, :, None, :])    # (C, N, M, M)
        sig3, a3, gam3 = p3["sig"][idx3], p3["a"][idx3], p3["gam"][idx3]
        r_ij, r_ik = r[..., None], r[:, :, None, :]
        in_ij = r_ij < a3 * sig3 - 1e-9
        in_ik = r_ik < a3 * sig3 - 1e-9
        h_ij = torch.where(in_ij, torch.exp(gam3 * sig3 / torch.where(in_ij, r_ij - a3 * sig3,
                                                                      -1.0)), 0.0)
        h_ik = torch.where(in_ik, torch.exp(gam3 * sig3 / torch.where(in_ik, r_ik - a3 * sig3,
                                                                      -1.0)), 0.0)
        unit = disp / torch.clamp(r, min=1e-12)[..., None]
        dcos = torch.einsum("cnmx,cnkx->cnmk", unit, unit) - p3["cos0"][idx3]
        phi3 = p3["lam"][idx3] * p3["eps"][idx3] * dcos * dcos * h_ij * h_ik
        M = r.shape[2]
        not_same = ~torch.eye(M, dtype=torch.bool, device=r.device)
        kmask = nbr_mask[..., None] & nbr_mask[:, :, None, :] & not_same
        e3 = 0.5 * torch.where(kmask, phi3, 0.0).sum(dim=(2, 3))
        return torch.where(alive, e2 + e3, 0.0)

    def energy(positions, type_idx, alive, shifts=None, edges=None):
        return per_atom(positions, type_idx, alive, shifts, edges=edges).sum(dim=1)

    return _with_hooks(energy, per_atom, cutoff, "sw", table)
