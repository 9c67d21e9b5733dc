"""Structure file I/O: CIF (P1), extended XYZ, POSCAR, LAMMPS data and
npz bundles of structures.

The counterpart of ``surface_sampling_tpu/structure/io.py``, with the same
formats and formatting, so that either package reads what the other
writes (host side, numpy).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from surface_sampling_tpu_torch.constants import Z_FROM_SYMBOL
from surface_sampling_tpu_torch.structure.atoms import Structure


def write_cif(path: str | Path, st: Structure) -> None:
    """Write a P1 CIF file."""
    a, b, c = (np.linalg.norm(v) for v in st.cell)
    def angle(u, v):
        cosang = np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
        return np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    alpha = angle(st.cell[1], st.cell[2])
    beta = angle(st.cell[0], st.cell[2])
    gamma = angle(st.cell[0], st.cell[1])
    frac = st.scaled_positions
    lines = [
        "data_image0",
        f"_chemical_formula_sum '{st.formula}'",
        f"_cell_length_a {a:.8f}",
        f"_cell_length_b {b:.8f}",
        f"_cell_length_c {c:.8f}",
        f"_cell_angle_alpha {alpha:.8f}",
        f"_cell_angle_beta {beta:.8f}",
        f"_cell_angle_gamma {gamma:.8f}",
        "_space_group_name_H-M_alt 'P 1'",
        "_space_group_IT_number 1",
        "loop_",
        " _space_group_symop_operation_xyz",
        " 'x, y, z'",
        "loop_",
        " _atom_site_type_symbol",
        " _atom_site_label",
        " _atom_site_fract_x",
        " _atom_site_fract_y",
        " _atom_site_fract_z",
        " _atom_site_occupancy",
    ]
    counts: dict[str, int] = {}
    for sym, f in zip(st.symbols, frac):
        counts[sym] = counts.get(sym, 0) + 1
        lines.append(f" {sym} {sym}{counts[sym]} {f[0]:.8f} {f[1]:.8f} {f[2]:.8f} 1.0000")
    Path(path).write_text("\n".join(lines) + "\n")


def read_cif(path: str | Path) -> Structure:
    """Read a (P1) CIF file written by :func:`write_cif` or similar."""
    text = Path(path).read_text().splitlines()
    params: dict[str, float] = {}
    atoms: list[tuple[str, float, float, float]] = []
    headers: list[str] = []
    in_atom_loop = False
    for raw in text:
        line = raw.strip()
        if line.startswith("_cell_"):
            key, val = line.split()[:2]
            params[key] = float(val)
        elif line == "loop_":
            headers = []
            in_atom_loop = False
        elif line.startswith("_atom_site"):
            headers.append(line.split()[0])
            in_atom_loop = True
        elif in_atom_loop and line and not line.startswith("_"):
            tok = line.split()
            if len(tok) < len(headers):
                continue
            rec = dict(zip(headers, tok))
            sym = rec.get("_atom_site_type_symbol") or rec.get("_atom_site_label")
            sym = "".join(ch for ch in sym if ch.isalpha())
            if sym not in Z_FROM_SYMBOL:
                sym = sym[:1]
            atoms.append(
                (
                    sym,
                    float(rec["_atom_site_fract_x"]),
                    float(rec["_atom_site_fract_y"]),
                    float(rec["_atom_site_fract_z"]),
                )
            )
    cell = _cell_from_params(
        params["_cell_length_a"], params["_cell_length_b"], params["_cell_length_c"],
        params["_cell_angle_alpha"], params["_cell_angle_beta"], params["_cell_angle_gamma"],
    )
    frac = np.array([[x, y, z] for _, x, y, z in atoms])
    st = Structure.from_symbols([s for s, *_ in atoms], np.zeros((len(atoms), 3)), cell)
    st.set_scaled_positions(frac)
    return st


def _cell_from_params(a, b, c, alpha, beta, gamma) -> np.ndarray:
    alpha, beta, gamma = np.radians([alpha, beta, gamma])
    va = np.array([a, 0, 0])
    vb = np.array([b * np.cos(gamma), b * np.sin(gamma), 0])
    cx = c * np.cos(beta)
    cy = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    cz = np.sqrt(max(c**2 - cx**2 - cy**2, 0.0))
    return np.array([va, vb, [cx, cy, cz]])


def write_xyz(path: str | Path, st: Structure, comment: str = "") -> None:
    """Write extended-XYZ with a Lattice tag."""
    cellstr = " ".join(f"{x:.8f}" for x in st.cell.flatten())
    lines = [str(len(st)), f'Lattice="{cellstr}" Properties=species:S:1:pos:R:3 {comment}'.strip()]
    for sym, p in zip(st.symbols, st.positions):
        lines.append(f"{sym} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}")
    Path(path).write_text("\n".join(lines) + "\n")


def read_xyz(path: str | Path) -> Structure:
    lines = Path(path).read_text().splitlines()
    n = int(lines[0])
    comment = lines[1]
    cell = np.eye(3) * 100.0
    if 'Lattice="' in comment:
        lat = comment.split('Lattice="')[1].split('"')[0]
        cell = np.array([float(x) for x in lat.split()]).reshape(3, 3)
    syms, pos = [], []
    for line in lines[2 : 2 + n]:
        tok = line.split()
        syms.append(tok[0])
        pos.append([float(tok[1]), float(tok[2]), float(tok[3])])
    return Structure.from_symbols(syms, np.array(pos), cell)


def write_poscar(path: str | Path, st: Structure) -> None:
    """Write a VASP POSCAR (direct coordinates, grouped by species)."""
    order = np.argsort(st.numbers, kind="stable")
    s = st.select(order)
    uniq, counts = [], []
    for sym in s.symbols:
        if not uniq or uniq[-1] != sym:
            uniq.append(sym)
            counts.append(1)
        else:
            counts[-1] += 1
    lines = [s.formula, "1.0"]
    lines += [" ".join(f"{x:.10f}" for x in row) for row in s.cell]
    lines.append(" ".join(uniq))
    lines.append(" ".join(str(c) for c in counts))
    lines.append("Direct")
    lines += [" ".join(f"{x:.10f}" for x in f) for f in s.scaled_positions]
    Path(path).write_text("\n".join(lines) + "\n")


def write_lammps_data(path: str | Path, st: Structure, type_order: list[str] | None = None) -> None:
    """Write a LAMMPS 'atomic' data file, its cell turned lower-triangular
    as LAMMPS wants it."""
    syms = st.symbols
    types = type_order or sorted(set(syms))
    tmap = {s: i + 1 for i, s in enumerate(types)}
    # LAMMPS wants a lower-triangular cell
    a, b, c = st.cell
    xx = np.linalg.norm(a)
    xy = np.dot(b, a) / xx
    yy = np.sqrt(max(np.dot(b, b) - xy**2, 0))
    xz = np.dot(c, a) / xx
    yz = (np.dot(b, c) - xy * xz) / max(yy, 1e-12)
    zz = np.sqrt(max(np.dot(c, c) - xz**2 - yz**2, 0))
    rot_cell = np.array([[xx, 0, 0], [xy, yy, 0], [xz, yz, zz]])
    frac = st.scaled_positions
    pos = frac @ rot_cell
    lines = [
        f"# {st.formula} written by surface_sampling_tpu_torch",
        "",
        f"{len(st)} atoms",
        f"{len(types)} atom types",
        "",
        f"0.0 {xx:.10f} xlo xhi",
        f"0.0 {yy:.10f} ylo yhi",
        f"0.0 {zz:.10f} zlo zhi",
    ]
    if abs(xy) + abs(xz) + abs(yz) > 1e-10:
        lines.append(f"{xy:.10f} {xz:.10f} {yz:.10f} xy xz yz")
    lines += ["", "Atoms # atomic", ""]
    for i, (s, p) in enumerate(zip(syms, pos), start=1):
        lines.append(f"{i} {tmap[s]} {p[0]:.10f} {p[1]:.10f} {p[2]:.10f}")
    Path(path).write_text("\n".join(lines) + "\n")


def save_structures_npz(path: str | Path, structures: list[Structure], energies=None) -> None:
    """Bundle structures into one npz file. Structures of one size are
    stacked (``numbers`` (B, N), ``positions`` (B, N, 3), ``cells``), the
    JAX package's layout, which either package reads. Structures of
    different sizes (a semigrand run's states) are concatenated along the
    atoms, with ``n_atoms`` (B,) to split them: a layout only this
    package's :func:`load_structures_npz` reads (the JAX package's writer
    refuses such a list)."""
    energies = np.array(energies if energies is not None else [])
    if len({len(s) for s in structures}) > 1:
        np.savez_compressed(
            path,
            numbers=np.concatenate([s.numbers for s in structures]),
            positions=np.concatenate([s.positions for s in structures]),
            cells=np.stack([s.cell for s in structures]),
            n_atoms=np.array([len(s) for s in structures], np.int64),
            energies=energies,
        )
        return
    if structures:
        numbers = np.stack([s.numbers for s in structures])
        positions = np.stack([s.positions for s in structures])
        cells = np.stack([s.cell for s in structures])
    else:
        numbers = np.zeros((0, 0), np.int32)
        positions = np.zeros((0, 0, 3))
        cells = np.zeros((0, 3, 3))
    np.savez_compressed(path, numbers=numbers, positions=positions, cells=cells,
                        energies=energies)


def load_structures_npz(path: str | Path) -> tuple[list[Structure], np.ndarray]:
    """(structures, energies) of a bundle in either layout of
    :func:`save_structures_npz`."""
    with np.load(path) as data:
        numbers, positions = data["numbers"], data["positions"]
        if "n_atoms" in data.files:
            cut = np.cumsum(data["n_atoms"])[:-1]
            numbers, positions = np.split(numbers, cut), np.split(positions, cut)
        sts = [Structure(n, p, c) for n, p, c in zip(numbers, positions, data["cells"])]
        return sts, data["energies"]
