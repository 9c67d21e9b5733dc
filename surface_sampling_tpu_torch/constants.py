"""Periodic-table data and unit conversions used by the port.

A copy of the parts of ``surface_sampling_tpu/constants.py`` that the
ported paths need; the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from collections import Counter

# fmt: off
CHEMICAL_SYMBOLS = [
    "X",  # Z = 0 is the vacancy / virtual-site marker
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
]
# fmt: on

Z_FROM_SYMBOL: dict[str, int] = {s: z for z, s in enumerate(CHEMICAL_SYMBOLS)}
SYMBOL_FROM_Z: dict[int, str] = dict(enumerate(CHEMICAL_SYMBOLS))

# Unit conversions (CODATA 2018)
HARTREE_TO_EV = 27.211386245988
KCAL_MOL_TO_EV = 0.04336414

# LAMMPS "metal" units Coulomb constant e^2/(4 pi eps0) in eV*Angstrom, as
# used by pair_style eam's funcfl z2r conversion (27.2 * 0.529).
EAM_QQR2E = 27.2 * 0.529


def parse_formula(formula: str) -> dict[str, int]:
    """Parse a simple chemical formula like 'H2O' or 'SrTiO3' into counts."""
    counts: dict[str, int] = {}
    for sym, num in re.findall(r"([A-Z][a-z]?)(\d*)", formula):
        if sym not in Z_FROM_SYMBOL:
            raise ValueError(f"Unknown element {sym!r} in formula {formula!r}")
        counts[sym] = counts.get(sym, 0) + (int(num) if num else 1)
    return counts


def formula_from_numbers(numbers) -> str:
    """Hill-ordered chemical formula from atomic numbers (0s skipped)."""
    cnt = Counter(SYMBOL_FROM_Z[int(z)] for z in numbers if int(z) > 0)
    parts = []
    for sym in (["C", "H"] if "C" in cnt else []):
        if sym in cnt:
            n = cnt.pop(sym)
            parts.append(f"{sym}{n if n > 1 else ''}")
    for sym in sorted(cnt):
        n = cnt[sym]
        parts.append(f"{sym}{n if n > 1 else ''}")
    return "".join(parts)
