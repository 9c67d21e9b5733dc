"""Periodic-table data and unit conversions used by the port.

A copy of the parts of ``surface_sampling_tpu/constants.py`` that the
ported paths need; the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np

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

ATOMIC_MASSES = np.array([
    0.0,
    1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.95, 39.098, 40.078,
    44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933, 58.693, 63.546, 65.38,
    69.723, 72.630, 74.922, 78.971, 79.904, 83.798, 85.468, 87.62, 88.906, 91.224,
    92.906, 95.95, 97.0, 101.07, 102.91, 106.42, 107.87, 112.41, 114.82, 118.71,
    121.76, 127.60, 126.90, 131.29, 132.91, 137.33, 138.91, 140.12, 140.91, 144.24,
    145.0, 150.36, 151.96, 157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05,
    174.97, 178.49, 180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59,
    204.38, 207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0, 232.04,
    231.04, 238.03, 237.0, 244.0, 243.0, 247.0, 247.0, 251.0, 252.0, 257.0,
])

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
