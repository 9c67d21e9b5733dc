"""Static surface-system specification and fixed-shape slot layout.

The counterpart of ``surface_sampling_tpu/core/spec.py``. The layout is
static: the slab's P pristine atoms occupy slots [0, P); every virtual
site s owns a private block of G slots [P + s*G, P + (s+1)*G), where G is
the largest adsorbate group. The only mutable occupancy state is the
adsorbate code of each site (0 = empty), so a move is one integer write.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from surface_sampling_tpu_torch.constants import Z_FROM_SYMBOL, parse_formula
from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for
from surface_sampling_tpu_torch.structure.atoms import Structure

# Rigid adsorbate group geometries: "HO" = O at the site + H 1.0 A along x;
# "H2O" = O at the site + two H at 60 degrees.
_SQRT3_2 = float(np.sqrt(3.0) / 2.0)
BUILTIN_GROUPS: dict[str, tuple[tuple[str, ...], np.ndarray]] = {
    "HO": (("O", "H"), np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])),
    "OH": (("O", "H"), np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])),
    "H2O": (
        ("O", "H", "H"),
        np.array([[0.0, 0.0, 0.0], [0.5, -_SQRT3_2, 0.0], [0.5, _SQRT3_2, 0.0]]),
    ),
}


@dataclass(frozen=True)
class AdsorbateType:
    """One entry of the adsorbate vocabulary (code >= 1)."""

    name: str                       # "Cu", "O", "HO", "H2O", ...
    numbers: tuple[int, ...]        # atomic numbers of the group's atoms
    offsets: np.ndarray             # (len(numbers), 3) offsets from the site

    @classmethod
    def from_name(cls, name: str) -> "AdsorbateType":
        if name in BUILTIN_GROUPS:
            syms, offs = BUILTIN_GROUPS[name]
            return cls(name, tuple(Z_FROM_SYMBOL[s] for s in syms), np.array(offs))
        counts = parse_formula(name)
        if sum(counts.values()) == 1:
            sym = next(iter(counts))
            return cls(name, (Z_FROM_SYMBOL[sym],), np.zeros((1, 3)))
        raise ValueError(
            f"Adsorbate {name!r} is not a single atom or a builtin group "
            f"({sorted(BUILTIN_GROUPS)}); register custom groups explicitly."
        )


@dataclass(frozen=True)
class SurfaceSpec:
    """Everything static about a surface system (host numpy). Build with
    :func:`make_spec`."""

    pristine_numbers: np.ndarray        # (P,)
    pristine_positions: np.ndarray      # (P, 3)
    cell: np.ndarray                    # (3, 3)
    frozen_pristine: np.ndarray         # (P,) bool — bulk atoms
    site_coords: np.ndarray             # (S, 3)
    vocab: tuple[AdsorbateType, ...]    # codes 1..K
    group_size: int                     # G
    code_numbers: np.ndarray            # (K+1, G) atomic numbers per code, 0-padded
    code_offsets: np.ndarray            # (K+1, G, 3) position offsets per code
    code_natoms: np.ndarray             # (K+1,)
    element_zs: np.ndarray              # (E,) sorted atomic numbers present
    z_to_element: np.ndarray            # (Zmax+2,) -> element slot or -1
    type_of_z: np.ndarray               # (Zmax+2,) -> potential type index (or 0)
    shifts: np.ndarray                  # (Kimg, 3) periodic images for the cutoff
    surface_name: str = "surface"

    @property
    def n_pristine(self) -> int:
        return len(self.pristine_numbers)

    @property
    def n_sites(self) -> int:
        return len(self.site_coords)

    @property
    def n_codes(self) -> int:
        return len(self.vocab) + 1

    @property
    def n_slots(self) -> int:
        return self.n_pristine + self.n_sites * self.group_size


def make_spec(
    slab: Structure,
    site_coords: np.ndarray,
    adsorbates: list[str | AdsorbateType],
    potential_numbers: np.ndarray | list[int],
    cutoff: float,
    surface_depth: int | None = None,
    frozen_mask: np.ndarray | None = None,
    surface_name: str | None = None,
    extra_elements: list[str] | None = None,
) -> SurfaceSpec:
    """Build a SurfaceSpec from a slab + sites + adsorbate vocabulary.

    Args:
        slab: pristine slab structure.
        site_coords: (S, 3) virtual adsorption-site cartesian coordinates.
        adsorbates: vocabulary of adsorbate names/types (codes 1..K in order).
        potential_numbers: atomic numbers of the potential's type table.
        cutoff: interaction cutoff (drives periodic image selection).
        surface_depth: number of top z-layers free to relax; deeper atoms are
            frozen. None = all free.
        frozen_mask: explicit (P,) bool override for frozen atoms.
        surface_name: label for run folders.
        extra_elements: additional element symbols to track in counts.
    """
    vocab = tuple(
        a if isinstance(a, AdsorbateType) else AdsorbateType.from_name(a) for a in adsorbates
    )
    G = max((len(v.numbers) for v in vocab), default=1)
    K = len(vocab)
    code_numbers = np.zeros((K + 1, G), dtype=np.int32)
    code_offsets = np.zeros((K + 1, G, 3), dtype=np.float64)
    for c, v in enumerate(vocab, start=1):
        n = len(v.numbers)
        code_numbers[c, :n] = v.numbers
        code_offsets[c, :n] = v.offsets
    code_natoms = (code_numbers > 0).sum(axis=1).astype(np.int32)

    if frozen_mask is None:
        if surface_depth is not None:
            frozen_mask = slab.get_layers() > surface_depth
        else:
            frozen_mask = np.zeros(len(slab), dtype=bool)

    zs = set(int(z) for z in slab.numbers) | {int(z) for v in vocab for z in v.numbers}
    for sym in extra_elements or []:
        zs.add(Z_FROM_SYMBOL[sym])
    element_zs = np.array(sorted(zs), dtype=np.int32)
    zmax = int(element_zs.max())
    z_to_element = -np.ones(zmax + 2, dtype=np.int32)
    for i, z in enumerate(element_zs):
        z_to_element[z] = i

    pot_numbers = np.asarray(potential_numbers, dtype=np.int32)
    type_of_z = np.zeros(zmax + 2, dtype=np.int32)
    for t, z in enumerate(pot_numbers):
        if z <= zmax + 1:
            type_of_z[z] = t

    # periodic images: span covers slab plus sites plus group offsets
    all_pts = np.concatenate([slab.positions, np.asarray(site_coords).reshape(-1, 3)])
    frac = np.linalg.solve(slab.cell.T, all_pts.T).T
    shifts = pair_shifts_for(slab.cell, frac, cutoff, pbc=(True, True, True), span_pad=3.0)

    return SurfaceSpec(
        pristine_numbers=np.asarray(slab.numbers, dtype=np.int32),
        pristine_positions=np.asarray(slab.positions, dtype=np.float64),
        cell=np.asarray(slab.cell, dtype=np.float64),
        frozen_pristine=np.asarray(frozen_mask, dtype=bool),
        site_coords=np.asarray(site_coords, dtype=np.float64),
        vocab=vocab,
        group_size=G,
        code_numbers=code_numbers,
        code_offsets=code_offsets,
        code_natoms=code_natoms,
        element_zs=element_zs,
        z_to_element=z_to_element,
        type_of_z=type_of_z,
        shifts=shifts,
        surface_name=surface_name or slab.formula,
    )


def make_spec_sampling_surface_atoms(
    slab: Structure,
    surface_atom_mask: np.ndarray,
    adsorbates: list[str],
    potential_numbers,
    cutoff: float,
    extra_site_coords: np.ndarray | None = None,
    **kwargs,
):
    """A spec whose masked surface atoms are exchangeable adsorbates: they
    leave the pristine slab and their positions become the first sites,
    pre-occupied by their own element (a vocabulary entry is added for each
    element not named in ``adsorbates``), followed by the empty
    ``extra_site_coords``. ``kwargs`` go to :func:`make_spec`.

    Returns (spec, site_state0), the (S,) int32 codes of the pre-occupied
    start state."""
    surface_atom_mask = np.asarray(surface_atom_mask, dtype=bool)
    kept = slab.select(~surface_atom_mask)
    movers = slab.select(surface_atom_mask)
    sites = movers.positions
    if extra_site_coords is not None and len(extra_site_coords):
        sites = np.concatenate([sites, np.asarray(extra_site_coords).reshape(-1, 3)])

    ads_names = list(dict.fromkeys(adsorbates))     # keep order, drop repeats
    for sym in movers.symbols:
        if sym not in ads_names:
            ads_names.append(sym)
    spec = make_spec(kept, sites, ads_names, potential_numbers, cutoff, **kwargs)

    code_of = {v.name: c for c, v in enumerate(spec.vocab, start=1)}
    site_state0 = np.zeros(len(sites), dtype=np.int32)
    site_state0[:len(movers)] = [code_of[sym] for sym in movers.symbols]
    return spec, site_state0
