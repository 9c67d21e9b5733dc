"""Workflow helpers (the counterpart of ``surface_sampling_tpu/utils/misc.py``):
distance filters, rattles, the distance-decay weights of the canonical
switch proposal, layer trimming and structure loading. Host numpy."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial import distance as _sdist
from scipy.special import softmax

from surface_sampling_tpu_torch.structure.atoms import Structure


def filter_distances(st: Structure, ads=("O",), cutoff_distance: float = 1.5) -> bool:
    """True iff every minimum-image distance between two atoms of the
    species ``ads`` exceeds ``cutoff_distance``."""
    mask = np.isin(np.array(st.symbols), list(ads))
    if mask.sum() < 2:
        return True
    d = st.all_distances(mic=True)[mask][:, mask]
    iu = np.triu_indices(len(d), k=1)
    vals = d[iu]
    return not np.any((vals > 0) & (vals <= cutoff_distance))


def randomize_structure(st: Structure, amplitude: float, displace_lattice: bool = True,
                        rng=None) -> Structure:
    """Uniform random rattle of the positions (and, with
    ``displace_lattice``, of the cell) by up to ``amplitude``."""
    rng = rng or np.random.default_rng()
    out = st.copy()
    out.positions = out.positions + rng.uniform(-amplitude, amplitude, out.positions.shape)
    if displace_lattice:
        out.cell = out.cell + rng.uniform(-amplitude, amplitude, (3, 3))
    return out


def compute_distance_weight_matrix(ads_coords: np.ndarray,
                                   distance_decay_factor: float) -> np.ndarray:
    """(S, S) row softmax of -d_ij / tau over the site pairs: the weights of
    the canonical switch proposal's distance decay
    (``core.events.make_canonical_step(require_distance_decay=True)``)."""
    d = _sdist.cdist(ads_coords, ads_coords, "euclidean")
    w = softmax(-d / distance_decay_factor, axis=1)
    assert np.allclose(w.sum(axis=1), 1.0)
    return w


def group_layers_with_indices(z: np.ndarray, threshold: float = 0.1):
    """Group z coordinates into layers split where the gap between
    consecutive sorted values exceeds ``threshold``; returns (layer_z,
    layer_indices), lists ordered bottom-up."""
    z = np.asarray(z, float)
    order = np.argsort(z)
    zs = z[order]
    breaks = np.where(np.diff(zs) > threshold)[0] + 1
    return list(np.split(zs, breaks)), list(np.split(order, breaks))


def preprocess_traj(structures: list[Structure], z_cutoff: int | None = None,
                    z_threshold: float = 0.1) -> list[Structure]:
    """Drop the bottom ``z_cutoff`` atomic layers of each structure and
    shift the rest down by the removed height (the dataset preparation
    before uncertainty or clustering scores); with None, only z-sort."""
    out = []
    for st in structures:
        z = st.positions[:, 2]
        if z_cutoff is None:
            out.append(st.select(np.argsort(z)))
            continue
        layer_z, layer_idx = group_layers_with_indices(z, z_threshold)
        if z_cutoff >= len(layer_z):
            raise ValueError(f"z_cutoff={z_cutoff} >= number of layers {len(layer_z)}")
        keep = np.ones(len(st), bool)
        for idx in layer_idx[:z_cutoff]:
            keep[idx] = False
        shift = np.mean(layer_z[z_cutoff]) - np.mean(layer_z[0])
        red = st.select(keep)
        red.positions = red.positions - np.array([0.0, 0.0, shift])
        out.append(red)
    return out


def load_structures_any(path: str | Path) -> list[Structure]:
    """Structures from an .npz bundle, a .cif, an .xyz, or a .txt list of
    such paths (one a line)."""
    from surface_sampling_tpu_torch.structure.io import load_structures_npz, read_cif, read_xyz

    path = Path(path)
    if path.suffix == ".txt":
        out: list[Structure] = []
        for line in path.read_text().splitlines():
            line = line.strip()
            if line:
                out.extend(load_structures_any(line))
        return out
    if path.suffix == ".npz":
        return load_structures_npz(path)[0]
    if path.suffix == ".cif":
        return [read_cif(path)]
    if path.suffix == ".xyz":
        return [read_xyz(path)]
    raise ValueError(f"unsupported structure file {path}")
