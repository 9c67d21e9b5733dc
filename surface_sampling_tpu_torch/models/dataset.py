"""Training datasets: labelled structures loaded into padded batches.

The counterpart of ``surface_sampling_tpu/models/dataset.py``. Datasets
load into ``models.train.PaddedBatch`` arrays from:

  * MPtrj-style JSON: {material_id: {graph_id: {"structure": pymatgen-dict,
    "energy_per_atom" | "uncorrected_energy_per_atom": float,
    "force": [[fx, fy, fz], ...]}}}, or a directory of such shards;
  * flat JSON lists: [{"numbers" | "symbols", "positions", "cell",
    "energy", "forces"}, ...];
  * npz bundles with ``numbers``, ``positions``, ``cells``, ``energies``
    (and ``forces``, ``magmoms``).

Splits use the same ``np.random.default_rng(seed).permutation`` as the JAX
package, so the same seed gives the same train / val / test frames.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from surface_sampling_tpu_torch.constants import Z_FROM_SYMBOL
from surface_sampling_tpu_torch.models.train import pad_structures
from surface_sampling_tpu_torch.structure.atoms import Structure


def _structure_from_pymatgen_dict(d: dict) -> Structure:
    cell = np.asarray(d["lattice"]["matrix"], dtype=np.float64)
    symbols = [site["species"][0]["element"] for site in d["sites"]]
    frac = np.asarray([site["abc"] for site in d["sites"]])
    st = Structure([Z_FROM_SYMBOL[s] for s in symbols], np.zeros((len(symbols), 3)), cell)
    st.set_scaled_positions(frac)
    return st


def _magmom(m):
    return np.asarray(m, dtype=np.float64) if m is not None else None


def load_labelled_structures(path: str | Path, with_magmoms: bool = False):
    """Load (structures, energies, forces[, magmoms]) from a labelled
    dataset file, or a directory of MPtrj JSON shards merged in name order.
    Magmoms are per-atom arrays (None where a frame has no "magmom")."""
    path = Path(path)
    if path.is_dir():
        structures, energies, forces, magmoms = [], [], [], []
        for sub in sorted(path.glob("*.json")):
            s, e, f, m = load_labelled_structures(sub, with_magmoms=True)
            structures += s
            energies += list(e)
            forces += f
            magmoms += m
        out = (structures, np.asarray(energies), forces, magmoms)
        return out if with_magmoms else out[:3]
    if path.suffix == ".npz":
        with np.load(path) as d:
            sts = [Structure(n, p, c) for n, p, c in zip(d["numbers"], d["positions"],
                                                          d["cells"])]
            forces = d["forces"] if "forces" in d.files else np.zeros_like(d["positions"])
            mags = list(d["magmoms"]) if "magmoms" in d.files else [None] * len(sts)
            energies = d["energies"]
        out = (sts, energies, list(forces), mags)
        return out if with_magmoms else out[:3]
    data = json.loads(path.read_text())
    structures, energies, forces, magmoms = [], [], [], []
    if isinstance(data, list):
        for rec in data:
            numbers = (np.asarray(rec["numbers"], np.int32) if "numbers" in rec
                       else [Z_FROM_SYMBOL[s] for s in rec["symbols"]])
            st = Structure(numbers, np.asarray(rec["positions"]), np.asarray(rec["cell"]))
            structures.append(st)
            energies.append(float(rec["energy"]))
            forces.append(np.asarray(rec.get("forces", np.zeros((len(st), 3)))))
            magmoms.append(_magmom(rec.get("magmoms", rec.get("magmom"))))
    else:
        for frames in data.values():
            for frame in frames.values():
                st = _structure_from_pymatgen_dict(frame["structure"])
                epa = frame.get("energy_per_atom", frame.get("uncorrected_energy_per_atom"))
                energies.append(float(epa) * len(st))
                forces.append(np.asarray(frame.get("force", np.zeros((len(st), 3)))))
                magmoms.append(_magmom(frame.get("magmom")))
                structures.append(st)
    out = (structures, np.asarray(energies), forces, magmoms)
    return out if with_magmoms else out[:3]


def make_uncertainty_dataset(structures, cutoff: float, n_max=None):
    """Unlabelled scoring batch: the structures padded into one PaddedBatch
    with zero energy and force labels."""
    energies = np.zeros(len(structures))
    forces = [np.zeros((len(s), 3)) for s in structures]
    return pad_structures(structures, energies, forces, cutoff, n_max=n_max)


def make_clustering_dataset(structures, center_idx_list, cutoff: float, n_max=None):
    """Scoring batch plus per-structure centre masks (B, N): True on the
    atoms whose embeddings are pooled (``models.prediction.get_embedding``'s
    ``center_mask``)."""
    batch = make_uncertainty_dataset(structures, cutoff, n_max=n_max)
    B, N = batch.numbers.shape
    center_mask = np.zeros((B, N), bool)
    for b, idx in enumerate(center_idx_list):
        center_mask[b, np.asarray(idx, dtype=np.int64)] = True
    return batch, center_mask


def get_train_val_test_loader(path: str | Path, cutoff: float, batch_size: int = 16,
                              train_ratio: float = 0.8, val_ratio: float = 0.1, seed: int = 0):
    """Split a labelled dataset into lists of padded train / val / test
    batches (every batch padded to the dataset's largest structure)."""
    structures, energies, forces, magmoms = load_labelled_structures(path, with_magmoms=True)
    have_magmoms = any(m is not None for m in magmoms)
    n = len(structures)
    order = np.random.default_rng(seed).permutation(n)
    n_train = int(round(n * train_ratio))
    n_val = int(round(n * val_ratio))
    splits = (order[:n_train], order[n_train:n_train + n_val], order[n_train + n_val:])
    n_max = max(len(s) for s in structures)

    def batches_of(idx):
        return [pad_structures([structures[i] for i in sel], [energies[i] for i in sel],
                               [forces[i] for i in sel], cutoff, n_max=n_max,
                               magmoms=[magmoms[i] for i in sel] if have_magmoms else None)
                for sel in (idx[lo:lo + batch_size] for lo in range(0, len(idx), batch_size))
                if len(sel)]

    return tuple(batches_of(s) for s in splits)
