"""Analytic pair potentials (Lennard-Jones, Morse), batched over chains.

The counterpart of ``surface_sampling_tpu/potentials/pair.py``: engine
tests and reference baselines. Energy shifting is off, as in LAMMPS.
"""

from __future__ import annotations

import torch

from surface_sampling_tpu_torch.ops.neighbors import image_distances, image_pair_mask
from surface_sampling_tpu_torch.potentials.base import Potential, summed


def _pair_per_atom(pair_energy, cutoff: float):
    def per_atom(positions, type_idx, alive, shifts):
        r, _ = image_distances(positions, shifts)
        mask = image_pair_mask(alive, r, cutoff).to(r.dtype)
        rsafe = torch.where(mask > 0, r, torch.full_like(r, cutoff))
        return 0.5 * (pair_energy(rsafe) * mask).sum(dim=(1, 3))

    return per_atom


def make_lennard_jones(epsilon: float, sigma: float, cutoff: float) -> Potential:
    """LJ 12-6: 4 eps [(sigma/r)^12 - (sigma/r)^6]."""

    def pair_energy(r):
        sr6 = (sigma / r) ** 6
        return 4.0 * epsilon * (sr6 * sr6 - sr6)

    per_atom = _pair_per_atom(pair_energy, cutoff)
    return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                     name="lj")


def make_morse(D: float, alpha: float, r0: float, cutoff: float) -> Potential:
    """Morse: D [exp(-2 a (r - r0)) - 2 exp(-a (r - r0))]."""

    def pair_energy(r):
        ex = torch.exp(-alpha * (r - r0))
        return D * (ex * ex - 2.0 * ex)

    per_atom = _pair_per_atom(pair_energy, cutoff)
    return Potential(energy=summed(per_atom), per_atom_energy=per_atom, cutoff=cutoff,
                     name="morse")
