"""Potential API of the classical potentials, batched over chains.

The counterpart of ``surface_sampling_tpu/potentials/base.py``. A potential
is a pair of functions over fixed-shape masked atom arrays with a leading
chain axis:

    positions: (C, N, 3) float32 cartesian, padded to a static N.
    type_idx:  (C, N) int64 index into the potential's type table.
    alive:     (C, N) bool; padding and vacant slots are False and add 0.
    shifts:    (K, 3) float32 cartesian periodic image shifts (zero shift
               first), ``DeviceSpec.shifts``. Periodicity enters only here;
               potentials over a static candidate table carry their shifts
               in the table and ignore the argument.

Energies are eV, distances Angstrom, forces eV/Angstrom. Forces come from
one backward pass of the chain-summed energy (chains are independent).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Potential:
    """A bundle of batched energy functions.

    Attributes:
        energy: (positions, type_idx, alive, shifts) -> (C,) eV.
        per_atom_energy: same signature -> (C, N) eV (zero on dead slots).
        cutoff: interaction cutoff in Angstrom.
        name: for logs.
    """

    energy: Callable
    per_atom_energy: Callable
    cutoff: float
    name: str = "potential"

    def energy_and_forces(self, positions, type_idx, alive, shifts=None):
        """(C,) energies and (C, N, 3) forces -dE/dx, zero on dead slots."""
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self.energy(pos, type_idx, alive, shifts)
            (g,) = torch.autograd.grad(e.sum(), pos, allow_unused=True)
        if g is None:                     # an energy that ignores positions
            g = torch.zeros_like(pos)
        return e.detach(), -torch.where(alive[..., None], g, torch.zeros_like(g))

    def forces(self, positions, type_idx, alive, shifts=None):
        """Forces = -dE/dpositions (masked slots get 0)."""
        return self.energy_and_forces(positions, type_idx, alive, shifts)[1]


def summed(per_atom: Callable) -> Callable:
    """The (C,) energy of a (C, N) per-atom energy function."""

    def energy(positions, type_idx, alive, shifts=None):
        return per_atom(positions, type_idx, alive, shifts).sum(dim=1)

    return energy


@dataclass(frozen=True)
class TopologyPotential(Potential):
    """A potential whose edges rank a static candidate table, with the relax
    loop's hooks (``core.energy.relax_and_score`` with
    ``refresh_edges="once"``): ``edge_topology(positions, alive)`` selects
    the edges once, ``edges_of(positions, topology)`` recomputes their
    geometry, ``energy_with_edges(positions, type_idx, alive, edges=...)``
    scores them."""

    edge_topology: Callable | None = None
    edges_of: Callable | None = None
    energy_with_edges: Callable | None = None
