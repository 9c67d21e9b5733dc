"""Adapter: a PaiNN ensemble -> potential energies and forces in eV.

The counterpart of ``make_painn_potential`` in
``surface_sampling_tpu/models/nn_calculator.py`` and of the force methods
of ``surface_sampling_tpu/potentials/base.py``, for systems built with a
static candidate table: the energy of slot-realized geometries (edges
ranked over the table), forces by autograd, the relaxation hooks that fix
the edge topology once per relaxation, and, given the spec of a
code-independent slot geometry, the ``rigid_energy`` hook of rigid MC
(over the banded static edges of a supercell when a routing band is
given). With a routing band the general path (energy, forces, relaxation)
runs the banded trunk too, as in the JAX package. The per-atom analysis
hooks belong to later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import HARTREE_TO_EV, KCAL_MOL_TO_EV, SYMBOL_FROM_Z
from surface_sampling_tpu_torch.models.ensemble import ensemble_apply, ensemble_apply_rigid
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, rigid_member_weights
from surface_sampling_tpu_torch.ops.banding import stage_band
from surface_sampling_tpu_torch.ops.neighbors import (
    Edges,
    EdgeTopology,
    make_table_edge_fn,
    make_table_topology_fns,
    stage_candidate_table,
)
from surface_sampling_tpu_torch.ops.static_edges import (
    build_static_edge_pack,
    static_edge_geometry,
)

UNIT_FACTORS = {"kcal/mol": KCAL_MOL_TO_EV, "eV": 1.0, "ev": 1.0}


class PaiNNPotential:
    """PaiNN ensemble energy of (C, N) batches of slot-realized structures.

    ``energy(positions, type_idx, alive)`` is the member-mean network
    energy times the units factor, plus the nff composition offset, (C,)
    in eV. ``rigid_energy(type_idx, alive)`` exists only for a potential
    built with the spec of a code-independent slot geometry. ``band`` is
    the staged routing band (``ops.banding.DeviceBand``) of a supercell, or
    None."""

    name = "painn"

    def __init__(self, params, cfg, znums, factor, table, per_type, const_off,
                 rw=None, pack=None, band=None):
        self.params, self.cfg = params, cfg
        self.cutoff = cfg.cutoff
        self.znums, self.factor = znums, factor
        self.per_type, self.const_off = per_type, const_off
        self.band = band
        self.edge_fn = make_table_edge_fn(table, band)
        self._topo_fn, self._geom_fn = make_table_topology_fns(table, band)
        if pack is not None:
            self.rw, self.static_edge_pack = rw, pack
            self.rigid_energy = self._rigid_energy

    # -- energies --------------------------------------------------------
    def comp_offset(self, type_idx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """(C,) nff composition offset: per-type linear term + constant."""
        if self.per_type is None:
            return torch.zeros(type_idx.shape[0], device=type_idx.device)
        per_atom = self.per_type[type_idx] * alive.to(torch.float32)
        return per_atom.sum(dim=1) + self.const_off

    def _numbers(self, type_idx, alive):
        return self.znums[type_idx] * alive.to(torch.int64)

    def outputs(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """Ensemble outputs (training units). ``shifts`` is accepted for
        the JAX signature and unused: the candidate table holds the image
        shifts."""
        if edges is None:
            edges = self.edge_fn(positions, alive)
        return ensemble_apply(self.params, self.cfg, self._numbers(type_idx, alive), alive,
                              edges, band=self.band)

    def energy(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """(C,) potential energies in eV of positions (C, N, 3)."""
        e = self.outputs(positions, type_idx, alive, edges=edges)["energy"] * self.factor
        return e + self.comp_offset(type_idx, alive)

    energy_with_edges = energy

    def energy_and_forces(self, positions, type_idx, alive, shifts=None):
        """(C,) energies and (C, N, 3) forces -dE/dx, zero on dead slots,
        from one backward pass of the chain-summed energy (chains are
        independent, so each chain's gradient is its own)."""
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self.energy(pos, type_idx, alive)
            (g,) = torch.autograd.grad(e.sum(), pos)
        return e.detach(), -torch.where(alive[..., None], g, torch.zeros_like(g))

    def forces(self, positions, type_idx, alive, shifts=None):
        return self.energy_and_forces(positions, type_idx, alive)[1]

    # -- relaxation hooks ------------------------------------------------
    def edge_topology(self, positions, alive) -> EdgeTopology:
        """Select the edge topology once at the start of a relaxation."""
        return self._topo_fn(positions, alive)

    def edges_of(self, positions, topology: EdgeTopology) -> Edges:
        """Edge geometry at ``positions`` under a fixed topology."""
        return self._geom_fn(positions, topology)

    # -- rigid lattice ---------------------------------------------------
    def rigid_outputs(self, type_idx: torch.Tensor, alive: torch.Tensor) -> dict:
        msg_geom, edges = static_edge_geometry(self.static_edge_pack, alive)
        return ensemble_apply_rigid(self.params, self.rw, self.cfg,
                                    self._numbers(type_idx, alive), alive, msg_geom, edges,
                                    self.static_edge_pack.band)

    def _rigid_energy(self, type_idx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        e = self.rigid_outputs(type_idx, alive)["energy"] * self.factor
        return e + self.comp_offset(type_idx, alive)


def make_painn_potential(
    params: dict,
    cfg: PaiNNConfig,
    type_numbers,
    units: str = "kcal/mol",
    stoidict: dict | None = None,
    static_nbr=None,
    spec=None,
    device: torch.device | None = None,
    routing_band=None,
) -> PaiNNPotential:
    """Wrap a stacked PaiNN ensemble (``models/weights.py``; one member is
    K = 1) as a potential.

    Args:
        params: parameter tree of tensors with a leading member axis.
        type_numbers: atomic number per potential type index.
        units: training units of the checkpoint.
        stoidict: nff composition offsets in Hartree (per-element linear
            coefficients + an "offset" constant).
        static_nbr: the spec's ``StaticNeighborTable``; positions passed in
            must be slot-realized geometries of that spec.
        spec: the ``SurfaceSpec``; when given and its slot geometry is
            code-independent, the potential also carries ``rigid_energy``.
            Relaxing systems pass None.
        device: where the tables live (default: the parameters').
        routing_band: a host ``ops.banding.RoutingBand`` of the same
            static table (supercells): ``rigid_energy`` then runs the banded
            rigid trunk, and the general path (``energy``,
            ``energy_with_edges``, ``energy_and_forces``) the banded general
            trunk, whose backward is the banded message backward; the
            relaxation hooks carry its reverse table.
    """
    if static_nbr is None:
        raise NotImplementedError(
            "only the static-candidate-table edge path is ported: pass static_nbr")
    device = device if device is not None else params["atom_embed"].device
    table = stage_candidate_table(static_nbr, cfg.cutoff, cfg.max_neighbors, device)
    type_numbers = np.asarray(type_numbers)
    znums = torch.as_tensor(type_numbers, dtype=torch.int64, device=device)
    if stoidict is not None:
        per_type = torch.as_tensor(
            np.array([stoidict.get(SYMBOL_FROM_Z[int(z)], 0.0) for z in type_numbers])
            * HARTREE_TO_EV, dtype=torch.float32, device=device)
        const_off = float(stoidict.get("offset", 0.0)) * HARTREE_TO_EV
    else:
        per_type, const_off = None, 0.0
    rw = pack = None
    if spec is not None:
        pack = build_static_edge_pack(spec, static_nbr, cfg, device, band=routing_band)
        if pack is None:
            raise NotImplementedError(
                "code-dependent slot geometry (mixed-offset adsorbate groups) has no "
                "rigid static-edge path; pass spec=None to score it through energy()")
        # phi of layer 1 depends only on Z: deduplicate the species so that
        # two type slots sharing an atomic number cannot double a table row
        l1_types = tuple(sorted({int(z) for z in type_numbers}))
        rw = rigid_member_weights(params, cfg, l1_types, pack.r_pad)
    return PaiNNPotential(params, cfg, znums, UNIT_FACTORS[units], table, per_type,
                          const_off, rw=rw, pack=pack, band=stage_band(routing_band, device))
