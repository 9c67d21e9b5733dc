"""Adapters: a PaiNN ensemble or a CHGNet model -> potential energies and
forces in eV.

The counterparts of ``make_painn_potential`` and ``make_chgnet_potential``
in ``surface_sampling_tpu/models/nn_calculator.py`` and of the force
methods of ``surface_sampling_tpu/potentials/base.py``, for systems built
with a static candidate table: the energy of slot-realized geometries
(edges ranked over the table), forces by autograd, and the relaxation
hooks that fix the edge topology once per relaxation. A PaiNN potential
given the spec of a code-independent slot geometry also carries the
``rigid_energy`` hook of rigid MC (over the banded static edges of a
supercell when a routing band is given), and with a routing band its
general path (energy, forces, relaxation) runs the banded trunk too, as in
the JAX package. A CHGNet potential scores every state through its general
path (its adsorbate groups make the slot geometry code-dependent), banded
for rigid supercells. The per-atom analysis hooks belong to later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import HARTREE_TO_EV, KCAL_MOL_TO_EV, SYMBOL_FROM_Z
from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig, chgnet_apply
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


class TablePotential:
    """Energies of (C, N) batches of slot-realized structures whose edges
    are ranked over a static candidate table (``energy`` is the
    subclass's): forces by one backward pass, and the relaxation hooks
    that fix the edge topology once per relaxation."""

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

    def edge_topology(self, positions, alive) -> EdgeTopology:
        """Select the edge topology once at the start of a relaxation."""
        return self._topo_fn(positions, alive)

    def edges_of(self, positions, topology: EdgeTopology) -> Edges:
        """Edge geometry at ``positions`` under a fixed topology."""
        return self._geom_fn(positions, topology)


class PaiNNPotential(TablePotential):
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

    def outputs(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None,
                collect_layers: bool = False):
        """Ensemble outputs (training units). ``shifts`` is accepted for
        the JAX signature and unused: the candidate table holds the image
        shifts. ``collect_layers`` adds ``layer_s`` / ``layer_v``, the inputs
        of every message block (``models.ensemble.ensemble_apply``)."""
        if edges is None:
            edges = self.edge_fn(positions, alive)
        return ensemble_apply(self.params, self.cfg, self._numbers(type_idx, alive), alive,
                              edges, band=self.band, collect_layers=collect_layers)

    def energy(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """(C,) potential energies in eV of positions (C, N, 3)."""
        e = self.outputs(positions, type_idx, alive, edges=edges)["energy"] * self.factor
        return e + self.comp_offset(type_idx, alive)

    energy_with_edges = energy

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


class CHGNetPotential(TablePotential):
    """CHGNet energy of (C, N) batches of slot-realized structures:
    ``energy(positions, type_idx, alive)`` (C,) in eV. ``band`` is the
    staged routing band of a rigid supercell (``ops.banding.DeviceBand``),
    whose banded conv is forward only, or None."""

    name = "chgnet"

    def __init__(self, params, cfg: CHGNetConfig, znums, factor, table, band=None):
        self.params, self.cfg = params, cfg
        self.cutoff = cfg.atom_graph_cutoff
        self.znums, self.factor, self.band = znums, factor, band
        self.edge_fn = make_table_edge_fn(table)
        self._topo_fn, self._geom_fn = make_table_topology_fns(table)

    def outputs(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """Model outputs (``models.chgnet.chgnet_apply``). ``shifts`` is
        accepted for the JAX signature and unused: the candidate table holds
        the image shifts."""
        if edges is None:
            edges = self.edge_fn(positions, alive)
        numbers = self.znums[type_idx] * alive.to(torch.int64)
        return chgnet_apply(self.params, self.cfg, numbers, alive, edges, band=self.band)

    def energy(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """(C,) potential energies in eV of positions (C, N, 3)."""
        return self.outputs(positions, type_idx, alive, edges=edges)["energy"] * self.factor

    energy_with_edges = energy

    def per_atom(self, positions, type_idx, alive, shifts=None):
        """(C, N) per-atom energies in eV."""
        return self.outputs(positions, type_idx, alive)["per_atom_energy"] * self.factor


def make_chgnet_potential(
    params: dict,
    cfg: CHGNetConfig,
    type_numbers,
    units: str = "eV",
    static_nbr=None,
    routing_band=None,
    device: torch.device | None = None,
) -> CHGNetPotential:
    """Wrap a CHGNet model (``models/weights.py``: a tree of tensors, no
    member axis) as a potential.

    Args:
        params: parameter tree of tensors.
        type_numbers: atomic number per potential type index.
        units: units of the checkpoint's energies (CHGNet predicts eV).
        static_nbr: the spec's ``StaticNeighborTable``; positions passed in
            must be slot-realized geometries of that spec.
        routing_band: a host ``ops.banding.RoutingBand`` of the same static
            table (rigid supercells): every atom conv then runs banded, and
            the potential is forward only (forces raise).
        device: where the tables live (default: the parameters').
    """
    if static_nbr is None:
        raise NotImplementedError(
            "only the static-candidate-table edge path is ported: pass static_nbr")
    device = device if device is not None else params["atom_embedding"].device
    table = stage_candidate_table(static_nbr, cfg.atom_graph_cutoff, cfg.max_neighbors, device)
    znums = torch.as_tensor(np.asarray(type_numbers), dtype=torch.int64, device=device)
    return CHGNetPotential(params, cfg, znums, UNIT_FACTORS[units], table,
                           band=stage_band(routing_band, device))
