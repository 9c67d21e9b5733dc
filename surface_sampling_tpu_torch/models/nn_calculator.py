"""Adapters: a PaiNN ensemble, a CHGNet model or a MACE model -> potential
energies and forces in eV.

The counterparts of ``make_painn_potential`` and ``make_chgnet_potential``
in ``surface_sampling_tpu/models/nn_calculator.py`` and of the force
methods of ``surface_sampling_tpu/potentials/base.py``. Built with a
static candidate table, a potential scores slot-realized geometries (edges
ranked over the table) and carries the relaxation hooks that fix the edge
topology once per relaxation. Built without one (``static_nbr=None``, the
JAX package's default, used before a spec exists), it finds its edges by
image search on every call (``ops.neighbors.neighbor_list`` over the
image shifts passed in), carries no topology hook, so that a relaxation
refreshes its edges at every force call, and keeps the arguments it was
built with as the JAX package's rebuild hook (``painn_args`` /
``chgnet_args``). A PaiNN potential given the spec of a code-independent
slot geometry with its table also carries the ``rigid_energy`` hook of
rigid MC (over the banded static edges of a supercell when a routing band
is given); a code-dependent one (mixed-offset adsorbate groups) scores
every state through ``energy()``, as in the JAX package. With a routing
band the general path (energy, forces, relaxation) runs the banded trunk
too. A CHGNet potential scores every state through its general path,
banded for rigid supercells. The per-atom analysis hooks belong to later
slices.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import HARTREE_TO_EV, KCAL_MOL_TO_EV, SYMBOL_FROM_Z
from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig, chgnet_apply
from surface_sampling_tpu_torch.models.ensemble import ensemble_apply, ensemble_apply_rigid
from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    rigid_member_weights,
    stack_members,
)
from surface_sampling_tpu_torch.ops.banding import stage_band
from surface_sampling_tpu_torch.ops.neighbors import (
    Edges,
    image_search_edges,
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
    """Energies of (C, N) batches of structures (``energy`` is the
    subclass's) whose edges are ranked over a static candidate table or,
    without one, found by image search: forces by one backward pass, and
    with a table the relaxation hooks that fix the edge topology once per
    relaxation (``edge_topology``, ``edges_of``, ``energy_with_edges``)."""

    def _init_edges(self, table, band=None) -> None:
        if table is None:
            self.edge_fn = None
            return
        self.edge_fn = make_table_edge_fn(table, band)
        # relax-loop hooks: select the topology once per relaxation,
        # recompute its geometry per force call
        self.edge_topology, self.edges_of = make_table_topology_fns(table, band)
        self.energy_with_edges = self.energy

    def edges(self, positions, alive, shifts=None) -> Edges:
        """The edges of ``positions``: ranked over the static table, or by
        image search over ``shifts``."""
        if self.edge_fn is not None:
            return self.edge_fn(positions, alive)
        return image_search_edges(positions, alive, shifts, self.cutoff, self.cfg.max_neighbors)

    def energy_and_forces(self, positions, type_idx, alive, shifts=None):
        """(C,) energies and (C, N, 3) forces -dE/dx, zero on dead slots,
        from one backward pass of the chain-summed energy (chains are
        independent, so each chain's gradient is its own)."""
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self.energy(pos, type_idx, alive, shifts)
            (g,) = torch.autograd.grad(e.sum(), pos)
        return e.detach(), -torch.where(alive[..., None], g, torch.zeros_like(g))

    def forces(self, positions, type_idx, alive, shifts=None):
        return self.energy_and_forces(positions, type_idx, alive, shifts)[1]


class PaiNNPotential(TablePotential):
    """PaiNN ensemble energy of (C, N) batches of structures.

    ``energy(positions, type_idx, alive, shifts)`` is the member-mean
    network energy times the units factor, plus the nff composition offset,
    (C,) in eV. ``rigid_energy(type_idx, alive)`` exists only for a
    potential built with the table and the spec of a code-independent slot
    geometry. ``band`` is the staged routing band (``ops.banding.DeviceBand``)
    of a supercell, or None."""

    name = "painn"

    def __init__(self, params, cfg, znums, factor, table, per_type, const_off,
                 rw=None, pack=None, band=None):
        self.params, self.cfg = params, cfg
        self.cutoff = cfg.cutoff
        self.znums, self.factor = znums, factor
        self.per_type, self.const_off = per_type, const_off
        self.band = band
        self._init_edges(table, band)
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
        """Ensemble outputs (training units). ``shifts`` are the image
        shifts of the image search; with a static table they are unused (the
        table holds them). ``collect_layers`` adds ``layer_s`` / ``layer_v``,
        the inputs of every message block (``models.ensemble.ensemble_apply``)."""
        if edges is None:
            edges = self.edges(positions, alive, shifts)
        return ensemble_apply(self.params, self.cfg, self._numbers(type_idx, alive), alive,
                              edges, band=self.band, collect_layers=collect_layers)

    def energy(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """(C,) potential energies in eV of positions (C, N, 3)."""
        e = self.outputs(positions, type_idx, alive, shifts, edges=edges)["energy"] * self.factor
        return e + self.comp_offset(type_idx, alive)

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
    ensemble: bool | None = None,
) -> PaiNNPotential:
    """Wrap a PaiNN model or a stacked ensemble (``models/weights.py``) as a
    potential.

    Args:
        params: parameter tree of tensors: one model, or a stacked
            ensemble with a leading member axis.
        type_numbers: atomic number per potential type index.
        units: training units of the checkpoint.
        stoidict: nff composition offsets in Hartree (per-element linear
            coefficients + an "offset" constant).
        static_nbr: the spec's ``StaticNeighborTable``; positions passed in
            must then be slot-realized geometries of that spec. None (the
            JAX package's default) finds the edges by image search on every
            call, over the shifts passed to ``energy``; the potential then
            carries ``painn_args``, the arguments to rebuild it with a table
            once a spec exists.
        spec: the ``SurfaceSpec``; when given with ``static_nbr`` and its
            slot geometry is code-independent, the potential also carries
            ``rigid_energy``. A code-dependent one scores every state
            through ``energy()``. Relaxing systems pass None.
        device: where the tables live (default: the parameters').
        routing_band: a host ``ops.banding.RoutingBand`` of the same
            static table (supercells): ``rigid_energy`` then runs the banded
            rigid trunk, and the general path (``energy``,
            ``energy_with_edges``, ``energy_and_forces``) the banded general
            trunk, whose backward is the banded message backward; the
            relaxation hooks carry its reverse table.
        ensemble: the JAX package's flag: True for a stacked tree, False for
            one model's tree (stacked here to K = 1); None (the default)
            reads it from the tree.
    """
    stacked_in = params["atom_embed"].dim() == 3
    if ensemble is None:
        ensemble = stacked_in
    if ensemble != stacked_in:
        raise ValueError(f"ensemble={ensemble} but the tree is "
                         f"{'stacked' if stacked_in else 'one model'}")
    if routing_band is not None and static_nbr is None:
        raise ValueError("a routing band needs the static table it was built from")
    stacked = params if ensemble else stack_members([params])
    device = device if device is not None else params["atom_embed"].device
    table = (None if static_nbr is None
             else stage_candidate_table(static_nbr, cfg.cutoff, cfg.max_neighbors, device))
    type_numbers_in = type_numbers
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
    if spec is not None and static_nbr is not None:
        # None for a code-dependent slot geometry: no rigid hook, energy()
        pack = build_static_edge_pack(spec, static_nbr, cfg, device, band=routing_band)
    if pack is not None:
        # phi of layer 1 depends only on Z: deduplicate the species so that
        # two type slots sharing an atomic number cannot double a table row
        l1_types = tuple(sorted({int(z) for z in type_numbers}))
        rw = rigid_member_weights(stacked, cfg, l1_types, pack.r_pad)
    pot = PaiNNPotential(stacked, cfg, znums, UNIT_FACTORS[units], table, per_type, const_off,
                         rw=rw, pack=pack, band=stage_band(routing_band, device))
    if static_nbr is None:
        # rebuild hook: re-invoke with the spec's static candidate table once
        # the spec exists (the JAX package's painn_args)
        pot.painn_args = dict(params=params, cfg=cfg, type_numbers=type_numbers_in, units=units,
                              ensemble=ensemble, stoidict=stoidict)
    return pot


class CHGNetPotential(TablePotential):
    """CHGNet energy of (C, N) batches of structures: ``energy(positions,
    type_idx, alive, shifts)`` (C,) in eV. ``band`` is the staged routing
    band of a rigid supercell (``ops.banding.DeviceBand``), whose banded
    conv is forward only, or None."""

    name = "chgnet"

    def __init__(self, params, cfg: CHGNetConfig, znums, factor, table, band=None):
        self.params, self.cfg = params, cfg
        self.cutoff = cfg.atom_graph_cutoff
        self.znums, self.factor, self.band = znums, factor, band
        self._init_edges(table)

    def outputs(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """Model outputs (``models.chgnet.chgnet_apply``). ``shifts`` are
        the image shifts of the image search; with a static table they are
        unused (the table holds them)."""
        if edges is None:
            edges = self.edges(positions, alive, shifts)
        numbers = self.znums[type_idx] * alive.to(torch.int64)
        return chgnet_apply(self.params, self.cfg, numbers, alive, edges, band=self.band)

    def energy(self, positions, type_idx, alive, shifts=None, edges: Edges | None = None):
        """(C,) potential energies in eV of positions (C, N, 3)."""
        return self.outputs(positions, type_idx, alive, shifts, edges=edges)["energy"] \
            * self.factor

    def per_atom(self, positions, type_idx, alive, shifts=None):
        """(C, N) per-atom energies in eV."""
        return self.outputs(positions, type_idx, alive, shifts)["per_atom_energy"] * self.factor


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
            must then be slot-realized geometries of that spec. None finds
            the edges by image search on every call (see
            :func:`make_painn_potential`); the potential then carries
            ``chgnet_args``, the rebuild hook.
        routing_band: a host ``ops.banding.RoutingBand`` of the same static
            table (rigid supercells): every atom conv then runs banded, and
            the potential is forward only (forces raise).
        device: where the tables live (default: the parameters').
    """
    device = device if device is not None else params["atom_embedding"].device
    table = (None if static_nbr is None else
             stage_candidate_table(static_nbr, cfg.atom_graph_cutoff, cfg.max_neighbors, device))
    znums = torch.as_tensor(np.asarray(type_numbers), dtype=torch.int64, device=device)
    pot = CHGNetPotential(params, cfg, znums, UNIT_FACTORS[units], table,
                          band=stage_band(routing_band, device))
    if static_nbr is None:
        # rebuild hook (the JAX package's chgnet_args)
        pot.chgnet_args = dict(params=params, cfg=cfg, type_numbers=type_numbers, units=units)
    return pot
