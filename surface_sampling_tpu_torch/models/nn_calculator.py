"""Adapter: a PaiNN ensemble on a rigid lattice -> acceptance-ready
potential energies in eV.

The counterpart of ``make_painn_potential`` in
``surface_sampling_tpu/models/nn_calculator.py``, covering its
``rigid_energy`` hook: the MC path of a system built with a static
candidate table on code-independent geometry. The other hooks (forces,
relaxation topology, per-atom analysis) belong to later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import HARTREE_TO_EV, KCAL_MOL_TO_EV, SYMBOL_FROM_Z
from surface_sampling_tpu_torch.models.ensemble import ensemble_apply
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, rigid_member_weights
from surface_sampling_tpu_torch.ops.static_edges import (
    build_static_edge_pack,
    static_edge_geometry,
)

UNIT_FACTORS = {"kcal/mol": KCAL_MOL_TO_EV, "eV": 1.0, "ev": 1.0}


class RigidPaiNNPotential:
    """PaiNN ensemble energy of rigid slot geometries.

    ``rigid_energy(type_idx, alive)`` maps a (C, N) batch of slot typings
    to (C,) potential energies in eV: the member-mean network energy times
    the units factor, plus the nff composition offset."""

    name = "painn"

    def __init__(self, params, rw, cfg, znums, factor, pack, per_type, const_off):
        self.params, self.rw, self.cfg = params, rw, cfg
        self.cutoff = cfg.cutoff
        self.znums, self.factor = znums, factor
        self.static_edge_pack = pack
        self.per_type, self.const_off = per_type, const_off

    def rigid_outputs(self, type_idx: torch.Tensor, alive: torch.Tensor) -> dict:
        numbers = self.znums[type_idx] * alive.to(torch.int64)
        msg_geom, edges = static_edge_geometry(self.static_edge_pack, alive)
        return ensemble_apply(self.params, self.rw, self.cfg, numbers, alive, msg_geom, edges)

    def comp_offset(self, type_idx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """(C,) nff composition offset: per-type linear term + constant."""
        if self.per_type is None:
            return torch.zeros(type_idx.shape[0], device=type_idx.device)
        per_atom = self.per_type[type_idx] * alive.to(torch.float32)
        return per_atom.sum(dim=1) + self.const_off

    def rigid_energy(self, type_idx: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
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
) -> RigidPaiNNPotential:
    """Wrap a stacked PaiNN ensemble (``models/weights.py``; one member is
    K = 1) as a rigid-lattice potential.

    Args:
        params: parameter tree of tensors with a leading member axis.
        type_numbers: atomic number per potential type index.
        units: training units of the checkpoint.
        stoidict: nff composition offsets in Hartree (per-element linear
            coefficients + an "offset" constant).
        static_nbr: the spec's ``StaticNeighborTable``.
        spec: the ``SurfaceSpec``; its slot geometry must be
            code-independent.
        device: where the static tables live (default: the parameters').
    """
    if static_nbr is None or spec is None:
        raise NotImplementedError(
            "only the rigid static-edge path is ported: pass static_nbr and spec")
    device = device if device is not None else params["atom_embed"].device
    pack = build_static_edge_pack(spec, static_nbr, cfg, device)
    if pack is None:
        raise NotImplementedError(
            "code-dependent slot geometry (mixed-offset adsorbate groups) needs "
            "the dynamic edge path, which is not ported yet")
    type_numbers = np.asarray(type_numbers)
    znums = torch.as_tensor(type_numbers, dtype=torch.int64, device=device)
    if stoidict is not None:
        per_type = torch.as_tensor(
            np.array([stoidict.get(SYMBOL_FROM_Z[int(z)], 0.0) for z in type_numbers])
            * HARTREE_TO_EV, dtype=torch.float32, device=device)
        const_off = float(stoidict.get("offset", 0.0)) * HARTREE_TO_EV
    else:
        per_type, const_off = None, 0.0
    # phi of layer 1 depends only on Z: deduplicate the species so that two
    # type slots sharing an atomic number cannot double a table row
    l1_types = tuple(sorted({int(z) for z in type_numbers}))
    rw = rigid_member_weights(params, cfg, l1_types, pack.r_pad)
    return RigidPaiNNPotential(params, rw, cfg, znums, UNIT_FACTORS[units], pack,
                               per_type, const_off)
