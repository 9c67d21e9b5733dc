"""Prebuilt example systems: the SrTiO3(001) PaiNN-ensemble flagship and
its supercells, the LaMnO3(001) CHGNet system, the EAM systems Cu(100)
(semigrand) and Au(110) (canonical), and the many-body systems GaN(0001)
(Tersoff, canonical) and Si(111) 5x5 (Stillinger-Weber).

The counterparts of ``srtio3_001_painn``, ``lamno3_001_chgnet``,
``cu100_eam``, ``au110_eam``, ``gan0001_tersoff`` and ``si111_sw`` in
``surface_sampling_tpu/systems.py``. The slab geometries, the offset
table, the model weights and the EAM and Tersoff tables are the JAX
package's data files, read by path from the repository checkout (data, not
modules: nothing of the JAX package is imported).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.constants import Z_FROM_SYMBOL
from surface_sampling_tpu_torch.core.energy import (
    RelaxConfig,
    make_chem_pot_surface_energy,
    make_offset_surface_energy,
)
from surface_sampling_tpu_torch.core.engine import MCMCRun
from surface_sampling_tpu_torch.core.spec import SurfaceSpec, make_spec
from surface_sampling_tpu_torch.core.static_neighbors import (
    StaticNeighborTable,
    build_static_neighbor_table,
)
from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.models.nn_calculator import (
    TablePotential,
    make_chgnet_potential,
    make_painn_potential,
)
from surface_sampling_tpu_torch.models.weights import (
    from_jax_params,
    load_chgnet_npz,
    load_painn_ensemble,
)
from surface_sampling_tpu_torch.ops.banding import RoutingBand, build_routing_band_for_spec
from surface_sampling_tpu_torch.potentials.base import Potential
from surface_sampling_tpu_torch.potentials.eam import (
    builtin_eam,
    make_eam,
    make_eam_rigid,
    make_eam_static,
)
from surface_sampling_tpu_torch.potentials.rigid_manybody import make_sw_rigid, make_tersoff_rigid
from surface_sampling_tpu_torch.potentials.sw import SWTables, load_sw_any, make_sw, sw_tables
from surface_sampling_tpu_torch.potentials.tersoff import builtin_tersoff, make_tersoff
from surface_sampling_tpu_torch.structure import (
    Structure,
    bulk,
    diamond111,
    fcc100,
    find_adsorption_sites,
    surface_from_bulk,
)

_REFERENCE_PKG = Path(__file__).resolve().parent.parent / "surface_sampling_tpu"
SYSTEMS_DATA = _REFERENCE_PKG / "systems_data"
MODEL_DATA = _REFERENCE_PKG / "models" / "data"


class ExampleSystem(NamedTuple):
    """A system ready to sample: its spec, potential and MC run, the
    static candidate table the potential works over (None for the EAM
    potentials that need none), and the host routing band of a supercell
    (None where the cell has none), which
    ``core.incremental.make_incremental_painn_from_system`` needs besides
    for a rigid PaiNN one."""

    spec: SurfaceSpec
    potential: TablePotential | Potential
    run: MCMCRun
    static_nbr: StaticNeighborTable | None = None
    routing_band: RoutingBand | None = None


def srtio3_001_painn(
    planar_distance: float = 1.5,
    surface_depth: int = 1,
    relax: RelaxConfig | None = None,
    chem_pots: dict | None = None,
    adsorbates: tuple[str, ...] = ("Sr", "Ti", "O"),
    n_models: int = 3,
    max_neighbors: int = 64,
    supercell: tuple[int, int] = (1, 1),
    pallas_routing: str | None = None,
    dtype=None,
    device: str | torch.device = "cuda",
) -> ExampleSystem:
    """SrTiO3(001) 2x2 slab with the reference's trained PaiNN ensemble:
    semigrand sampling with chem_pots Sr=-2 Ti=0 O=0 and the offset
    surface energy in atomic units, on a rigid lattice, or with every
    trial state FIRE-relaxed when ``relax`` is given (the static candidate
    table then allows 0.6 A of relaxation slack and the potential carries
    no rigid hook, as in the JAX package).

    ``supercell=(a, b)`` tiles the slab a x b times laterally and sorts it
    by z, as the JAX package does, and builds a routing band over the
    static table where its windows are narrow enough. Rigid, that is from
    2x2 up (496 slots and more): the rigid hook runs the banded trunk and
    the system carries the band for the delta engine
    (``core/incremental.py``). Relaxed, the wider relax table gives a band
    from 3x3 up (1116 slots): energies and forces run the banded general
    trunk and its backward; the relaxed 2x2 cell has none and runs
    unbanded, by the JAX package's own rule.

    Arguments and defaults are those of the JAX package's function.
    ``pallas_routing`` selects a TPU routing precision and is ignored: the port computes in
    float32. ``dtype`` must be None or
    ``torch.float32``. ``device`` defaults to "cuda" and raises without a
    card; pass "cpu" for the plain PyTorch path.
    """
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    dev = resolve_device(device)

    data = np.load(SYSTEMS_DATA / "SrTiO3_001_2x2.npz")
    slab = Structure(data["numbers"], data["positions"], data["cell"])
    if tuple(supercell) != (1, 1):
        slab = slab.repeat((supercell[0], supercell[1], 1)).sorted_by_z()
    sites = find_adsorption_sites(
        slab, planar_distance=planar_distance, near_reduce=0.01, no_obtuse_hollow=True
    )["all"]
    offset_data = json.loads((SYSTEMS_DATA / "srtio3_offset_data.json").read_text())
    chem_pots = chem_pots or {"Sr": -2.0, "Ti": 0.0, "O": 0.0}

    params, cfg = load_painn_ensemble(
        [MODEL_DATA / f"srtio3_painn_{i:02d}.npz" for i in range(1, n_models + 1)], dev)
    cfg = dataclasses.replace(cfg, max_neighbors=max_neighbors)

    type_numbers = [Z_FROM_SYMBOL[s] for s in ("Sr", "Ti", "O")]
    spec = make_spec(
        slab,
        sites,
        list(adsorbates),
        potential_numbers=type_numbers,
        cutoff=cfg.cutoff,
        surface_depth=surface_depth,
        surface_name="SrTiO3_001",
    )
    slack = 0.6 if relax is not None else 0.1
    static_nbr = build_static_neighbor_table(spec, cfg.cutoff, relax_slack=slack)
    # the 1x1 cell is laterally fully connected at this cutoff (no band); so
    # is the relaxed 2x2 at the relax table's slack
    band = build_routing_band_for_spec(spec, static_nbr)
    pot = make_painn_potential(
        params, cfg, type_numbers, units="kcal/mol", stoidict=offset_data["stoidict"],
        static_nbr=static_nbr, spec=None if relax is not None else spec, device=dev,
        routing_band=band,
    )
    se_fn = make_offset_surface_energy(spec, chem_pots, offset_data,
                                       offset_units="atomic", device=dev)
    run = MCMCRun(spec, pot, surface_energy_fn=se_fn, device=dev, relax=relax)
    return ExampleSystem(spec, pot, run, static_nbr, band)


def lamno3_001_chgnet(
    planar_distance: float = 1.6,
    surface_depth: int = 1,
    adsorbates: tuple[str, ...] = ("O", "HO", "H2O"),
    chem_pots: dict | None = None,
    relax: RelaxConfig | None = None,
    max_neighbors: int = 96,
    supercell: tuple[int, int] = (1, 1),
    pallas_routing: str | None = None,
    dtype=None,
    device: str | torch.device = "cuda",
) -> ExampleSystem:
    """LaMnO3(001) 2x2x3 slab with the reference's fine-tuned CHGNet: O, OH
    and H2O adsorption on the MnO2 termination, scored by the plain
    chemical-potential surface energy (default O -5 eV, H -3 eV), on a
    rigid lattice, or with every trial state FIRE-relaxed when ``relax`` is
    given (the static candidate table then allows 0.6 A of relaxation
    slack). The rigid OH and H2O groups make the slot geometry depend on
    the occupancy, so every state is scored through ``potential.energy``
    with edges ranked over the table, as in the JAX package.

    ``supercell=(a, b)`` tiles the slab a x b times laterally and sorts it
    by z, as the JAX package does. A rigid supercell whose windows are
    narrow enough (3x3 and up) gets a routing band, and every atom conv
    then runs banded; relaxed runs never band (the banded conv is forward
    only), by the JAX package's own rule.

    Arguments and defaults are those of the JAX package's function.
    ``pallas_routing`` selects a TPU routing precision and is ignored: the
    port computes in float32. ``dtype`` must be None or ``torch.float32``.
    ``device`` defaults to "cuda" and raises without a card; pass "cpu" for
    the plain PyTorch path.
    """
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    dev = resolve_device(device)

    data = np.load(SYSTEMS_DATA / "LaMnO3_001_2x2x3.npz")
    slab = Structure(data["numbers"], data["positions"], data["cell"])
    if tuple(supercell) != (1, 1):
        slab = slab.repeat((supercell[0], supercell[1], 1)).sorted_by_z()
    sites = find_adsorption_sites(
        slab, planar_distance=planar_distance, near_reduce=0.01, no_obtuse_hollow=True
    )["all"]
    tree, cfg = load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    cfg = dataclasses.replace(cfg, max_neighbors=max_neighbors)

    type_numbers = [Z_FROM_SYMBOL[s] for s in ("La", "Mn", "O", "H")]
    spec = make_spec(
        slab,
        sites,
        list(adsorbates),
        potential_numbers=type_numbers,
        cutoff=cfg.atom_graph_cutoff,
        surface_depth=surface_depth,
        surface_name="LaMnO3_001",
    )
    static_nbr = build_static_neighbor_table(
        spec, cfg.atom_graph_cutoff, relax_slack=0.6 if relax is not None else 0.1)
    band = build_routing_band_for_spec(spec, static_nbr) if relax is None else None
    pot = make_chgnet_potential(from_jax_params(tree, dev), cfg, type_numbers, units="eV",
                                static_nbr=static_nbr, routing_band=band, device=dev)
    se_fn = make_chem_pot_surface_energy(spec, chem_pots or {"O": -5.0, "H": -3.0}, device=dev)
    run = MCMCRun(spec, pot, surface_energy_fn=se_fn, device=dev, relax=relax)
    return ExampleSystem(spec, pot, run, static_nbr, band)


def cu100_eam(
    size=(2, 2, 2),
    a: float = 3.6147,
    vacuum: float = 15.0,
    planar_distance: float = 1.5,
    relax: RelaxConfig | None = None,
    fast: bool = False,
    dtype=None,
    device: str | torch.device = "cuda",
) -> ExampleSystem:
    """Cu(100) slab with EAM (Foiles u3) and Cu adsorption: the toy system
    of the reference's example notebook and Cu regression test (a = 3.6147,
    2x2x2 slab, planar_distance 1.5), semigrand.

    ``fast=False`` scores states with the exact splines over every image
    pair (``make_eam``); ``fast=True`` with the Chebyshev path over a static
    candidate table (``make_eam_static(mode="cheb")``; 0.05 A of slack, 0.6
    when relaxing). The fused kernel is the separate energy-only
    ``ops.eam_kernels.make_eam_kernel_potential``, as in the JAX package.

    Arguments and defaults are those of the JAX package's function.
    ``dtype`` must be None or ``torch.float32``. ``device`` defaults to
    "cuda" and raises without a card; pass "cpu" for the plain path.
    """
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    dev = resolve_device(device)
    slab = fcc100("Cu", size=size, a=a, vacuum=vacuum)
    sites = find_adsorption_sites(
        slab, planar_distance=planar_distance, near_reduce=0.01, no_obtuse_hollow=True
    )["all"]
    tables = builtin_eam("Cu_u3")
    spec = make_spec(slab, sites, ["Cu"], potential_numbers=tables.numbers,
                     cutoff=tables.cutoff, surface_name="Cu_100")
    nbr = None
    if fast:
        slack = 0.6 if relax is not None else 0.05
        nbr = build_static_neighbor_table(spec, tables.cutoff, relax_slack=slack)
        pot = make_eam_static(tables, nbr, mode="cheb", device=dev)
    else:
        pot = make_eam(tables, device=dev)
    return ExampleSystem(spec, pot, MCMCRun(spec, pot, device=dev, relax=relax), nbr)


def au110_eam(relax: RelaxConfig | None = None, fast: bool = False, dtype=None,
              device: str | torch.device = "cuda") -> ExampleSystem:
    """Au(110) 2x2 canonical test system with the reference's exact
    geometry (16-atom slab, 8 pre-identified sites; its canonical anchor
    puts 6 Au atoms on them, ground state -79.0349 eV).

    ``fast=True`` (rigid runs only): the exact-spline EAM collapses to
    precomputed quadratic forms (``make_eam_rigid``), two small products
    per evaluation; otherwise (and whenever ``relax`` is given) the exact
    splines over every image pair (``make_eam``).

    ``dtype`` must be None or ``torch.float32``. ``device`` defaults to
    "cuda" and raises without a card; pass "cpu" for the plain path.
    """
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    dev = resolve_device(device)
    data = np.load(SYSTEMS_DATA / "Au_110_2x2.npz")
    slab = Structure(data["numbers"], data["slab_positions"], data["cell"])
    tables = builtin_eam("Au_u3")
    spec = make_spec(slab, data["ads_coords"], ["Au"], potential_numbers=tables.numbers,
                     cutoff=tables.cutoff, surface_name="Au_110")
    if fast and relax is None:
        pot = make_eam_rigid(tables, spec, device=dev)
    else:
        pot = make_eam(tables, device=dev)
    return ExampleSystem(spec, pot, MCMCRun(spec, pot, device=dev, relax=relax))


def gan0001_tersoff(
    size=(3, 3),
    layers: int = 4,
    vacuum: float = 12.0,
    planar_distance: float = 1.2,
    surface_depth: int = 2,
    relax: RelaxConfig | None = None,
    max_neighbors: int = 16,
    fast: bool = False,
    dtype=None,
    device: str | torch.device = "cuda",
) -> ExampleSystem:
    """GaN(0001) wurtzite slab with the Nord-2003 Tersoff potential: the
    reference's GaN tutorial system (canonical Ga / N sampling, bulk atoms
    frozen). The default 3x3, 4-layer slab is the tutorial's (pristine
    energy -144.059 eV).

    ``fast=True`` (rigid runs only): the precomputed occupancy-algebra
    Tersoff (``potentials.rigid_manybody.make_tersoff_rigid``); otherwise
    the dynamic Tersoff over a static candidate table (0.1 A of slack, 0.6
    when relaxing).

    Arguments and defaults are those of the JAX package's function.
    ``dtype`` must be None or ``torch.float32``. ``device`` defaults to
    "cuda" and raises without a card; pass "cpu" for the plain path.
    """
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    dev = resolve_device(device)
    gan = bulk(["Ga", "N"], "wurtzite", a=3.19, c=5.19)
    slab, _ = surface_from_bulk(gan, (0, 0, 1), size=size, layers=layers, vacuum=vacuum)
    sites = find_adsorption_sites(slab, planar_distance=planar_distance)["all"]
    tables = builtin_tersoff("GaN_nord2003")
    spec = make_spec(slab, sites, ["Ga", "N"],
                     potential_numbers=[Z_FROM_SYMBOL[e] for e in tables.elements],
                     cutoff=tables.cutoff, surface_depth=surface_depth, surface_name="GaN_0001")
    nbr = None
    if fast and relax is None:
        pot = make_tersoff_rigid(tables, spec, device=dev)
    else:
        nbr = build_static_neighbor_table(spec, tables.cutoff,
                                          relax_slack=0.6 if relax is not None else 0.1)
        pot = make_tersoff(tables, max_neighbors=max_neighbors, static_nbr=nbr, device=dev)
    return ExampleSystem(spec, pot, MCMCRun(spec, pot, device=dev, relax=relax), nbr)


# Bulk lattice constant implied by the reference's Si(111) 5x5 pristine
# slab (surface cell |a1| = 19.2463943 A for 5x1x1, so a = sqrt(2) |a1| / 5):
# the tutorial slab was built at this constant, not at the experimental
# 5.431 A.
SI111_TUTORIAL_A = 19.2463943 / 5.0 * float(np.sqrt(2.0))


def si111_sw(
    size=(5, 5),
    bilayers: int = 2,
    a: float = SI111_TUTORIAL_A,
    vacuum: float = 12.0,
    planar_distance: float = 1.2,
    surface_depth: int = 1,
    relax: RelaxConfig | None = None,
    relax_model: object = None,
    max_neighbors: int = 16,
    fast: bool = False,
    dtype=None,
    device: str | torch.device = "cuda",
) -> ExampleSystem:
    """Si(111) 5x5 slab with Stillinger-Weber: the reference's Si(111) 5x5
    tutorial system, 100 atoms (5x5 x 2 bilayers in the primitive hexagonal
    cell) with the bottom 75 frozen. Acceptance energies are SW85
    (Stillinger & Weber 1985; pristine -379.42511 eV).

    ``relax_model=`` (an ``SWTables``, or a path to a LAMMPS ``.sw`` or a KIM
    ThreeBodyCluster parameter file, read by ``potentials.sw.load_sw_any``)
    relaxes under that model while acceptance stays on SW85 energies of the
    relaxed geometry, the tutorial's dual-potential split. ``fast=True``
    (rigid runs only): the precomputed occupancy-algebra SW
    (``potentials.rigid_manybody.make_sw_rigid``).

    Arguments and defaults are those of the JAX package's function.
    ``dtype`` must be None or ``torch.float32``. ``device`` defaults to
    "cuda" and raises without a card; pass "cpu" for the plain path.
    """
    if dtype not in (None, torch.float32):
        raise NotImplementedError("the port computes in float32 only")
    dev = resolve_device(device)
    slab = diamond111("Si", size=size, bilayers=bilayers, a=a, vacuum=vacuum)
    sites = find_adsorption_sites(slab, planar_distance=planar_distance)["all"]
    tables = sw_tables()
    spec = make_spec(slab, sites, ["Si"],
                     potential_numbers=[Z_FROM_SYMBOL[e] for e in tables.elements],
                     cutoff=tables.cutoff, surface_depth=surface_depth, surface_name="Si_111")
    nbr = None
    if fast and relax is None:
        pot = make_sw_rigid(tables, spec, device=dev)
    else:
        nbr = build_static_neighbor_table(spec, tables.cutoff,
                                          relax_slack=0.6 if relax is not None else 0.1)
        pot = make_sw(tables, max_neighbors=max_neighbors, static_nbr=nbr, device=dev)
    relax_pot = None
    if relax_model is not None:
        rt = relax_model if isinstance(relax_model, SWTables) else load_sw_any(relax_model)
        rnbr = build_static_neighbor_table(spec, rt.cutoff, relax_slack=0.6)
        relax_pot = make_sw(rt, max_neighbors=max_neighbors, static_nbr=rnbr, device=dev)
    run = MCMCRun(spec, pot, device=dev, relax=relax, relax_potential=relax_pot)
    return ExampleSystem(spec, pot, run, nbr)
