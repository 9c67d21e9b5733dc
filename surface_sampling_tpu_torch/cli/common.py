"""Shared CLI runtime: settings, system assembly, the batched run driver.

The counterpart of ``surface_sampling_tpu/cli/common.py``. The settings
file is the three-section JSON (system_settings / sampling_settings /
calc_settings) with the JAX package's keys: ``sampling_settings.n_chains``
batches independent chains on the device, ``checkpoint_interval`` cuts the
sweeps into chunks with a checkpoint after each, and every sampling driver
takes ``--resume`` for an exact (bitwise) continuation.

One ``torch.Generator`` on the run's device, seeded from ``--seed``, draws
every random number of a run: the canonical prefill, the MC steps, the
tempering swaps and the population-annealing resampling. It passes from
chunk to chunk and its state is part of every checkpoint, so a resumed run
takes the draws the uninterrupted run takes. The run's device is the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from surface_sampling_tpu_torch.cli.default_settings import DEFAULT_SAMPLING_SETTINGS
from surface_sampling_tpu_torch.constants import SYMBOL_FROM_Z, Z_FROM_SYMBOL
from surface_sampling_tpu_torch.core.energy import RelaxConfig, make_offset_surface_energy
from surface_sampling_tpu_torch.core.engine import (
    EngineConfig,
    MCMCRun,
    SweepRecord,
    even_site_prefill,
    make_generator,
    make_run_fn,
    prepare_canonical_fn,
)
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import MCState, realize_numbers, realize_positions
from surface_sampling_tpu_torch.device import resolve_device
from surface_sampling_tpu_torch.io import load_checkpoint, save_checkpoint
from surface_sampling_tpu_torch.parallel.chains import chain_states, make_chain_run
from surface_sampling_tpu_torch.structure import Structure, find_adsorption_sites
from surface_sampling_tpu_torch.structure.io import write_cif
from surface_sampling_tpu_torch.utils import create_anneal_schedule, setup_folders, setup_logger
from surface_sampling_tpu_torch.utils.misc import load_structures_any
from surface_sampling_tpu_torch.utils.tracing import PhaseTimer

_PATH_KEYS = ("potential_file", "model_path", "offset_data",
              "phase_diagram", "pourbaix_diagram")
STATS_HEADER = "sweep,temp,energy_mean,energy_min,accept_rate,n_ads_mean,oob_rate"
TEMPER_HEADER = "round,swap_rate,energy_min,energy_cold"
PA_HEADER = "sweep,temp,energy_mean,energy_min,ess_frac,dlogz,resampled"


def add_device_arg(ap) -> None:
    """``--device cuda|cpu`` of every driver (the card by default)."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default; raises without one) or, with 'cpu', on "
                         "the plain PyTorch path")


def load_settings(path: str | Path) -> dict:
    """The settings file merged over the default sampling settings, with
    relative file references resolved against the file's own directory."""
    try:
        settings = json.loads(Path(path).read_text())
    except json.JSONDecodeError as e:
        raise SystemExit(f"error: settings file {path} is not valid JSON: {e}") from e
    if not isinstance(settings, dict):
        raise SystemExit(
            f"error: settings file {path} must contain a JSON object with "
            "system_settings / sampling_settings / calc_settings sections"
        )
    settings["sampling_settings"] = {**DEFAULT_SAMPLING_SETTINGS,
                                     **settings.get("sampling_settings", {})}
    settings.setdefault("system_settings", {})
    settings.setdefault("calc_settings", {})
    _resolve_paths(settings["calc_settings"], Path(path).resolve().parent)
    return settings


def _resolve_paths(calc: dict, base: Path) -> None:
    """Make calc_settings' relative file references that exist under
    ``base`` absolute, in place."""

    def resolve(v):
        p = Path(v)
        if not p.is_absolute() and (base / p).exists():
            return str(base / p)
        return v

    for key in _PATH_KEYS:
        if isinstance(calc.get(key), str):
            calc[key] = resolve(calc[key])
    for key in ("files", "model_paths"):
        if isinstance(calc.get(key), list):
            calc[key] = [resolve(f) if isinstance(f, str) else f for f in calc[key]]


def load_calc_settings(path: str | Path) -> dict:
    """The calc_settings section of a settings file, or the whole file when
    it holds no such section (the structure tools' bare form, as in the JAX
    package), its relative file references resolved as by
    :func:`load_settings`."""
    raw = json.loads(Path(path).read_text())
    calc = raw.get("calc_settings", raw)
    _resolve_paths(calc, Path(path).resolve().parent)
    return calc


def load_slab(path: str | Path) -> Structure:
    sts = load_structures_any(path)
    if len(sts) != 1:
        raise ValueError(f"expected exactly one structure in {path}, got {len(sts)}")
    return sts[0]


def relax_config(calc_settings: dict) -> RelaxConfig | None:
    """The per-move FIRE relaxation of ``relax_atoms`` (``relax_steps``,
    ``fmax``), or None."""
    if not calc_settings.get("relax_atoms", False):
        return None
    return RelaxConfig(steps=calc_settings.get("relax_steps", 20),
                       fmax=calc_settings.get("fmax", 0.01))


def build_potential(calc_settings: dict, system_settings: dict,
                    device: str | torch.device = "cuda"):
    """A potential, its type -> Z table and its cutoff from calc_settings.

    calc_name: eam | lj | morse | tersoff | sw | nff (PaiNN) | chgnet | mace
    (aka NffScaleMACE). EAM keeps its tables and Tersoff / SW theirs as
    hooks, so that :func:`assemble_system` can switch to their fast paths
    once the spec exists; the NN potentials are built without a table and
    carry their rebuild arguments (``painn_args`` ...). Hooks are attributes
    in the potential's ``__dict__``, as in the JAX package."""
    dev = resolve_device(device)
    name = calc_settings.get("calc_name", "eam").lower()
    if name == "eam":
        from surface_sampling_tpu_torch.potentials.eam import (
            load_tables_npz,
            make_eam,
            parse_funcfl,
            tables_from_funcfl,
        )

        files = calc_settings.get("files") or [calc_settings["potential_file"]]
        if str(files[0]).endswith(".npz"):
            tables = load_tables_npz(files[0])
        else:
            tables = tables_from_funcfl([parse_funcfl(f) for f in files])
        pot = make_eam(tables, device=dev)
        vars(pot)["tables"] = tables
        return pot, tables.numbers, tables.cutoff
    if name == "tersoff":
        from surface_sampling_tpu_torch.potentials.tersoff import (
            load_tersoff,
            load_tersoff_npz,
            make_tersoff,
        )

        f = calc_settings["potential_file"]
        tables = load_tersoff_npz(f) if str(f).endswith(".npz") else load_tersoff(f)
        pot = make_tersoff(tables, device=dev)
        vars(pot)["manybody_tables"] = ("tersoff", tables)
        return pot, [Z_FROM_SYMBOL[e] for e in tables.elements], tables.cutoff
    if name == "sw":
        from surface_sampling_tpu_torch.potentials.sw import load_sw, make_sw, sw_tables

        f = calc_settings.get("potential_file")
        tables = load_sw(f) if f else sw_tables()
        pot = make_sw(tables, device=dev)
        vars(pot)["manybody_tables"] = ("sw", tables)
        return pot, [Z_FROM_SYMBOL[e] for e in tables.elements], tables.cutoff
    if name in ("nff", "painn"):
        from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
        from surface_sampling_tpu_torch.models.weights import (
            from_jax_params,
            load_painn_ensemble,
            load_painn_npz,
        )

        model_paths = calc_settings["model_paths"]
        if len(model_paths) > 1:
            params, cfg = load_painn_ensemble(model_paths, dev)
        else:
            tree, cfg = load_painn_npz(model_paths[0])
            params = from_jax_params(tree, dev)
        if calc_settings.get("max_neighbors"):
            cfg = dataclasses.replace(cfg, max_neighbors=int(calc_settings["max_neighbors"]))
        numbers = [Z_FROM_SYMBOL[e] for e in calc_settings["elements"]]
        offset_data = calc_settings.get("offset_data") or {}
        if isinstance(offset_data, str):
            offset_data = json.loads(Path(offset_data).read_text())
            calc_settings["offset_data"] = offset_data
        pot = make_painn_potential(params, cfg, numbers,
                                   units=calc_settings.get("model_units", "kcal/mol"),
                                   stoidict=offset_data.get("stoidict"), device=dev)
        return pot, numbers, cfg.cutoff
    if name == "chgnet":
        from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential
        from surface_sampling_tpu_torch.models.weights import from_jax_params, load_chgnet_npz

        tree, cfg = load_chgnet_npz(calc_settings["model_path"])
        numbers = [Z_FROM_SYMBOL[e] for e in calc_settings["elements"]]
        pot = make_chgnet_potential(from_jax_params(tree, dev), cfg, numbers,
                                    units=calc_settings.get("model_units", "eV"), device=dev)
        return pot, numbers, cfg.atom_graph_cutoff
    if name in ("mace", "nffscalemace"):
        from surface_sampling_tpu_torch.models.mace import load_mace_npz, make_mace_potential
        from surface_sampling_tpu_torch.models.weights import from_jax_params

        tree, cfg = load_mace_npz(calc_settings["model_path"])
        numbers = [Z_FROM_SYMBOL[e] for e in calc_settings["elements"]]
        pot = make_mace_potential(from_jax_params(tree, dev), cfg, numbers,
                                  units=calc_settings.get("model_units", "eV"), device=dev)
        return pot, numbers, cfg.cutoff
    if name == "lj":
        from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones

        p = calc_settings
        return (make_lennard_jones(p.get("epsilon", 1.0), p.get("sigma", 1.0),
                                   p.get("cutoff", 5.0)), [0], p.get("cutoff", 5.0))
    if name == "morse":
        from surface_sampling_tpu_torch.potentials.pair import make_morse

        p = calc_settings
        return (make_morse(p.get("D", 1.0), p.get("alpha", 1.5), p.get("r0", 2.5),
                           p.get("cutoff", 6.0)), [0], p.get("cutoff", 6.0))
    raise ValueError(f"unknown calc_name {name!r}")


@dataclass
class AssembledSystem:
    spec: object
    potential: object
    run: MCMCRun
    settings: dict


def _nn_builder(family: str):
    if family == "painn":
        from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential

        return make_painn_potential
    if family == "chgnet":
        from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential

        return make_chgnet_potential
    from surface_sampling_tpu_torch.models.mace import make_mace_potential

    return make_mace_potential


def assemble_system(settings: dict, slab: Structure, surface_energy_fn=None,
                    device: str | torch.device = "cuda") -> AssembledSystem:
    """Spec, potential and MC run of a settings dict on ``slab``, with the
    JAX package's fast-path switches (``calc_settings.fast``, default on):
    rigid EAM as quadratic forms (``make_eam_rigid``; the Chebyshev static
    path for group vocabularies and relaxing runs), rigid Tersoff / SW as
    occupancy algebra, NN potentials rebuilt over the spec's static
    candidate table (PaiNN with its routing band), and the hooks of the
    delta engine (``inc_args``) and of the ball-local relax engines
    (``local_relax_args``)."""
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table

    dev = resolve_device(device)
    sys_s = settings["system_settings"]
    calc_s = settings["calc_settings"]
    potential, numbers, pot_cutoff = build_potential(calc_s, sys_s, dev)
    fast = calc_s.get("fast", True)
    relax_atoms = calc_s.get("relax_atoms", False)
    cutoff = sys_s.get("cutoff", pot_cutoff)

    ads_coords = sys_s.get("ads_coords")
    if ads_coords is None:
        ads_coords = find_adsorption_sites(
            slab,
            planar_distance=sys_s.get("planar_distance", 2.0),
            near_reduce=sys_s.get("near_reduce", 0.01),
            no_obtuse_hollow=sys_s.get("no_obtuse_hollow", True),
            symm_reduce=sys_s.get("symm_reduce", False),
        )[sys_s.get("ads_site_type", "all")]
    ads_coords = np.asarray(ads_coords)
    adsorbates = settings["sampling_settings"].get("adsorbates") or list(
        calc_s.get("chem_pots", {}).keys())
    spec = make_spec(
        slab, ads_coords, adsorbates, potential_numbers=numbers, cutoff=cutoff,
        surface_depth=sys_s.get("surface_depth"), surface_name=sys_s.get("surface_name"),
        extra_elements=list(calc_s.get("chem_pots", {}).keys()) or None,
    )

    tables = vars(potential).get("tables")
    if tables is not None and fast:
        from surface_sampling_tpu_torch.potentials.eam import make_eam_rigid, make_eam_static

        if relax_atoms:
            nbr = build_static_neighbor_table(spec, cutoff, relax_slack=0.6)
            potential = make_eam_static(tables, nbr, mode="cheb", device=dev)
        else:
            # rigid MC: exact-spline quadratic forms; group vocabularies fall
            # back to the Chebyshev candidate path
            try:
                potential = make_eam_rigid(tables, spec, device=dev)
            except ValueError:
                nbr = build_static_neighbor_table(spec, cutoff, relax_slack=0.05)
                potential = make_eam_static(tables, nbr, mode="cheb", device=dev)

    manybody = vars(potential).get("manybody_tables")
    if manybody is not None and fast and not relax_atoms:
        from surface_sampling_tpu_torch.potentials.rigid_manybody import (
            make_sw_rigid,
            make_tersoff_rigid,
        )

        kind, mb_tables = manybody
        try:
            make = make_tersoff_rigid if kind == "tersoff" else make_sw_rigid
            potential = make(mb_tables, spec, device=dev)
        except ValueError as e:
            # group vocabulary or table-budget refusal: keep the dynamic path
            logging.getLogger("sst").info("rigid fast path skipped: %s", e)

    # NN potentials are rebuilt over the spec's static candidate table
    painn_args = painn_nbr = None
    if fast:
        for fam in ("painn", "chgnet", "mace"):
            nn_args = vars(potential).get(f"{fam}_args")
            if nn_args is None:
                continue
            cfg_nn = nn_args["cfg"]
            cut = getattr(cfg_nn, "cutoff", None) or cfg_nn.atom_graph_cutoff
            nbr = build_static_neighbor_table(spec, cut,
                                              relax_slack=0.6 if relax_atoms else 0.1)
            if fam == "painn":
                from surface_sampling_tpu_torch.ops.banding import build_routing_band_for_spec

                # the banded kernels wherever the candidate windows are
                # narrower than the cell; the rigid static-edge path without
                # relaxation
                nn_args = dict(nn_args, routing_band=build_routing_band_for_spec(spec, nbr),
                               spec=None if relax_atoms else spec)
                painn_args, painn_nbr = nn_args, nbr
            potential = _nn_builder(fam)(static_nbr=nbr, **nn_args)
            break

    if surface_energy_fn is None and calc_s.get("offset", False):
        offset_data = calc_s["offset_data"]
        if isinstance(offset_data, str):
            offset_data = json.loads(Path(offset_data).read_text())
            calc_s["offset_data"] = offset_data
        surface_energy_fn = make_offset_surface_energy(
            spec, calc_s.get("chem_pots", {}), offset_data,
            offset_units=calc_s.get("offset_units", "atomic"), device=dev)

    # the delta engine's hook on rigid banded PaiNN assemblies
    if (painn_args is not None and painn_args.get("routing_band") is not None
            and not relax_atoms):
        vars(potential)["inc_args"] = dict(
            spec=spec, static_nbr=painn_nbr, band=painn_args["routing_band"],
            surface_energy_fn=surface_energy_fn)

    relax = relax_config(calc_s)
    if relax is not None:
        nbr_lr = (painn_nbr if painn_nbr is not None
                  else build_static_neighbor_table(spec, cutoff, relax_slack=0.6))
        # the warm-started ball-local relax engines: "exact" (full-cell
        # forces, core/local_relax.py) or "frozen_far_field" (PaiNN only,
        # core/ff_relax.py); acceptance energies are full-cell in both
        vars(potential)["local_relax_args"] = dict(
            spec=spec, static_nbr=nbr_lr, hops=int(calc_s.get("relax_ball_hops", 1)),
            relax=relax, surface_energy_fn=surface_energy_fn,
            descent=str(calc_s.get("relax_descent", "exact")))
    run = MCMCRun(spec, potential, surface_energy_fn=surface_energy_fn, device=dev, relax=relax)
    return AssembledSystem(spec, potential, run, settings)


def _truncate_stats(stats_path: Path, last_kept: int) -> None:
    """Drop stats.csv rows past ``last_kept`` (a crash between a chunk's
    stats flush and its checkpoint leaves extra rows), and malformed rows."""
    try:
        rows = stats_path.read_text().splitlines()
    except OSError:
        return
    if not rows:
        return
    kept = [rows[0]]
    for r in rows[1:]:
        try:
            if int(r.split(",", 1)[0]) <= last_kept:
                kept.append(r)
        except ValueError:
            pass   # a partial row of a crash mid-append
    stats_path.write_text("\n".join(kept) + "\n")


def even_prefill_states(spec, num_ads_atoms: int, n_chains: int, seed: int) -> np.ndarray:
    """(n_chains, S) int32 even-site prefills: every chain the same evenly
    spread sites (Ward clustering is deterministic), each its own random
    codes and tie-break top-ups."""
    return np.stack([
        even_site_prefill(spec, num_ads_atoms, rng=np.random.default_rng((seed, 1000 + c)))
        for c in range(n_chains)
    ])


def _schedule(samp: dict, sweeps: int, run_folder: Path) -> np.ndarray:
    anneal = samp.get("anneal_schedule")
    if anneal is not None:
        return np.asarray(anneal, dtype=np.float64)
    if samp.get("perform_annealing", True):
        temps = create_anneal_schedule(
            start_temp=samp["start_temp"], total_sweeps=sweeps, alpha=samp.get("alpha", 0.99),
            multiple_anneal=samp.get("multiple_anneal", False), save_folder=run_folder)
        # optional floor: anneal down to t_min, then hold (a floor at or
        # below the last temperature of a shorter schedule leaves its entries
        # unchanged, so --resume extensions stay exact)
        if samp.get("t_min") is not None:
            temps = np.maximum(temps, float(samp["t_min"]))
        return temps
    return np.repeat(samp["start_temp"], sweeps)


def _engine_config(samp: dict) -> EngineConfig:
    return EngineConfig(
        sweep_size=int(samp["sweep_size"]),
        canonical=bool(samp.get("canonical", False)),
        num_ads_atoms=int(samp.get("num_ads_atoms", 0)),
        # filter_distance > 0 replaces Metropolis with the geometric
        # criterion; an explicit "criterion" overrides
        criterion=samp.get("criterion") or ("testing" if samp.get("testing") else (
            "distance" if samp.get("filter_distance", 0) > 0 else "metropolis")),
        filter_distance=float(samp.get("filter_distance", 0) or 1.5),
        record_positions=bool(samp.get("record_positions", True)),
        require_per_atom_energies=bool(samp.get("require_per_atom_energies", False)),
        require_distance_decay=bool(samp.get("require_distance_decay", False)),
        prep_max_steps=(int(samp["prep_max_steps"]) if samp.get("prep_max_steps") is not None
                        else None),
        prep_force_fill=bool(samp.get("prep_force_fill", False)),
        mtm_trials=int(samp.get("mtm_trials", 0)),
    )


def _chunks(n_seg: int, every: int) -> list[tuple[int, int]]:
    if not 0 < every < n_seg:
        return [(0, n_seg)]
    return [(lo, min(lo + every, n_seg)) for lo in range(0, n_seg, every)]


def _host(rec) -> dict:
    """A record's tensors as numpy arrays, by field."""
    return {k: v.detach().cpu().numpy() for k, v in rec._asdict().items()}


def _log_chunk_retries(samp: dict, logger) -> None:
    if int(samp.get("chunk_retries", 0) or 0) > 0:
        logger.info("chunk_retries=%s has no effect in the port: no chunk is replayed (a "
                    "CUDA error is sticky, and a replay would hide a fault of the device); an "
                    "error propagates and the last checkpoint stands for --resume",
                    samp["chunk_retries"])


def _check_incremental(cfg: EngineConfig, weighted: bool = True) -> None:
    if cfg.mtm_trials > 1:
        raise ValueError("incremental=true builds single-try steps — drop mtm_trials")
    if cfg.criterion not in ("metropolis", "metropolis_distance"):
        raise ValueError("incremental=true supports the metropolis and "
                         f"metropolis_distance criteria (got {cfg.criterion!r})")
    if weighted and (cfg.require_per_atom_energies or cfg.require_distance_decay):
        raise ValueError("incremental=true uses the symmetric unweighted proposals "
                         "— drop require_per_atom_energies/require_distance_decay")


def _lr_args(asys) -> dict:
    lr_args = vars(asys.potential).get("local_relax_args")
    if lr_args is None:
        raise ValueError("sampling_settings.incremental=true with relax_atoms needs the "
                         "local_relax_args hook (assembled CLI systems attach it whenever "
                         "relax_atoms is on)")
    return lr_args


def _inc_args(asys) -> dict:
    inc_args = vars(asys.potential).get("inc_args")
    if inc_args is None:
        raise ValueError("sampling_settings.incremental=true needs a rigid banded PaiNN "
                         "assembly (supercell geometry wide enough to band, calc_settings "
                         "fast path on, relax_atoms off) — this system carries no inc_args "
                         "hook")
    return inc_args


def _local_relax_sweeps(asys, cfg: EngineConfig):
    """The exact ball-local relax run (``core/local_relax.py``) over
    MCState, positions recorded as ``cfg.record_positions`` asks."""
    from surface_sampling_tpu_torch.core.local_relax import (
        build_ball_masks,
        make_local_relax_canonical_step,
        make_local_relax_eval,
        make_local_relax_run,
        make_local_relax_semigrand_step,
    )

    d, lr = asys.run.d, _lr_args(asys)
    balls = build_ball_masks(lr["spec"], lr["static_nbr"], hops=lr["hops"])
    evaluate = make_local_relax_eval(d, asys.potential, surface_energy_fn=lr["surface_energy_fn"],
                                     relax=lr["relax"], ball_masks=balls)
    mk = make_local_relax_canonical_step if cfg.canonical else make_local_relax_semigrand_step
    step = mk(evaluate, criterion=cfg.criterion, d=d, filter_distance=cfg.filter_distance)
    inner = make_local_relax_run(step, cfg.sweep_size, d.site_coords.shape[0], d.n_codes,
                                 canonical=cfg.canonical)
    if cfg.record_positions:
        return inner

    def run(state, temps, generator):
        out, rec = inner(state, temps, generator)
        return out, rec._replace(positions=rec.positions[:, :, :0])

    return run


def _incremental_engine(asys, cfg: EngineConfig):
    """The delta engine of the assembly and its sweep run over IncState."""
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_canonical_step,
        make_incremental_painn,
        make_incremental_run,
        make_incremental_semigrand_step,
    )

    d, inc = asys.run.d, _inc_args(asys)
    engine = make_incremental_painn(inc["spec"], d, asys.potential, inc["static_nbr"],
                                    inc["band"], inc["surface_energy_fn"])
    mk = make_incremental_canonical_step if cfg.canonical else make_incremental_semigrand_step
    step = mk(engine, d=d, criterion=cfg.criterion, filter_distance=cfg.filter_distance)
    return engine, make_incremental_run(step, cfg.sweep_size, engine.n_sites, engine.n_codes,
                                        canonical=cfg.canonical)


def _run_fn(asys, cfg: EngineConfig, samp: dict, logger, dwm):
    """``run(states, temps, generator) -> (states, SweepRecord)`` of the
    engine the settings select, over MCState."""
    d = asys.run.d
    if samp.get("incremental", False) and asys.run.relax is not None:
        lr = _lr_args(asys)
        _check_incremental(cfg)
        descent = lr.get("descent", "exact")
        if descent in ("frozen_far_field", "ff"):
            from surface_sampling_tpu_torch.core.ff_relax import (
                build_ff_tables,
                make_ff_canonical_step,
                make_ff_relax_eval,
                make_ff_run_mcstate,
                make_ff_semigrand_step,
            )
            from surface_sampling_tpu_torch.models.nn_calculator import PaiNNPotential

            if not isinstance(asys.potential, PaiNNPotential):
                raise ValueError("relax_descent='frozen_far_field' needs a PaiNN-family "
                                 "potential (this calculator carries no ff_pack hook)")
            tables = build_ff_tables(lr["spec"], lr["static_nbr"], hops=lr["hops"])
            seat_tables = (build_ff_tables(lr["spec"], lr["static_nbr"], hops=0)
                           if asys.settings["calc_settings"].get("relax_seat", False) else None)
            evaluate = make_ff_relax_eval(d, asys.potential,
                                          surface_energy_fn=lr["surface_energy_fn"],
                                          relax=lr["relax"], tables=tables,
                                          seat_tables=seat_tables)
            mk = make_ff_canonical_step if cfg.canonical else make_ff_semigrand_step
            step = mk(evaluate, criterion=cfg.criterion, d=d, filter_distance=cfg.filter_distance)
            logger.info("frozen-far-field ball relax MC engine active (hops=%d, ball=%d/%d rows, "
                        "ball_frac=%.3f)", lr["hops"], tables.n_ball, tables.n_sub,
                        tables.ball_frac)
            return make_ff_run_mcstate(evaluate, step, cfg.sweep_size, d.site_coords.shape[0],
                                       d.n_codes, canonical=cfg.canonical,
                                       record_positions=cfg.record_positions)
        if descent != "exact":
            raise ValueError(f"unknown calc_settings.relax_descent {descent!r} "
                             "(expected 'exact' or 'frozen_far_field')")
        logger.info("warm-started ball-local relax MC engine active (hops=%d)", lr["hops"])
        return _local_relax_sweeps(asys, cfg)
    if samp.get("incremental", False):
        _inc_args(asys)
        _check_incremental(cfg)
        engine, inc_run = _incremental_engine(asys, cfg)

        def run(state: MCState, temps, generator):
            # caches rebuilt from the occupancy at every chunk start, so a
            # chunk is a function of (states, generator, temps) alone
            inc1, rec = inc_run(engine.init_state(state.site_state), temps, generator)
            out = state._replace(site_state=inc1.site_state, energy=inc1.energy)
            C, T = rec.energy.shape
            return out, SweepRecord(site_state=rec.site_state, energy=rec.energy,
                                    accept_rate=rec.accept_rate, n_ads=rec.n_ads,
                                    positions=state.relaxed_positions.new_zeros((C, T, 0, 3)),
                                    oob_rate=rec.oob_rate)

        logger.info("incremental (delta-energy) MC engine active")
        return run
    return make_run_fn(d, asys.run.state_energy_fn, cfg, potential=asys.potential,
                       distance_weight_matrix=dwm)


def _mode(samp: dict) -> str:
    if samp.get("tempering", False):
        return "tempering"
    if samp.get("population_annealing", False):
        return "population_annealing"
    return "plain"


def _check_mode(samp: dict, extra: dict) -> None:
    """The JAX package refuses a tempering resume of a checkpoint without a
    swap key and a PA resume of one without a PA key; here the checkpoint
    names the run mode that wrote it, and any mismatch is refused."""
    got, want = str(extra.get("mode", "plain")), _mode(samp)
    if got == want:
        return
    if want == "tempering":
        raise ValueError(f"checkpoint mode is {got!r}: it was not written by a tempering run")
    if want == "population_annealing":
        raise ValueError(f"checkpoint mode is {got!r}: it was not written by a "
                         "population-annealing run")
    raise ValueError(f"checkpoint mode is {got!r}: it was written by a {got} run, and these "
                     "settings ask for a plain one")


def _check_schedule(temps, temps_prev, start_sweep: int) -> None:
    n_prev = min(start_sweep, len(temps_prev), len(temps))
    if not np.allclose(temps[:n_prev], temps_prev[:n_prev], rtol=1e-9, atol=1e-12):
        raise ValueError(
            f"temperature schedule mismatch: the first {n_prev} sweeps of the new schedule "
            "differ from the checkpointed run — resume requires the same settings")


def _write_best(run_folder: Path, d, spec, ss_best, pos, energy: float) -> None:
    ss = torch.as_tensor(np.asarray(ss_best)[None], dtype=torch.int64, device=d.device)
    numbers = realize_numbers(d, ss)[0].cpu().numpy()
    if pos is None:
        pos = realize_positions(d, ss)[0].cpu().numpy()
    keep = numbers > 0
    write_cif(run_folder / f"best_energy_{energy:.3f}.cif",
              Structure(numbers[keep], np.asarray(pos)[keep], spec.cell))


def run_sampling(asys: AssembledSystem, run_folder: Path, seed: int = 0, site_state0=None,
                 resume=None) -> dict:
    """Run the batched MC and write the artifacts: stats.csv (flushed per
    chunk), anneal_schedule.csv, summary_stats.png (with matplotlib), the
    best structure's CIF, checkpoint.npz, history.npz, sampling_quality.json
    (8 sweeps or more) and, with ``save_structures``, a per-sweep XYZ
    trajectory; mc.log holds the log.

    ``resume``: a prior run's checkpoint.npz (or its folder). Chain states,
    the generator state and the sweep index are restored, so the
    continuation is bitwise the tail of an uninterrupted run over the same
    schedule (with the same chunk boundaries where an engine rebuilds
    caches at each chunk). ``total_sweeps`` is the full target; only the
    remaining sweeps run, and an existing stats.csv is appended to.

    Returns energy_hist / frac_accept_hist / adsorption_count_hist (chains,
    sweeps of this segment), best_energy, run_folder and timing (the
    PhaseTimer's seconds by phase)."""
    samp = asys.settings["sampling_settings"]
    logger = setup_logger("sst", run_folder / "mc.log")
    n_chains = int(samp.get("n_chains", 1))
    sweeps = int(samp["total_sweeps"])
    d = asys.run.d
    se_fn = asys.run.state_energy_fn
    timer = PhaseTimer()
    temps = _schedule(samp, sweeps, run_folder)
    cfg = _engine_config(samp)
    dwm = None
    if cfg.require_distance_decay:
        from surface_sampling_tpu_torch.utils.misc import compute_distance_weight_matrix

        dwm = compute_distance_weight_matrix(asys.spec.site_coords,
                                             float(samp.get("distance_decay_factor", 1.0)))

    start_sweep, temps_prev = 0, None
    with timer.phase("init"):
        if resume is not None:
            ckpt_path = Path(resume)
            if ckpt_path.is_dir():
                ckpt_path = ckpt_path / "checkpoint.npz"
            if not ckpt_path.exists():
                raise FileNotFoundError(f"no checkpoint at {ckpt_path}")
            states, start_sweep, temps_prev, ckpt_extra, gen = load_checkpoint(ckpt_path,
                                                                               d.device)
            got_chains = int(states.site_state.shape[0])
            if got_chains != n_chains:
                raise ValueError(f"checkpoint has {got_chains} chains but settings ask for "
                                 f"{n_chains}; set sampling_settings.n_chains={got_chains}")
            _check_mode(samp, ckpt_extra)
            if not samp.get("tempering", False):
                _check_schedule(temps, temps_prev, start_sweep)
            if start_sweep >= sweeps:
                raise ValueError(f"checkpoint already completed {start_sweep} sweeps; "
                                 f"raise total_sweeps (currently {sweeps}) to continue")
            logger.info("Resuming from %s at sweep %d/%d", ckpt_path, start_sweep, sweeps)
        else:
            gen = make_generator(seed, d.device)
            states = chain_states(d, n_chains, site_state0)
            if cfg.canonical and cfg.num_ads_atoms > 0:
                if samp.get("even_adsorption_sites", False):
                    ss0 = even_prefill_states(asys.spec, cfg.num_ads_atoms, n_chains, seed)
                    states = chain_states(d, n_chains, ss0)
                else:
                    states = states._replace(energy=se_fn(states.site_state).surface_energy)
                    prep = prepare_canonical_fn(d, se_fn, cfg.num_ads_atoms, cfg,
                                                max_steps=cfg.prep_max_steps,
                                                force_fill=cfg.prep_force_fill)
                    states = prep(states, float(temps[0]), gen)
            # the energies and, for a relaxing run, the relaxed geometry they
            # describe (JAX keeps the ideal positions here)
            first = se_fn(states.site_state)
            states = states._replace(energy=first.surface_energy,
                                     relaxed_positions=first.positions)

    if samp.get("tempering", False) and samp.get("population_annealing", False):
        raise ValueError("tempering=true and population_annealing=true are mutually "
                         "exclusive sampling modes — pick one")
    if samp.get("incremental", False) and samp.get("population_annealing", False):
        raise ValueError("incremental=true does not compose with population_annealing "
                         "(the resampler would replicate the per-chain feature caches; "
                         "peak-memory prohibitive at supercell sizes) — drop one; "
                         "incremental+tempering IS supported")
    _log_chunk_retries(samp, logger)
    if samp.get("population_annealing", False):
        if cfg.mtm_trials > 1:
            raise ValueError("mtm_trials is not supported with population_annealing=true: the "
                             "PA runner builds single-try steps — drop one of the two settings")
        return _run_population_annealing(asys, run_folder, states, temps, cfg, samp, logger,
                                         gen, timer, start_sweep=start_sweep)
    if samp.get("tempering", False):
        if cfg.mtm_trials > 1:
            raise ValueError("mtm_trials is not supported with tempering=true: the "
                             "replica-exchange runner builds single-try steps — drop one of "
                             "the two settings")
        return _run_tempered(asys, run_folder, states, temps, cfg, samp, logger, gen, timer,
                             start_round=start_sweep, prev_ladder=temps_prev)

    temps_seg = np.asarray(temps)[start_sweep:sweeps]
    n_seg = len(temps_seg)
    if samp.get("incremental", False) and asys.run.relax is None:
        cfg = dataclasses.replace(cfg, record_positions=False)   # realized on export
    crun = make_chain_run(_run_fn(asys, cfg, samp, logger, dwm))
    logger.info("Running %d chains x %d sweeps x %d steps on %s", n_chains, n_seg,
                cfg.sweep_size, d.device)

    chunk_bounds = _chunks(n_seg, int(samp.get("checkpoint_interval", 0) or 0))
    stats_path = run_folder / "stats.csv"
    if not (start_sweep > 0 and stats_path.exists()):
        stats_path.write_text(STATS_HEADER + "\n")
    else:
        _truncate_stats(stats_path, start_sweep)

    def flush_stats(lo, hi, r):
        e, acc, na, ob = r["energy"], r["accept_rate"], r["n_ads"], r["oob_rate"]
        rows = [f"{start_sweep + lo + i + 1},{temps_seg[lo + i]:.6f},"
                f"{e[:, i].mean():.6f},{e[:, i].min():.6f},"
                f"{acc[:, i].mean():.4f},{na[:, i].mean():.3f},{ob[:, i].mean():.4f}"
                for i in range(hi - lo)]
        with stats_path.open("a") as f:
            f.write("\n".join(rows) + "\n")

    rec_parts = []
    for ci, (lo, hi) in enumerate(chunk_bounds):
        # the first chunk carries the kernel builds and the first launches
        with timer.phase("first_chunk" if ci == 0 else "mc_chunks"):
            states, recs = crun(states, temps_seg[lo:hi], gen)
            r = _host(recs)
        rec_parts.append(r)
        with timer.phase("checkpoint_io"):
            # stats before the checkpoint: a crash in between leaves extra
            # rows, which the resume path truncates
            flush_stats(lo, hi, r)
            if len(chunk_bounds) > 1:
                save_checkpoint(run_folder / "checkpoint.npz", states, start_sweep + hi, temps,
                                gen, extra={"mode": "plain"})
                logger.info("checkpoint at sweep %d/%d", start_sweep + hi, sweeps)

    with timer.phase("artifacts"):
        def cat(field):
            return np.concatenate([r[field] for r in rec_parts], axis=1)

        energy, accept, n_ads, oob = (cat(k) for k in ("energy", "accept_rate", "n_ads",
                                                        "oob_rate"))
        if oob.mean() > 0:
            logger.warning("%.2f%% of trial moves hit the OOB energy clamp", 100 * oob.mean())
        if n_seg >= 8:
            from surface_sampling_tpu_torch.analysis.statistics import (
                integrated_autocorrelation_time,
            )

            probe = range(min(n_chains, 16))
            tau = float(np.mean([integrated_autocorrelation_time(energy[c]) for c in probe]))
            # pooled ESS = N_total / tau_mean (the JAX package's estimator)
            ess = float(n_chains * energy.shape[1] / max(tau, 1.0))
            logger.info("sampling quality: tau_int=%.2f sweeps, pooled ESS=%.0f", tau, ess)
            (run_folder / "sampling_quality.json").write_text(json.dumps(
                {"tau_int_sweeps": tau, "pooled_ess": ess, "n_chains": n_chains,
                 "sweeps": n_seg}))

        from surface_sampling_tpu_torch.utils.plot import plot_summary_stats

        plot_summary_stats(energy.mean(axis=0), accept.mean(axis=0), n_ads.mean(axis=0), n_seg,
                           save_folder=run_folder)

        flat = energy.reshape(-1)
        best = int(np.argmin(flat))
        bc, bs = divmod(best, n_seg)
        site_state_all = cat("site_state").astype(np.int32)
        pos_all = cat("positions") if cfg.record_positions else None
        _write_best(run_folder, d, asys.spec, site_state_all[bc, bs],
                    None if pos_all is None else pos_all[bc, bs], float(flat[best]))
        save_checkpoint(run_folder / "checkpoint.npz", states, sweeps, temps, gen,
                        extra={"mode": "plain"})
        np.savez_compressed(run_folder / "history.npz", site_state=site_state_all,
                            energy=energy, accept_rate=accept, n_ads=n_ads.astype(np.int32),
                            temps=temps_seg, start_sweep=np.asarray(start_sweep))
        save_mode = str(samp.get("save_structures", "none")).lower()
        if save_mode in ("best", "chain0"):
            _save_structures(run_folder, asys, save_mode, energy, site_state_all, pos_all,
                             start_sweep, logger)

    logger.info("Best surface energy %.4f eV (chain %d sweep %d)", flat[best], bc,
                start_sweep + bs + 1)
    logger.info("Timing: %s", timer.report().replace("\n", " | "))
    return {
        "energy_hist": energy,
        "frac_accept_hist": accept,
        "adsorption_count_hist": n_ads,
        "best_energy": float(flat[best]),
        "run_folder": run_folder,
        "timing": timer.as_dict(),
    }


def _save_structures(run_folder: Path, asys, save_mode: str, energy, site_state_all, pos_all,
                     start_sweep: int, logger) -> None:
    """One structure a sweep: the lowest-energy chain's ("best") or chain
    0's ("chain0"). A fixed composition goes through the native multi-frame
    XYZ writer, a varying one frame by frame."""
    d = asys.run.d
    n_seg = energy.shape[1]
    chains = (np.argmin(energy, axis=0) if save_mode == "best"
              else np.zeros(n_seg, dtype=np.int64))
    ss = torch.as_tensor(site_state_all[chains, np.arange(n_seg)], dtype=torch.int64,
                         device=d.device)
    nums_all = realize_numbers(d, ss).cpu().numpy()
    pos_frames = (pos_all[chains, np.arange(n_seg)] if pos_all is not None
                  else realize_positions(d, ss).cpu().numpy())
    frames_num = [n[n > 0] for n in nums_all]
    frames_pos = [p[n > 0] for n, p in zip(nums_all, pos_frames)]
    traj_path = run_folder / f"traj_{save_mode}.xyz"
    if len({len(n) for n in frames_num}) == 1 and all(
            np.array_equal(n, frames_num[0]) for n in frames_num):
        from surface_sampling_tpu_torch.runtime.native import write_xyz_frames

        write_xyz_frames(traj_path, frames_num[0], np.stack(frames_pos), asys.spec.cell)
    else:
        cellstr = " ".join(f"{x:.8f}" for x in asys.spec.cell.flatten())
        with traj_path.open("w") as f:
            for k, (nums, posf) in enumerate(zip(frames_num, frames_pos)):
                f.write(f"{len(nums)}\n")
                f.write(f'Lattice="{cellstr}" Properties=species:S:1:pos:R:3 '
                        f"sweep={start_sweep + k + 1}\n")
                for z, pz in zip(nums, posf):
                    f.write(f"{SYMBOL_FROM_Z[int(z)]} {pz[0]:.8f} {pz[1]:.8f} {pz[2]:.8f}\n")
    logger.info("wrote %d per-sweep structures -> %s", n_seg, traj_path.name)


def _sweep_run(asys, cfg: EngineConfig):
    """One sweep of single-try full-evaluation steps (the tempering and PA
    runners' sweep): unweighted proposals, no positions recorded."""
    plain = dataclasses.replace(cfg, mtm_trials=0, require_per_atom_energies=False,
                                require_distance_decay=False, record_positions=False)
    return make_run_fn(asys.run.d, asys.run.state_energy_fn, plain)


def _run_tempered(asys, run_folder, states, temps, cfg, samp, logger, gen, timer,
                  start_round: int = 0, prev_ladder=None):
    """Replica exchange: the chains become a temperature ladder with one
    swap phase a sweep (``parallel/tempering.py``). The generator carries
    the swap draws with the steps', so a resumed run continues the exact
    swap sequence (``start_round`` keeps the pair parity)."""
    from surface_sampling_tpu_torch.parallel.tempering import make_tempered_run, temperature_ladder
    from surface_sampling_tpu_torch.utils.plot import plot_energy_analysis

    d = asys.run.d
    n_chains = int(states.site_state.shape[0])
    t_min = float(samp.get("t_min", min(temps)))
    t_max = float(samp.get("t_max", max(temps)))
    ladder = temperature_ladder(t_min, t_max, n_chains).astype(np.float32)
    if prev_ladder is not None and not np.allclose(ladder, np.asarray(prev_ladder, np.float32),
                                                   rtol=1e-6, atol=1e-7):
        raise ValueError("temperature ladder mismatch: resumed tempering needs the same "
                         "t_min/t_max/n_chains as the checkpointed run")
    engine = None
    if samp.get("incremental", False) and asys.run.relax is not None:
        lr = _lr_args(asys)
        _check_incremental(cfg, weighted=False)
        if lr.get("descent", "exact") in ("frozen_far_field", "ff"):
            raise ValueError(
                "relax_descent='frozen_far_field' does not compose with tempering yet: the "
                "replica rounds drive MCState sweeps directly, while the ff engine carries "
                "per-chain feature caches whose per-round rebuild would dominate short "
                "tempering rounds — run tempering with the exact descent, or ff without "
                "tempering")
        sweep = _local_relax_sweeps(asys, dataclasses.replace(cfg, record_positions=False))
        logger.info("ball-local relax tempered replicas active (hops=%d)", lr["hops"])
    elif samp.get("incremental", False):
        _inc_args(asys)
        _check_incremental(cfg)
        # caches travel with their configurations through the swap phase
        engine, sweep = _incremental_engine(asys, cfg)
        logger.info("incremental (delta-energy) tempered replicas active")
    else:
        sweep = _sweep_run(asys, cfg)
    n_rounds = len(temps)
    if start_round >= n_rounds:
        raise ValueError(f"checkpoint already completed {start_round} rounds; raise "
                         f"total_sweeps (currently {n_rounds}) to continue")
    n_seg = n_rounds - start_round
    logger.info("Tempering: %d replicas, ladder %.3f -> %.3f, rounds %d-%d", n_chains, t_max,
                t_min, start_round + 1, n_rounds)
    chunk_bounds = _chunks(n_seg, int(samp.get("checkpoint_interval", 0) or 0))
    stats_path = run_folder / "stats.csv"
    if not (start_round > 0 and stats_path.exists()):
        stats_path.write_text(TEMPER_HEADER + "\n")
    else:
        _truncate_stats(stats_path, start_round)

    rec_parts = []
    for ci, (lo, hi) in enumerate(chunk_bounds):
        trun = make_tempered_run(sweep, n_rounds=hi - lo)
        with timer.phase("first_chunk" if ci == 0 else "mc_chunks"):
            if engine is None:
                states, rec = trun(states, ladder, gen, start=start_round + lo)
            else:
                # caches rebuilt from the occupancy at every chunk start
                inc1, rec = trun(engine.init_state(states.site_state), ladder, gen,
                                 start=start_round + lo)
                states = states._replace(site_state=inc1.site_state, energy=inc1.energy)
            r = _host(rec)
        rec_parts.append(r)
        with timer.phase("checkpoint_io"):
            e, sw = r["energy"], r["swap_rate"]
            with stats_path.open("a") as f:
                f.write("\n".join(f"{start_round + lo + i + 1},{sw[i]:.4f},"
                                  f"{e[i].min():.6f},{e[i, -1]:.6f}"
                                  for i in range(hi - lo)) + "\n")
            save_checkpoint(run_folder / "checkpoint.npz", states, start_round + hi, ladder,
                            gen, extra={"mode": "tempering"})
            if len(chunk_bounds) > 1:
                logger.info("checkpoint at round %d/%d", start_round + hi, n_rounds)

    energy = np.concatenate([r["energy"] for r in rec_parts], axis=0)
    swap = np.concatenate([r["swap_rate"] for r in rec_parts], axis=0)
    plot_energy_analysis(energy.min(axis=1), swap, save_folder=run_folder)
    np.savez_compressed(
        run_folder / "history.npz",
        site_state=np.concatenate([r["site_state"] for r in rec_parts], axis=0).astype(np.int32),
        energy=energy, swap_rate=swap, ladder=ladder, start_round=np.asarray(start_round))
    best = float(energy.min())
    logger.info("Best energy %.4f eV; mean swap rate %.2f", best, swap.mean())
    return {
        "energy_hist": energy,
        "frac_accept_hist": swap,
        "adsorption_count_hist": np.zeros_like(swap),
        "best_energy": best,
        "run_folder": run_folder,
        "timing": timer.as_dict(),
    }


def _run_population_annealing(asys, run_folder, states, temps, cfg, samp, logger, gen, timer,
                              start_sweep: int = 0):
    """Population annealing (``parallel/population.py``): the chain batch
    is one population, reweighted and resampled along the schedule
    (``population_annealing: true``, ``resample_threshold``, default 0.5).
    Writes the free-energy estimate (pa_free_energy.json) and the per-sweep
    ESS / resampling telemetry. A resumed run reweights from the
    checkpointed sweep's temperature, and the generator continues the
    resampling draws."""
    from surface_sampling_tpu_torch.parallel.population import make_population_annealing_run
    from surface_sampling_tpu_torch.utils.plot import plot_summary_stats

    d = asys.run.d
    n_chains = int(states.site_state.shape[0])
    threshold = float(samp.get("resample_threshold", 0.5))
    parun = make_population_annealing_run(_sweep_run(asys, cfg), resample_threshold=threshold)
    n_rounds = len(temps)
    n_seg = n_rounds - start_sweep
    temps_seg = np.asarray(temps, np.float64)[start_sweep:]
    logger.info("Population annealing: %d chains, %d sweeps %.3f -> %.3f, resample at "
                "ESS/C < %.2f", n_chains, n_seg, temps_seg[0], temps_seg[-1], threshold)
    chunk_bounds = _chunks(n_seg, int(samp.get("checkpoint_interval", 0) or 0))
    stats_path = run_folder / "stats.csv"
    if not (start_sweep > 0 and stats_path.exists()):
        stats_path.write_text(PA_HEADER + "\n")
    else:
        _truncate_stats(stats_path, start_sweep)

    rec_parts = []
    for ci, (lo, hi) in enumerate(chunk_bounds):
        t_prev = (None if start_sweep + lo == 0
                  else float(np.float32(np.asarray(temps)[start_sweep + lo - 1])))
        with timer.phase("first_chunk" if ci == 0 else "mc_chunks"):
            states, rec = parun(states, temps_seg[lo:hi], gen, t_prev)
            r = _host(rec)
        rec_parts.append(r)
        with timer.phase("checkpoint_io"):
            e, ess = r["energy"], r["ess"] / n_chains
            dz, rs = r["dlogz"], r["resampled"]
            with stats_path.open("a") as f:
                f.write("\n".join(
                    f"{start_sweep + lo + i + 1},{temps_seg[lo + i]:.6f},"
                    f"{e[i].mean():.6f},{e[i].min():.6f},{ess[i]:.4f},"
                    f"{dz[i]:.6f},{int(rs[i])}" for i in range(hi - lo)) + "\n")
            save_checkpoint(run_folder / "checkpoint.npz", states, start_sweep + hi, temps, gen,
                            extra={"mode": "population_annealing"})
            if len(chunk_bounds) > 1:
                logger.info("checkpoint at sweep %d/%d", start_sweep + hi, n_rounds)

    def cat(field):
        return np.concatenate([r[field] for r in rec_parts], axis=0)

    energy, ess, dlogz, resampled = cat("energy"), cat("ess"), cat("dlogz"), cat("resampled")
    site_state = cat("site_state").astype(np.int32)
    # log[Z(T_end)/Z(T_start)] over this segment (for a resumed run the
    # earlier segments' terms are in the earlier stats.csv rows)
    dlogz_total = float(dlogz.sum())
    (run_folder / "pa_free_energy.json").write_text(json.dumps({
        "log_Z_ratio": dlogz_total,
        "t_start": float(temps_seg[0]),
        "t_end": float(temps_seg[-1]),
        "start_sweep": int(start_sweep),
        "n_chains": n_chains,
        "ess_frac_min": float(ess.min() / n_chains),
        "resample_fraction": float(resampled.mean()),
        "note": "log_Z_ratio = sum_k dlogz over this segment; "
                "F(T_end) - via Z ratios - is -T_end*(log_Z_ratio + log Z(T_start))",
    }))
    (run_folder / "sampling_quality.json").write_text(json.dumps({
        "ess_frac_final": float(ess[-1] / n_chains),
        "ess_frac_min": float(ess.min() / n_chains),
        "resample_fraction": float(resampled.mean()),
        "log_Z_ratio": dlogz_total,
        "n_chains": n_chains, "sweeps": int(len(temps_seg)),
    }))
    plot_summary_stats(energy.mean(axis=1), ess / n_chains, resampled.astype(float),
                       len(temps_seg), save_folder=run_folder)
    flat = energy.reshape(-1)
    best = int(np.argmin(flat))
    bs, bc = divmod(best, n_chains)
    _write_best(run_folder, d, asys.spec, site_state[bs, bc], None, float(flat[best]))
    np.savez_compressed(run_folder / "history.npz", site_state=site_state, energy=energy,
                        ess=ess, dlogz=dlogz, resampled=resampled, temps=temps_seg,
                        start_sweep=np.asarray(start_sweep))
    logger.info("Best surface energy %.4f eV; log[Z(%.3g)/Z(%.3g)] = %.3f (segment); min "
                "ESS/C %.2f; resampled %.0f%% of sweeps", flat[best], temps_seg[-1],
                temps_seg[0], dlogz_total, float(ess.min() / n_chains), 100 * resampled.mean())
    return {
        "energy_hist": energy.T,
        "frac_accept_hist": ess[None, :] / n_chains,
        "adsorption_count_hist": np.zeros((1, len(temps_seg))),
        "best_energy": float(flat[best]),
        "log_Z_ratio": dlogz_total,
        "run_folder": run_folder,
        "timing": timer.as_dict(),
    }


def make_run_folder(settings: dict, surface_name: str, base_dir=None) -> Path:
    """``sampling_settings.run_folder`` (created), or a new timestamped folder
    under ``base_dir`` (``utils.setup.setup_folders``)."""
    samp = settings["sampling_settings"]
    explicit = samp.get("run_folder")
    if explicit:
        p = Path(explicit)
        p.mkdir(parents=True, exist_ok=True)
        return p
    return setup_folders(surface_name, canonical=samp.get("canonical", False),
                         total_sweeps=samp["total_sweeps"], start_temp=samp["start_temp"],
                         alpha=samp.get("alpha", 1.0), base_dir=base_dir)
