"""The comparison that decides ``correct``: what the window produced,
judged by the plain reference (``benchmark/reference/``).

A sample of chains, drawn from the seed, is checked in two ways:

* the replay: the window's first sweep of those chains, from the empty
  surface the campaign starts on and on the draws of the run's generator
  state at the window's start, scored by the reference. Each chain's
  occupancy after the sweep must be the program's, unless a Metropolis
  decision on the way lay within the energy limit of its edge (a near
  tie, which an energy inside the limit may decide either way).
  ``replay_mismatches`` counts the others; its limit is 0.
* the energies: the program's surface energy of each sampled chain after
  that sweep and at the window's close (a delta cell's carried energy)
  against the reference's surface energy of the same occupancy.
  ``energy_gap_ev`` is the widest gap.

The control (``control=True``) is the reference itself in the precision
below the configuration's float32, its products in TF32: its widest gap to
the float32 reference on the same states.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark import family_module
from benchmark.reference.common import FP32, TF32, Precision, load_lattice, realise, strict_fp32
from benchmark.reference.fire import fire
from benchmark.reference.mc import replay_sweep
from benchmark.reference.surface import chem_pot_coefficients, offset_coefficients, surface_energy

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MAX_FORCE = 1000.0    # eV/A: a relaxation ending above it is out of bounds


def make_reference(cfg: dict, device):
    """The configuration's model, built by ``make_model(cfg, root, device)``
    of ``reference/<cfg["model"]>.py``, and its surface-energy
    coefficients."""
    family = family_module("reference", cfg["model"])
    if family is None:
        raise ValueError(f"no reference for model {cfg['model']!r}: add "
                         f"benchmark/reference/{cfg['model']}.py with make_model(cfg, root, "
                         f"device)")
    model = family.make_model(cfg, ROOT, device)
    se = cfg["surface_energy"]
    if se["kind"] == "offset":
        offset = json.loads((ROOT / se["offset_data"]).read_text())
        coeff = offset_coefficients(se["chem_pots"], offset, se.get("atomic_units", True))
    else:
        coeff = chem_pot_coefficients(se["chem_pots"])
    return model, coeff


def energy_function(model, coeff: dict, lat, chunk: int, prec: Precision = FP32,
                    relax: dict | None = None):
    """``fn(site_state (n, S), positions=None) -> (n,)`` float64 reference
    surface energies, ``chunk`` chains a call: at ``positions`` where given,
    else at the ideal positions, FIRE-relaxed first under ``relax``."""

    def fn(site_state: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        out = []
        for lo in range(0, site_state.shape[0], chunk):
            numbers, pos = realise(lat, site_state[lo:lo + chunk])

            def e_of(p):
                return model.potential_energy(numbers, p, lat.cell, lat.pbc, prec)

            fmax = None
            if positions is not None:
                pos = positions[lo:lo + chunk]
            elif relax is not None:
                frozen = torch.zeros_like(numbers, dtype=torch.bool)
                frozen[:, :lat.frozen.shape[0]] = lat.frozen
                pos, fmax = fire(e_of, pos, (numbers > 0) & ~frozen, relax)
            with torch.no_grad():
                e_pot = e_of(pos)
            if fmax is not None:
                # the engine's out-of-bounds rule for a relaxation
                e_pot = torch.where(fmax > MAX_FORCE, torch.full_like(e_pot, 1e30), e_pot)
            out.append(surface_energy(e_pot, numbers, coeff))
        return torch.cat(out)

    return fn


def check_run(wl: dict, seed: int, device, gen_start: torch.Tensor, after_first, final,
              control: bool = False):
    """The compared numbers, each with its limit, and what else the check
    saw (``near_ties``; with ``control``, the control's gap)."""
    strict_fp32()
    cfg, chk, sched = wl["config_file"], wl["check"], wl["schedule"]
    lat = load_lattice(BENCH / wl["lattice"], device)
    model, coeff = make_reference(cfg, device)
    relax = wl.get("relax")
    energy_fn = energy_function(model, coeff, lat, chk["chunk"])
    state_fn = energy_function(model, coeff, lat, chk["chunk"], relax=relax)
    C = wl["chains"]
    rows = np.sort(np.random.default_rng(seed).choice(C, chk["chains"], replace=False))
    rows_t = torch.as_tensor(rows, device=device)
    limit = wl["limits"]["energy_gap_ev"]

    gen = torch.Generator(device=device)
    gen.set_state(gen_start)
    empty = torch.zeros((len(rows), lat.n_sites), dtype=torch.int64, device=device)
    rep = replay_sweep(lat, state_fn, empty, state_fn(empty), rows_t, gen, C,
                       wl["sweep_size"], max(sched["start_temp"], sched.get("t_min", 0.0)), limit,
                       wl.get("filter_distance") if wl["criterion"] == "metropolis_distance"
                       else None)
    ss1, e1, pos1 = (None if x is None else x[rows_t].to(device) for x in after_first)
    ssf, ef, posf = (None if x is None else x[rows_t].to(device) for x in final)
    mismatch = (rep.site_state != ss1).any(dim=1)
    if relax is None:
        ref1, reff = energy_fn(ss1), energy_fn(ssf)
    else:
        # the model at the program's relaxed positions; the relaxation itself below
        ref1, reff = energy_fn(ss1, pos1), energy_fn(ssf, posf)
    gap = torch.cat([(e1.double() - ref1).abs(), (ef.double() - reff).abs()])
    w = int(gap.argmax())
    stage, k = ("first", w) if w < len(rows) else ("final", w - len(rows))
    worst_ss, worst_e, worst_ref = ((ss1, e1, ref1) if stage == "first" else (ssf, ef, reff))
    checks = {
        "energy_gap_ev": {"value": float(gap.max()), "limit": limit},
        "replay_mismatches": {"value": int((mismatch & ~rep.near_tie).sum()), "limit": 0},
    }
    if relax is not None:
        relaxed = torch.cat([(e1.double() - state_fn(ss1)).abs(),
                             (ef.double() - state_fn(ssf)).abs()])
        checks["relaxed_gap_ev"] = {"value": float(relaxed.max()),
                                    "limit": wl["limits"]["relaxed_gap_ev"]}
    seen = {"near_ties": int(rep.near_tie.sum()), "mismatch_at_near_tie":
            int((mismatch & rep.near_tie).sum()), "replay_accepted": int(rep.accepted.sum()),
            "chains_checked": len(rows),
            "worst": {"stage": stage, "chain": int(rows[k]), "program_ev": float(worst_e[k]),
                      "reference_ev": float(worst_ref[k]),
                      "site_state": worst_ss[k].tolist()}}
    if control:
        low = energy_function(model, coeff, lat, chk["chunk"], TF32)
        seen["control_energy_gap_ev"] = float(torch.cat([
            (low(ss1, pos1) - ref1).abs(), (low(ssf, posf) - reff).abs()]).max())
        if relax is not None:
            low = energy_function(model, coeff, lat, chk["chunk"], TF32, relax)
            seen["control_relaxed_gap_ev"] = float(torch.cat([
                (low(ss1) - state_fn(ss1)).abs(), (low(ssf) - state_fn(ssf)).abs()]).max())
    print("check " + " ".join(f"{k}={v}" for k, v in seen.items()), file=sys.stderr)
    return checks, seen
