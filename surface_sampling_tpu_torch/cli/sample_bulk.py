"""Bulk-defect VSSR-MC driver, on the card (the counterpart of
``surface_sampling_tpu/cli/sample_bulk.py``).

Every atom of the input bulk structure becomes a prefilled site, so
semigrand moves create vacancies and antisites and canonical moves shuffle
the existing species:

    python -m surface_sampling_tpu_torch.cli.sample_bulk --settings config.json \\
        --bulk bulk.cif [--seed 0] [--resume RUN] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_bulk_system(settings: dict, bulk_st, device="cuda"):
    """The driver's system: every atom of ``bulk_st`` a prefilled site.
    Returns (AssembledSystem, site_state0)."""
    from surface_sampling_tpu_torch.cli.common import (
        AssembledSystem,
        build_potential,
        relax_config,
    )
    from surface_sampling_tpu_torch.core.energy import make_offset_surface_energy
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.spec import make_spec_sampling_surface_atoms

    sys_s = settings["system_settings"]
    calc_s = settings["calc_settings"]
    samp = settings["sampling_settings"]
    potential, numbers, pot_cutoff = build_potential(calc_s, sys_s, device)
    adsorbates = samp.get("adsorbates") or sorted(set(bulk_st.symbols))
    spec, site_state0 = make_spec_sampling_surface_atoms(
        bulk_st, np.ones(len(bulk_st), dtype=bool), adsorbates, potential_numbers=numbers,
        cutoff=sys_s.get("cutoff", pot_cutoff),
        surface_name=sys_s.get("surface_name", bulk_st.formula + "_bulk"))
    se_fn = None
    if calc_s.get("offset", False):
        se_fn = make_offset_surface_energy(
            spec, calc_s.get("chem_pots", {}), calc_s["offset_data"],
            offset_units=calc_s.get("offset_units", "atomic"), device=device)
    run = MCMCRun(spec, potential, surface_energy_fn=se_fn, device=device,
                  relax=relax_config(calc_s))
    return AssembledSystem(spec, potential, run, settings), site_state0


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.cli.common import (
        add_device_arg,
        load_settings,
        load_slab,
        make_run_folder,
        run_sampling,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--settings", required=True)
    ap.add_argument("--bulk", required=True, help="bulk structure (.cif/.xyz/.npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-dir", default=None)
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="checkpoint.npz (or run folder) to resume from")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    settings = load_settings(args.settings)
    bulk_st = load_slab(args.bulk)
    sys_s = settings["system_settings"]
    sys_s["surface_name"] = sys_s.get("surface_name", bulk_st.formula + "_bulk")
    run_folder = make_run_folder(settings, sys_s["surface_name"], base_dir=args.base_dir)
    (run_folder / "settings.json").write_text(json.dumps(settings, indent=2, default=str))

    asys, site_state0 = build_bulk_system(settings, bulk_st, args.device)
    t0 = time.perf_counter()
    results = run_sampling(asys, run_folder, seed=args.seed, site_state0=site_state0,
                           resume=args.resume)
    print(f"Time taken = {time.perf_counter() - t0:.3f} seconds")
    print(f"Best energy: {results['best_energy']:.4f} eV -> {results['run_folder']}")


if __name__ == "__main__":
    main()
