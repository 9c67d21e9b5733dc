"""Electrochemical VSSR-MC driver, on the card (the counterpart of
``surface_sampling_tpu/cli/sample_pourbaix_surface.py``).

Adds to sample_surface: the dominant species of each element from the
serialized phase and Pourbaix diagrams at (pH, phi), the Pourbaix grand
potential as the acceptance energy, optional surface-atom sampling
(existing surface atoms become exchangeable) and OH / H2O group moves.

calc_settings keys used here: phase_diagram (pd_dict.json path),
pourbaix_diagram (pbx_dict.json path), pH, phi, temperature,
adsorbate_corrections, elements; sampling_settings.sample_surface_atoms.

    python -m surface_sampling_tpu_torch.cli.sample_pourbaix_surface \\
        --settings config.json --slab slab.cif [--resume RUN] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time


def build_pourbaix_system(settings: dict, slab, device="cuda"):
    """The driver's system: the Pourbaix atoms of ``elements`` at (pH, phi),
    the potential, the spec (surface atoms made exchangeable with
    ``sample_surface_atoms``) and its start occupancy (None otherwise), and
    the Pourbaix energy. Returns (AssembledSystem, site_state0, atoms)."""
    from surface_sampling_tpu_torch.cli.common import (
        AssembledSystem,
        build_potential,
        relax_config,
    )
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.spec import make_spec, make_spec_sampling_surface_atoms
    from surface_sampling_tpu_torch.pourbaix import (
        generate_pourbaix_atoms,
        make_pourbaix_surface_energy,
    )
    from surface_sampling_tpu_torch.structure import find_adsorption_sites

    sys_s = settings["system_settings"]
    calc_s = settings["calc_settings"]
    samp = settings["sampling_settings"]
    surface_name = sys_s.get("surface_name", slab.formula)
    phi = float(calc_s.get("phi", 0.0))
    pH = float(calc_s.get("pH", 7.0))
    elements = calc_s.get("elements") or sorted(set(slab.symbols))
    pbx_atoms = generate_pourbaix_atoms(calc_s["phase_diagram"], calc_s["pourbaix_diagram"],
                                        phi, pH, elements)
    potential, numbers, pot_cutoff = build_potential(calc_s, sys_s, device)
    adsorbates = samp.get("adsorbates", ["HO", "H2O", "O", "H"])
    sites = find_adsorption_sites(
        slab,
        planar_distance=sys_s.get("planar_distance", 2.0),
        near_reduce=sys_s.get("near_reduce", 0.01),
        no_obtuse_hollow=sys_s.get("no_obtuse_hollow", True),
    )[sys_s.get("ads_site_type", "all")]

    site_state0 = None
    if samp.get("sample_surface_atoms", False):
        z = slab.positions[:, 2]
        surf_mask = (z.max() - z) < sys_s.get("surface_atom_tol", 1.2)
        spec, site_state0 = make_spec_sampling_surface_atoms(
            slab, surf_mask, adsorbates, potential_numbers=numbers,
            cutoff=sys_s.get("cutoff", pot_cutoff), extra_site_coords=sites,
            surface_depth=sys_s.get("surface_depth"), surface_name=surface_name)
    else:
        spec = make_spec(slab, sites, adsorbates, potential_numbers=numbers,
                         cutoff=sys_s.get("cutoff", pot_cutoff),
                         surface_depth=sys_s.get("surface_depth"), surface_name=surface_name)

    se_fn = make_pourbaix_surface_energy(
        spec, pbx_atoms, phi=phi, pH=pH, temp=float(calc_s.get("temperature", 0.0257)),
        adsorbate_corrections=calc_s.get("adsorbate_corrections"), device=device)
    run = MCMCRun(spec, potential, surface_energy_fn=se_fn, device=device,
                  relax=relax_config(calc_s))
    return AssembledSystem(spec, potential, run, settings), site_state0, pbx_atoms


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.cli.common import (
        add_device_arg,
        load_settings,
        load_slab,
        make_run_folder,
        run_sampling,
    )
    from surface_sampling_tpu_torch.pourbaix import save_pourbaix_atoms

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--settings", required=True)
    ap.add_argument("--slab", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-dir", default=None)
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="checkpoint.npz (or run folder) to resume from")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    settings = load_settings(args.settings)
    slab = load_slab(args.slab)
    sys_s = settings["system_settings"]
    sys_s["surface_name"] = sys_s.get("surface_name", slab.formula)
    run_folder = make_run_folder(settings, sys_s["surface_name"], base_dir=args.base_dir)
    (run_folder / "settings.json").write_text(json.dumps(settings, indent=2, default=str))

    asys, site_state0, pbx_atoms = build_pourbaix_system(settings, slab, args.device)
    save_pourbaix_atoms(run_folder / "pourbaix_atoms.json", pbx_atoms)
    t0 = time.perf_counter()
    results = run_sampling(asys, run_folder, seed=args.seed, site_state0=site_state0,
                           resume=args.resume)
    print(f"Time taken = {time.perf_counter() - t0:.3f} seconds")
    print(f"Best Pourbaix potential: {results['best_energy']:.4f} eV")
    print(f"Run folder: {results['run_folder']}")


if __name__ == "__main__":
    main()
