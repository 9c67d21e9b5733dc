"""Gas / vacuum VSSR-MC run driver, on the card (the counterpart of
``surface_sampling_tpu/cli/sample_surface.py``).

Usage:
    python -m surface_sampling_tpu_torch.cli.sample_surface --settings config.json \\
        --slab slab.cif [--seed 0] [--resume RUN] [--device cuda|cpu]

The settings JSON is the three-section schema of ``cli/common.py``. A copy
of the merged settings is written into the run folder.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.cli.common import (
        add_device_arg,
        assemble_system,
        load_settings,
        load_slab,
        make_run_folder,
        run_sampling,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--settings", required=True, help="three-section JSON settings file")
    ap.add_argument("--slab", required=True, help="pristine slab (.cif/.xyz/.npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-dir", default=None, help="base directory for run folders")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="checkpoint.npz (or run folder) to resume from; total_sweeps is the "
                         "full target, only the remaining sweeps run (exact continuation, the "
                         "generator state included)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    settings = load_settings(args.settings)
    slab = load_slab(args.slab)
    surface_name = settings["system_settings"].get("surface_name", slab.formula)
    settings["system_settings"]["surface_name"] = surface_name
    run_folder = make_run_folder(settings, surface_name, base_dir=args.base_dir)
    (run_folder / "settings.json").write_text(json.dumps(settings, indent=2, default=str))

    asys = assemble_system(settings, slab, device=args.device)
    t0 = time.perf_counter()
    results = run_sampling(asys, run_folder, seed=args.seed, resume=args.resume)
    print(f"Time taken = {time.perf_counter() - t0:.3f} seconds")
    print(f"Best surface energy: {results['best_energy']:.4f} eV")
    print(f"Run folder: {results['run_folder']}")


if __name__ == "__main__":
    main()
