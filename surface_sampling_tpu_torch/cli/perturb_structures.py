"""Random rattle of structures +/- lattice, with optional energies of the
perturbed structures on the card (scripts/perturb_structures.py analog; the
counterpart of ``surface_sampling_tpu/cli/perturb_structures.py``):

    python -m surface_sampling_tpu_torch.cli.perturb_structures \\
        --structures S.cif --amplitude 0.1 --n-perturb 4 \\
        [--settings calc.json [--device cuda|cpu]] --out perturbed

The rattle draws from ``np.random.default_rng(--seed)`` as the JAX package
does, so both write the same positions; ``--settings`` adds each perturbed
structure's energy (edges by image search) to ``perturbed.npz``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def make_energy_fn(calc_settings: dict, device: str | torch.device = "cuda"):
    """structure -> its potential energy in eV, evaluated on ``device``
    over the structure's own image shifts."""
    from surface_sampling_tpu_torch.cli.common import build_potential
    from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for

    pot, numbers, cutoff = build_potential(calc_settings, {}, device)
    dev = torch.device(device)
    z_to_type = {int(z): t for t, z in enumerate(numbers)}

    def energy_fn(st) -> float:
        shifts = torch.as_tensor(pair_shifts_for(st.cell, st.scaled_positions, cutoff),
                                 dtype=torch.float32, device=dev)
        pos = torch.as_tensor(np.asarray(st.positions, np.float32), device=dev)[None]
        ti = torch.as_tensor([z_to_type.get(int(z), 0) for z in st.numbers],
                             dtype=torch.int64, device=dev)[None]
        with torch.no_grad():
            return float(pot.energy(pos, ti, torch.ones_like(ti, dtype=torch.bool), shifts)[0])

    return energy_fn


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.cli.common import add_device_arg, load_calc_settings
    from surface_sampling_tpu_torch.structure.io import save_structures_npz
    from surface_sampling_tpu_torch.utils.misc import load_structures_any, randomize_structure

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--structures", required=True, nargs="+")
    ap.add_argument("--amplitude", type=float, default=0.1)
    ap.add_argument("--n-perturb", type=int, default=1, help="perturbations per structure")
    ap.add_argument("--displace-lattice", action="store_true")
    ap.add_argument("--settings", default=None, help="JSON with calc_settings for energies")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="perturbed")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    structures = []
    for f in args.structures:
        structures.extend(load_structures_any(f))
    energy_fn = (make_energy_fn(load_calc_settings(args.settings), args.device)
                 if args.settings else None)

    rng = np.random.default_rng(args.seed)
    out_structures, energies = [], []
    for st in structures:
        for _ in range(args.n_perturb):
            p = randomize_structure(st, args.amplitude, args.displace_lattice, rng=rng)
            out_structures.append(p)
            energies.append(energy_fn(p) if energy_fn else np.nan)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    save_structures_npz(out / "perturbed.npz", out_structures, energies)
    print(f"Wrote {len(out_structures)} structures -> {out / 'perturbed.npz'}")


if __name__ == "__main__":
    main()
