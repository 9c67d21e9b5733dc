"""Batched prediction driver: energies, forces and ensemble spread over a
set of structures, on the card (the counterpart of
``surface_sampling_tpu/cli/predict.py``; PaiNN embeddings through
``models.prediction.get_prediction``).

Evaluates any calc_settings-buildable potential (EAM, Tersoff, SW, PaiNN,
CHGNet, MACE; NN ensembles included) on each structure, with its edges
found by image search, and writes one npz:

    energies (B,), energy_std (B,; 0 unless an NN ensemble),
    forces (B, N_max, 3) zero-padded, n_atoms (B,),
    embeddings (B, F) mean-pooled per structure (NN families, --embeddings)

With ``--labels labelled.json`` (the same frame order; read by
``models.dataset.load_labelled_structures``) it also writes the energy and
force mean absolute errors to metrics.json beside the npz.

    python -m surface_sampling_tpu_torch.cli.predict --structures run/*.cif \\
        --settings settings.json --out predictions.npz [--embeddings] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.cli.common import add_device_arg, build_potential, load_settings
    from surface_sampling_tpu_torch.models.nn_calculator import PaiNNPotential
    from surface_sampling_tpu_torch.models.prediction import get_prediction
    from surface_sampling_tpu_torch.models.train import pad_structures
    from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for
    from surface_sampling_tpu_torch.utils.misc import load_structures_any

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--structures", required=True, nargs="+",
                    help="structure files (.cif/.xyz/.npz/.txt lists)")
    ap.add_argument("--settings", required=True, help="JSON with calc_settings")
    ap.add_argument("--out", default="predictions.npz")
    ap.add_argument("--embeddings", action="store_true",
                    help="also store mean-pooled per-structure embeddings (NN families)")
    ap.add_argument("--labels", default=None,
                    help="labelled dataset (JSON list / npz) with energies and forces in the "
                         "same frame order -> metrics.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    settings = load_settings(args.settings)
    structures = []
    for f in args.structures:
        structures.extend(load_structures_any(f))
    if not structures:
        raise SystemExit("no structures loaded")

    pot, numbers, cutoff = build_potential(settings["calc_settings"],
                                           settings.get("system_settings", {}), args.device)
    dev = torch.device(args.device)
    z_to_type = {int(z): t for t, z in enumerate(numbers)}
    n_max = max(len(s) for s in structures)

    energies, stds, n_atoms, forces, embs = [], [], [], [], []
    for st in structures:
        shifts = torch.as_tensor(pair_shifts_for(st.cell, st.scaled_positions, cutoff),
                                 dtype=torch.float32, device=dev)
        pos = torch.as_tensor(np.asarray(st.positions, np.float32), device=dev)[None]
        ti = torch.as_tensor([z_to_type.get(int(z), 0) for z in st.numbers],
                             dtype=torch.int64, device=dev)[None]
        alive = torch.ones_like(ti, dtype=torch.bool)
        e, f = pot.energy_and_forces(pos, ti, alive, shifts)
        energies.append(float(e[0]))
        n_atoms.append(len(st))
        fp = np.zeros((n_max, 3))
        fp[: len(st)] = f[0].cpu().numpy()
        forces.append(fp)
        std = 0.0
        if hasattr(pot, "outputs"):
            with torch.no_grad():
                out = pot.outputs(pos, ti, alive, shifts)
            if "energy_std" in out:
                std = float(out["energy_std"][0])
        if args.embeddings and isinstance(pot, PaiNNPotential):
            # the member-mean final scalar features, pooled over the atoms
            batch = pad_structures([st], [0.0], [np.zeros((len(st), 3))], cutoff)
            pred = get_prediction(pot.params, pot.cfg, batch, ensemble=True)
            embs.append(pred["embedding"][0].cpu().numpy().mean(axis=0))
        stds.append(std)

    arrays = dict(energies=np.asarray(energies), energy_std=np.asarray(stds),
                  forces=np.stack(forces), n_atoms=np.asarray(n_atoms, np.int32))
    if embs:
        arrays["embeddings"] = np.stack(embs)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)

    if args.labels:
        from surface_sampling_tpu_torch.models.dataset import load_labelled_structures

        _, e_ref, f_ref = load_labelled_structures(args.labels)
        if len(e_ref) != len(structures):
            raise SystemExit(f"--labels has {len(e_ref)} frames, inputs have "
                             f"{len(structures)}")
        err = np.abs(arrays["energies"] - np.asarray(e_ref))
        f_err = [float(np.mean(np.abs(arrays["forces"][i, :n] - np.asarray(f_ref[i]))))
                 for i, n in enumerate(n_atoms)]
        metrics = {
            "energy_mae_eV": float(np.mean(err)),
            "energy_mae_meV_per_atom": float(np.mean(err / np.asarray(n_atoms))) * 1e3,
            "force_mae_eV_A": float(np.mean(f_err)),
            "n_frames": len(structures),
        }
        out.with_name("metrics.json").write_text(json.dumps(metrics, indent=2))
        print(json.dumps(metrics))

    print(f"Wrote {out} ({len(structures)} structures, "
          f"mean E = {np.mean(arrays['energies']):.4f} eV)")


if __name__ == "__main__":
    main()
