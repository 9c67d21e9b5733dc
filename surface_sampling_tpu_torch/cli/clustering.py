"""Latent-space clustering from the command line (scripts/clustering.py analog), on the card.

The counterpart of ``surface_sampling_tpu/cli/clustering.py``. Loads
sampled structures, computes each one's embedding (the network's final
scalar features, member-mean for an ensemble, pooled over its atoms) and a
selection metric (energy | force_std | gmm | random) with one forward per
structure over its own image shifts, clusters (PCA + Ward, on the host) and
saves one representative per cluster:

    python -m surface_sampling_tpu_torch.cli.clustering --structures S.npz \\
        --settings calc.json --metric gmm --criterion maxclust --cutoff 8 \\
        --out clustering_out [--device cuda|cpu]

Writes ``clustered.npz`` (the representatives, their metric values as
energies) and ``clustering.npz`` (embeddings, labels, metrics, selected)
under ``--out``. The ``gmm`` metric always fits by the torch EM
(``analysis.uncertainty.fit_gmm_em``) on the run's device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def compute_embeddings_and_metric(structures, calc_settings: dict, metric: str,
                                  device: str | torch.device = "cuda"):
    """(embeddings (B, F), metric values (B,)) as numpy arrays: per-structure
    mean-pooled embeddings plus the metric (reference:
    scripts/clustering.py:236-257, calculators.py:34-135). ``energy`` is
    the output's energy in the model's units; ``force_std`` reads the
    ensemble's ``energy_std``, as the JAX package does; ``gmm`` the NLL
    under an 8-component (at most) EM fit of the embeddings; ``random``
    draws from ``default_rng(0)``."""
    from surface_sampling_tpu_torch.analysis import GMMUncertainty
    from surface_sampling_tpu_torch.cli.common import build_potential
    from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for

    pot, numbers, cutoff = build_potential(calc_settings, {}, device)
    dev = torch.device(device)
    z_to_type = {int(z): t for t, z in enumerate(numbers)}

    embs, metrics = [], []
    with torch.no_grad():
        for st in structures:
            shifts = torch.as_tensor(pair_shifts_for(st.cell, st.scaled_positions, cutoff),
                                     dtype=torch.float32, device=dev)
            pos = torch.as_tensor(np.asarray(st.positions, np.float32), device=dev)[None]
            ti = torch.as_tensor([z_to_type.get(int(z), 0) for z in st.numbers],
                                 dtype=torch.int64, device=dev)[None]
            out = pot.outputs(pos, ti, torch.ones_like(ti, dtype=torch.bool), shifts)
            embs.append(out["embedding"][0].mean(dim=0))     # mean-pool atoms
            if metric == "energy":
                metrics.append(out["energy"][0])
            elif metric == "force_std" and "energy_std" in out:
                metrics.append(out["energy_std"][0])
            else:
                metrics.append(torch.zeros((), device=dev))
    embeddings = torch.stack(embs)
    if metric == "gmm":
        gu = GMMUncertainty(n_components=min(8, len(embs)))
        gu.fit_gmm(embeddings, method="em")
        metric_t = gu.get_uncertainty(embeddings)
    else:
        metric_t = torch.stack(metrics).to(torch.float64)
    embeddings, metric_values = embeddings.cpu().numpy(), metric_t.cpu().numpy()
    if metric == "random":
        metric_values = np.random.default_rng(0).random(len(embeddings))
    return embeddings, metric_values


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.analysis import perform_clustering, select_data_and_save
    from surface_sampling_tpu_torch.cli.common import add_device_arg, load_calc_settings
    from surface_sampling_tpu_torch.utils.misc import load_structures_any

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--structures", required=True, nargs="+",
                    help="structure files (.npz bundles, .cif, .xyz, .txt list)")
    ap.add_argument("--settings", required=True, help="JSON with calc_settings")
    ap.add_argument("--cutoff", type=float, default=0.5,
                    help="clustering cutoff (distance or maxclust)")
    ap.add_argument("--criterion", choices=["distance", "maxclust"], default="maxclust")
    ap.add_argument("--metric", choices=["force_std", "energy", "gmm", "random"],
                    default="force_std")
    ap.add_argument("--out", default="clustering_out")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    calc_settings = load_calc_settings(args.settings)
    structures = []
    for f in args.structures:
        structures.extend(load_structures_any(f))
    print(f"Loaded {len(structures)} structures")

    embeddings, metrics = compute_embeddings_and_metric(structures, calc_settings,
                                                        args.metric, args.device)
    labels = perform_clustering(embeddings, args.cutoff, args.criterion)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    idx = select_data_and_save(structures, labels, metrics, args.metric, save_folder=out)
    np.savez_compressed(out / "clustering.npz", embeddings=embeddings,
                        labels=labels, metrics=metrics, selected=idx)
    print(f"{len(np.unique(labels))} clusters; selected {len(idx)} structures -> {out}")


if __name__ == "__main__":
    main()
