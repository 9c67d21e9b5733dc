"""Batch slab cutting from bulk structures (scripts/cut_surfaces.py analog).

The counterpart of ``surface_sampling_tpu/cli/cut_surfaces.py`` (host
numpy, no device):

    python -m surface_sampling_tpu_torch.cli.cut_surfaces --bulk bulk.cif \\
        --miller 1 0 0 --size 2 2 --layers 4 --out slabs
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.structure import surface_from_bulk
    from surface_sampling_tpu_torch.structure.io import write_cif
    from surface_sampling_tpu_torch.utils.misc import load_structures_any

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bulk", required=True, nargs="+", help="bulk structure file(s)")
    ap.add_argument("--miller", type=int, nargs=3, default=[1, 0, 0])
    ap.add_argument("--size", type=int, nargs=2, default=[1, 1])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vacuum", type=float, default=15.0)
    ap.add_argument("--out", default="slabs")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    h, k, l = args.miller  # noqa: E741
    for f in args.bulk:
        for bulk_st in load_structures_any(f):
            slab, surf_mask = surface_from_bulk(bulk_st, (h, k, l), size=tuple(args.size),
                                                layers=args.layers, vacuum=args.vacuum)
            name = f"{slab.formula}_{h}{k}{l}_{args.size[0]}x{args.size[1]}x{args.layers}.cif"
            write_cif(out / name, slab)
            print(f"{name}: {len(slab)} atoms, {int(surf_mask.sum())} surface atoms")


if __name__ == "__main__":
    main()
