"""Filter structures by per-element stoichiometry ranges
(scripts/filter_stoichiometries.py analog; the counterpart of
``surface_sampling_tpu/cli/filter_stoichiometries.py``, host only).

Ranges are given as JSON: {"O": [0, 12], "Sr": [2, 8]} — inclusive counts:

    python -m surface_sampling_tpu_torch.cli.filter_stoichiometries \\
        --structures S.npz --ranges '{"O": [0, 12]}' --out filtered.npz
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path


def in_ranges(symbols, ranges: dict) -> bool:
    counts = Counter(symbols)
    return all(lo <= counts.get(el, 0) <= hi for el, (lo, hi) in ranges.items())


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.structure.io import save_structures_npz
    from surface_sampling_tpu_torch.utils.misc import load_structures_any

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--structures", required=True, nargs="+")
    ap.add_argument("--ranges", required=True, help="JSON dict or path to one")
    ap.add_argument("--out", default="filtered.npz")
    args = ap.parse_args(argv)

    if Path(args.ranges).exists():
        ranges = json.loads(Path(args.ranges).read_text())
    else:
        ranges = json.loads(args.ranges)

    structures = []
    for f in args.structures:
        structures.extend(load_structures_any(f))
    kept = [st for st in structures if in_ranges(st.symbols, ranges)]
    save_structures_npz(args.out, kept)
    print(f"Kept {len(kept)}/{len(structures)} structures -> {args.out}")


if __name__ == "__main__":
    main()
