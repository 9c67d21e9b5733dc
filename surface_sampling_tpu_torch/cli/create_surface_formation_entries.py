"""Create surface formation-energy entries for Pourbaix analysis
(scripts/create_surface_formation_entries.py analog), on the card.

The counterpart of
``surface_sampling_tpu/cli/create_surface_formation_entries.py``. Computes
NN (or classical) energies of sampled surfaces — optionally after a FIRE
relaxation on the device (reference --relax/optimize_slab) — applies
composition-based energy corrections, subtracts elemental reference
energies from a phase diagram, and writes a JSON list of entries with the
JAX package's keys, in its order:

    python -m surface_sampling_tpu_torch.cli.create_surface_formation_entries \\
        --structures S.cif --settings calc.json --phase-diagram pd_dict.json \\
        [--relax] [--mp2020] [--aqueous] [--oh-correction] \\
        [--oxide-correction [EV_PER_O]] [--device cuda|cpu]

Corrections (all opt-in, mirroring the reference's pipeline,
scripts/create_surface_formation_entries.py:305-323,394-399):
  * --mp2020: the MaterialsProject2020Compatibility scheme as explicit
    tables (``pourbaix.compatibility.MP2020Compatibility``).
  * --aqueous: the MaterialsProjectAqueousCompatibility hydrogen
    re-reference (``AqueousCompatibility``).
  * --oh-correction: SurfaceOHCompatibility ZPE-TS (+0.23 eV/OH) and
    hydrogen-bond (-0.30 eV/OH) terms.
  * --oxide-correction [EV_PER_O]: legacy single per-O constant.

Each entry records GGA+U metadata (run_type, hubbards) and the itemized
corrections applied.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

import numpy as np
import torch

# reference create_surface_formation_entries.py:42-49
DFT_U_VALUES = {"La": 0.0, "Mn": 3.9, "Pt": 0.0, "O": 0.0, "Ir": 0.0, "H": 0.0}
MP2020_OXIDE_CORRECTION = -0.687  # eV per O (MP2020 anion correction, oxides)


def main(argv=None) -> None:
    from surface_sampling_tpu_torch.cli.common import (
        add_device_arg,
        build_potential,
        load_calc_settings,
    )
    from surface_sampling_tpu_torch.core.relax import FireConfig, fire_relax
    from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for
    from surface_sampling_tpu_torch.pourbaix import PhaseDiagramLite, SurfaceOHCompatibility
    from surface_sampling_tpu_torch.pourbaix.compatibility import (
        MP_U_VALUES,
        AqueousCompatibility,
        MP2020Compatibility,
    )
    from surface_sampling_tpu_torch.utils.misc import load_structures_any

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--structures", required=True, nargs="+")
    ap.add_argument("--settings", required=True, help="JSON with calc_settings")
    ap.add_argument("--phase-diagram", required=True, help="pd_dict.json for element refs")
    ap.add_argument("--mp2020", action="store_true",
                    help="apply the full MP2020 anion + GGA/GGA+U corrections")
    ap.add_argument("--aqueous", action="store_true",
                    help="apply the aqueous-compatibility hydrogen re-reference")
    ap.add_argument("--oh-correction", action="store_true",
                    help="apply SurfaceOHCompatibility corrections")
    ap.add_argument("--oxide-correction", nargs="?", type=float,
                    const=MP2020_OXIDE_CORRECTION, default=None, metavar="EV_PER_O",
                    help="MP2020-style per-O anion correction "
                         f"(default {MP2020_OXIDE_CORRECTION} eV/O when given bare)")
    ap.add_argument("--relax", action="store_true",
                    help="FIRE-relax each structure before the energy evaluation")
    ap.add_argument("--relax-steps", type=int, default=20)
    ap.add_argument("--fmax", type=float, default=0.01)
    ap.add_argument("--out", default="surface_formation_entries.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    pot, numbers, cutoff = build_potential(load_calc_settings(args.settings), {}, args.device)
    dev = torch.device(args.device)
    z_to_type = {int(z): t for t, z in enumerate(numbers)}
    pd = PhaseDiagramLite.from_mson(args.phase_diagram)
    compat = SurfaceOHCompatibility()
    mp2020 = MP2020Compatibility() if args.mp2020 else None
    aqueous = AqueousCompatibility() if args.aqueous else None
    fcfg = FireConfig(steps=args.relax_steps, fmax=args.fmax)

    structures = []
    for f in args.structures:
        structures.extend(load_structures_any(f))

    entries = []
    for st in structures:
        shifts = torch.as_tensor(pair_shifts_for(st.cell, st.scaled_positions, cutoff),
                                 dtype=torch.float32, device=dev)
        ti = torch.as_tensor([z_to_type.get(int(z), 0) for z in st.numbers],
                             dtype=torch.int64, device=dev)[None]
        alive = torch.ones_like(ti, dtype=torch.bool)
        pos = torch.as_tensor(np.asarray(st.positions, np.float32), device=dev)[None]
        if args.relax:
            pos = fire_relax(lambda p: pot.energy(p, ti, alive, shifts), pos, alive,
                             fcfg).positions
        with torch.no_grad():
            e = float(pot.energy(pos, ti, alive, shifts)[0])
        comp = dict(Counter(st.symbols))
        hubbards = {el: DFT_U_VALUES.get(el, MP_U_VALUES.get(el, 0.0)) for el in comp}
        applied = []
        if mp2020 is not None:
            for label, v in mp2020.get_adjustments(comp, structure=st, hubbards=hubbards):
                e += v
                applied.append({"label": label, "value": v})
        if aqueous is not None and comp.get("H", 0) > 0:
            v = comp["H"] * aqueous.h_correction(pd.el_refs.get("H", 0.0))
            e += v
            applied.append({"label": "aqueous H re-reference", "value": v})
        if args.oh_correction:
            v = compat.get_adjustment(comp)
            e += v
            applied.append({"label": "surface OH (ZPE-TS + H-bond)", "value": v})
        if args.oxide_correction is not None:
            v = args.oxide_correction * comp.get("O", 0)
            e += v
            applied.append({"label": "legacy per-O", "value": v})
        e_form = e - sum(n * pd.el_refs[el] for el, n in comp.items() if el in pd.el_refs)
        entries.append({
            "composition": comp,
            "energy": e,
            "formation_energy": e_form,
            "corrections": applied,
            "parameters": {
                "run_type": "GGA+U",
                "is_hubbard": True,
                "hubbards": hubbards,
            },
        })

    Path(args.out).write_text(json.dumps(entries, indent=1))
    print(f"Wrote {len(entries)} entries -> {args.out}")


if __name__ == "__main__":
    main()
