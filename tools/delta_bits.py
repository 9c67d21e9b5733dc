#!/usr/bin/env python3
"""Where the delta engine's rows leave a fresh evaluation's, on one NVIDIA GPU.

    cd TREE && python3 PATH/TO/tools/delta_bits.py [--chains 128]

Measures the port package of the working directory (put first on
``sys.path``; it builds its kernels into its own ``_build/``): the 2x2
flagship's delta engine (``core/incremental.py``) on ``chip_smoke.py``'s
crowded occupancies of ``[inc-canonical]`` (a quarter of the sites occupied,
seed 38) and one canonical draw. The one-site delta (site 1 takes site 2's
code) and the two-site delta (the exchange) run against a fresh
``energy_full`` of the same trial state, and their caches are compared row by
row in the engine's order: s, phi and vcat of each layer, then e_atom. It
prints max |delta - fresh| of each tensor, the first tensor whose rows
differ, and the energies' max difference. The last line is the whole result
as JSON.

Parent against change in one call (trees under a directory .gitignore lists):

    git archive HEAD | tar -x -C _archive/parent
    (cd _archive/parent && python3 ../../tools/delta_bits.py)
    python3 tools/delta_bits.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def compare(engine, ss, gen) -> dict:
    """Max |delta - fresh| of every cache tensor and of the energies, for
    the one- and the two-site delta of one canonical draw."""
    import torch
    from surface_sampling_tpu_torch.core.events import canonical_draws, pick_exchange
    from surface_sampling_tpu_torch.core.state import change_site, exchange_sites

    st = engine.init_state(ss)
    g_t, g1, g2, _ = canonical_draws(gen, ss.shape[0], engine.n_sites, engine.n_codes)
    s1, s2, _ = pick_exchange(ss, engine.n_codes, g_t, g1, g2)
    out = {}
    for tag, trial, sites in (
            ("one-site", change_site(ss, s1, torch.gather(ss, 1, s2[:, None])[:, 0]), s1[:, None]),
            ("two-site", exchange_sites(ss, s1, s2), torch.stack([s1, s2], 1))):
        e_fresh, fresh, _ = engine.energy_full(trial)
        e_delta, delta, _ = engine.delta(st.caches, trial, sites)
        diffs, first = {}, None
        for name in ("s", "phi", "vcat"):
            for li, (a, b) in enumerate(zip(getattr(delta, name), getattr(fresh, name))):
                diffs[f"{name}[{li}]"] = float((a - b).abs().max())
        diffs["e_atom"] = float((delta.e_atom - fresh.e_atom).abs().max())
        order = [f"{n}[{li}]" for li in range(len(delta.s)) for n in ("s", "phi", "vcat")]
        for key in order + ["e_atom"]:
            if diffs[key] != 0.0:
                first = key
                break
        out[tag] = {"energy": float((e_delta - e_fresh).abs().max()),
                    "max_abs_energy": float(e_fresh.abs().max()),
                    "first_differing": first, "tensors": diffs}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=128)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("delta_bits: no CUDA device is available", file=sys.stderr)
        return 1
    from surface_sampling_tpu_torch.core.engine import make_generator
    from surface_sampling_tpu_torch.core.incremental import make_incremental_painn_from_system
    from surface_sampling_tpu_torch.ops.cuda_build import build_kernels
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    build_kernels()
    dev = torch.device("cuda")
    sys2 = srtio3_001_painn(supercell=(2, 2), device=dev)
    engine = make_incremental_painn_from_system(sys2)
    rng = np.random.default_rng(38)
    ss = rng.integers(0, sys2.spec.n_codes, (args.chains, sys2.spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
    result = {"tree": os.getcwd(), "chains": args.chains,
              "deltas": compare(engine, ss, make_generator(0, dev))}
    for tag, r in result["deltas"].items():
        print(f"[delta-bits] {tag}: max |delta - fresh| {r['energy']:.3e} eV "
              f"(|E| up to {r['max_abs_energy']:.1f}); first differing tensor "
              f"{r['first_differing']}; {json.dumps(r['tensors'])}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
