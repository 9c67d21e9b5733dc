"""The readings a cell's limits are set from: the program's compared
numbers and the control's on many seeds, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [--first <seed>]
        [--seconds <s>] [--out <file.json>]

The cell is set up once; each seed then runs a window of ``--seconds`` (the
cell's own load: its chains, sweep and schedule), the check on it, and the
control: the plain reference with its products in TF32, the precision below
the configuration's float32, on the same states (``benchmark/check.py``).
The lower reading of ``energy_gap_ev`` is the largest the program gives
over the seeds, the upper the smallest the control gives. The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def calibrate(wl: dict, seeds: list[int], seconds: float, device: str) -> dict:
    from benchmark.check import check_run
    from benchmark.harness import run_window, set_up

    su = set_up(wl, device, seeds[0])
    rows = []
    for seed in seeds:
        win = run_window(su, wl, seed, seconds, False)
        checks, seen = check_run(wl, seed, su.device, win.gen_start, win.after_first, win.final,
                                 control=True)
        rows.append({"seed": seed, "sweeps": win.sweeps,
                     "evals_per_s": win.evals / win.window_s,
                     **{k: v["value"] for k, v in checks.items()}, **seen})
        print(json.dumps(rows[-1]), flush=True)
    out = {"cell": wl["name"], "seconds": seconds, "runs": rows,
           "replay_mismatches": sum(r["replay_mismatches"] for r in rows)}
    for name in ("energy_gap_ev", "relaxed_gap_ev"):
        if name in rows[0]:
            out["lower_" + name] = max(r[name] for r in rows)
            out["upper_" + name] = min(r["control_" + name] for r in rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from benchmark.harness import load_workload

    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    out = calibrate(load_workload(args.workload), seeds, args.seconds, "cuda")
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
