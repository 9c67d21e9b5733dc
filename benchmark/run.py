"""One run of one benchmark cell of surface_sampling_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell is ``benchmark/workloads/<cell>.json``;
it names its configuration, ``benchmark/configs/<config>.json``. The run
builds the system through the port's entry points, warms up the cell's own
shapes on throwaway chains, then drives MC sweeps (one sweep a call of the
port's chain run, all chains from the empty surface, one
``torch.Generator`` seeded with ``--seed``) for ``--seconds``; the window
ends in ``torch.cuda.synchronize()``. After it, the plain reference
(``benchmark/reference/``) judges what the window produced: it replays the
first sweep of a sample of chains from the same draws and scores their
states (``benchmark/check.py``). With ``--trace 1`` a fixed number of
sweeps inside the window runs under ``torch.profiler`` and the cell's
per-layer metrics (``benchmark/metrics/<name>.py``) read it.

The last line of standard output is the result as one JSON object; the
numbers the check compared, each with its limit, are the last lines of
standard error. A run without a card, or without the port beside it,
exits with code 3 or 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "surface_sampling_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "surface_sampling_tpu_torch").is_dir():
        print(f"no surface_sampling_tpu_torch package beside {ROOT / 'benchmark'}",
              file=sys.stderr)
        return 2
    from benchmark import harness

    wl = harness.load_workload(args.workload)
    t = time.perf_counter()
    import torch

    pre = {"torch_import_s": time.perf_counter() - t}
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"the cell needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    pre["cuda_probe_s"] = time.perf_counter() - t
    result = harness.run_cell(wl, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_process=T_PROCESS, pre_split=pre)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
