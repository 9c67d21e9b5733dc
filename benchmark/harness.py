"""The harness behind ``benchmark/run.py``: builds a cell from its files,
times the window, traces it and hands the result to the check.

Everything that belongs to one cell, configuration or per-layer metric is
data or a file of its own, found by name: ``workloads/<cell>.json``,
``configs/<config>.json`` and ``metrics/<metric>.py`` (a ``read(ctx)``
that returns the value, or None where the cell gives it nothing to read).
The entries of ``BENCHMARK.json`` say which metrics a cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_workload(name: str) -> dict:
    """The cell ``name``: its workload file with its configuration file
    under ``"config_file"`` and its entry of ``BENCHMARK.json`` (chips)."""
    path = BENCH / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload file {path}")
    wl = load_json(path)
    wl["name"] = name
    wl["config_file"] = load_json(BENCH / "configs" / f"{wl['config']}.json")
    entry = next((w for w in benchmark_spec()["workloads"] if w["name"] == name), None)
    wl["chips"] = entry["chips"] if entry else 1
    return wl


def listed_cells() -> list[str]:
    """Every cell that has a workload file."""
    return sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


def metrics_of(cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries of BENCHMARK.json that
    this cell reports."""
    return [m for m in benchmark_spec()[kind] if cell in m.get("workloads", [cell])]


def metric_reader(name: str) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def temperatures(schedule: dict, n: int) -> list[float]:
    """T_i = max(start * alpha^i, t_min) for sweeps 0..n-1."""
    return [max(schedule["start_temp"] * schedule["alpha"] ** i, schedule.get("t_min", 0.0))
            for i in range(n)]


class Recorder:
    """Occupancies the program evaluates, kept while ``on``: the inputs of
    the work counts of a traced window."""

    def __init__(self):
        self.on, self.states, self.force_calls = False, [], 0

    def wrap(self, fn: Callable) -> Callable:
        def recorded(site_state, *args):
            if self.on:
                self.states.append(site_state)
            return fn(site_state, *args)

        return recorded

    def count(self, fn: Callable) -> Callable:
        def counted(*args, **kwargs):
            self.force_calls += self.on
            return fn(*args, **kwargs)

        return counted


class Cell(NamedTuple):
    """A built cell: ``fresh()`` the chains at the start of a campaign,
    ``crun(state, temps, gen)`` one call of the port's chain run, the
    system's spec, and the recorder of what the run evaluates."""

    fresh: Callable
    crun: Callable
    spec: object
    recorder: Recorder


def _from_settings(wl: dict, device):
    """The campaign settings file and slab that the workload's ``system``
    names, through ``cli.common.assemble_system``, once the settings (with
    the cell's ``overrides``) agree with the cell's chains, sweep,
    criterion, filter and schedule."""
    from surface_sampling_tpu_torch.cli.common import assemble_system, load_settings, load_slab

    sys_spec = wl["system"]
    settings = load_settings(ROOT / sys_spec["settings"])
    samp = settings["sampling_settings"]
    samp.update(sys_spec.get("overrides", {}))
    ours = {"sweep_size": wl["sweep_size"], "criterion": wl["criterion"], "n_chains": wl["chains"],
            "filter_distance": wl["filter_distance"], **wl["schedule"]}
    differ = {k: (samp.get(k), v) for k, v in ours.items() if samp.get(k) != v}
    if differ:
        raise RuntimeError(f"the campaign's settings (with the cell's overrides) differ "
                           f"from the cell's in {differ}")
    return assemble_system(settings, load_slab(ROOT / sys_spec["slab"]), device=device)


def _from_builder(wl: dict, device):
    """``systems.<builder>(**args)``, FIRE-relaxed as the cell's ``relax``
    says on the relaxed engine."""
    from surface_sampling_tpu_torch import systems

    args = dict(wl["system"].get("args", {}))
    if wl["engine"] == "relaxed":
        from surface_sampling_tpu_torch.core.energy import RelaxConfig

        fire = wl["relax"]
        args["relax"] = RelaxConfig(steps=fire["steps"], fmax=fire["fmax"],
                                    max_step=fire["max_step"])
    return getattr(systems, wl["system"]["builder"])(device=device, **args)


def _check_fire(wl: dict, relax) -> None:
    """The program's relaxation (``relax``, a RelaxConfig or None) and its
    FIRE constants agree with the cell's: none on the rigid engine, its
    ``relax`` on the relaxed one."""
    from surface_sampling_tpu_torch.core.relax import FireConfig

    fire = wl["relax"] if wl["engine"] == "relaxed" else None
    if (fire is None) != (relax is None):
        raise RuntimeError(f"the program relaxes {relax}, the cell {fire}")
    if fire is None:
        return
    ours = {**FireConfig()._asdict(), "steps": relax.steps, "fmax": relax.fmax,
            "max_step": relax.max_step, "method": relax.method}
    fire = {"method": "fire", **fire}
    differ = {k: (v, fire[k]) for k, v in ours.items() if fire[k] != v}
    if differ:
        raise RuntimeError(f"the program's FIRE differs from the cell's in {differ}")


def build_cell(wl: dict, device) -> Cell:
    """The system and the run the workload names, through the port's
    entry points: a campaign's settings file through
    ``cli.common.assemble_system`` (``system.settings`` and ``.slab``) with
    any engine, or ``systems.<builder>(**args)`` with the full-evaluation
    engines; ``make_run_fn`` runs the full evaluation, the incremental
    step the delta engine."""
    import torch

    from surface_sampling_tpu_torch.core.engine import EngineConfig, make_run_fn
    from surface_sampling_tpu_torch.parallel.chains import chain_states, make_chain_run

    C, sys_spec, rec = wl["chains"], wl["system"], Recorder()
    criterion = wl["criterion"]
    filt = float(wl.get("filter_distance") or 1.5)
    if wl["engine"] not in ("delta", "rigid", "relaxed"):
        raise ValueError(f"unknown engine {wl['engine']!r}")
    if "settings" in sys_spec:
        system = _from_settings(wl, device)
    elif wl["engine"] == "delta":
        raise ValueError("the delta engine takes a campaign's settings file")
    else:
        system = _from_builder(wl, device)
    if wl["engine"] == "delta":
        from surface_sampling_tpu_torch.core.incremental import (
            make_incremental_painn,
            make_incremental_run,
            make_incremental_semigrand_step,
        )

        inc = vars(system.potential)["inc_args"]
        d = system.run.d
        engine = make_incremental_painn(inc["spec"], d, system.potential, inc["static_nbr"],
                                        inc["band"], inc["surface_energy_fn"])
        step = make_incremental_semigrand_step(engine, d=d, criterion=criterion,
                                               filter_distance=filt)
        crun = make_chain_run(make_incremental_run(step, wl["sweep_size"], engine.n_sites,
                                                   engine.n_codes))

        def fresh():
            return engine.init_state(torch.zeros((C, engine.n_sites), dtype=torch.int64,
                                                 device=d.device))

        return Cell(fresh, crun, system.spec, rec)
    _check_fire(wl, system.run.relax)
    if wl["engine"] == "relaxed":
        pot = system.potential
        pot.energy_with_edges = rec.count(pot.energy_with_edges)
    d, se_fn = system.run.d, system.run.state_energy_fn
    cfg = EngineConfig(sweep_size=wl["sweep_size"], criterion=criterion, filter_distance=filt,
                       record_positions=False)
    crun = make_chain_run(make_run_fn(d, rec.wrap(se_fn), cfg))

    def fresh():
        st = chain_states(d, C)
        first = se_fn(st.site_state)
        return st._replace(energy=first.surface_energy, relaxed_positions=first.positions)

    return Cell(fresh, crun, system.spec, rec)


def lattice_matches(spec, path: Path) -> list[str]:
    """The fields where the program's spec differs from the cell's frozen
    lattice (the one the reference realises states on)."""
    import numpy as np

    with np.load(path) as z:
        pairs = {"pristine_numbers": spec.pristine_numbers,
                 "pristine_positions": spec.pristine_positions,
                 "site_coords": spec.site_coords, "code_numbers": spec.code_numbers,
                 "code_offsets": spec.code_offsets, "cell": spec.cell,
                 "frozen": spec.frozen_pristine}
        return [k for k, v in pairs.items()
                if z[k].shape != np.shape(v) or not np.allclose(z[k], v, rtol=0, atol=1e-6)]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class TraceSummary(NamedTuple):
    """What the profiled sweeps left: device kernels (name, start us,
    duration us), the wall seconds of the profiled block, its MC steps and
    evaluations, the device seconds inside each ``record_function`` range,
    the occupancies evaluated, the port's launch counts, and the host's
    operations (name, start us, end us)."""

    kernels: list
    window_s: float
    steps: int
    evals: int
    ranges: dict
    states: list
    launches: dict
    host_ops: list


def _launch_counts() -> dict:
    from surface_sampling_tpu_torch.ops import chgnet_kernels, eam_kernels, painn_kernels

    out = {}
    for mod in (painn_kernels, chgnet_kernels, eam_kernels):
        out.update(mod.launch_counts())
    return out


def summarise_profile(prof, window_s: float, steps: int, evals: int, states: list,
                      launches: dict) -> TraceSummary:
    """Device operations and, for each ``record_function`` range of the
    program, the device seconds of the operations that ran inside its span
    on the device timeline."""
    from bisect import bisect_right

    from torch.autograd import DeviceType

    kernels, spans, host = [], {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            host.append((ev.name, float(ev.time_range.start), float(ev.time_range.end)))
            continue
        start, dur = float(ev.time_range.start), float(ev.time_range.end - ev.time_range.start)
        if getattr(ev, "is_user_annotation", False) or ev.name.startswith(("chgnet.", "painn.")):
            spans.setdefault(ev.name, []).append((start, start + dur))
        else:
            kernels.append((ev.name, start, dur))
    ranges = {}
    for name, iv in spans.items():
        iv.sort()
        starts = [a for a, _ in iv]
        inside = 0.0
        for _, start, dur in kernels:
            k = bisect_right(starts, start) - 1
            if k >= 0 and start < iv[k][1]:
                inside += dur
        ranges[name] = 1e-6 * inside
    return TraceSummary(kernels, window_s, steps, evals, ranges, states, launches, host)


def busy_seconds(kernels: list) -> float:
    """Seconds in which some device operation ran (the union of their
    intervals)."""
    busy, end = 0.0, -math.inf
    for _, start, dur in sorted(kernels, key=lambda k: k[1]):
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return 1e-6 * busy


def breakdown(trace: TraceSummary) -> dict:
    """The ten device operations that took the most time, and the ten
    longest idle gaps of the device, each named by the innermost host
    operation running when the gap began."""
    by_name: dict = {}
    for name, _, dur in trace.kernels:
        by_name[name] = by_name.get(name, 0.0) + 1e-6 * dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], None
    for _, start, dur in sorted(trace.kernels, key=lambda k: k[1]):
        if end is not None and start > end:
            gaps.append((end, start - end))
        end = start + dur if end is None else max(end, start + dur)
    named = []
    for at, length in sorted(gaps, key=lambda g: -g[1])[:10]:
        inside = [(s0, n) for n, s0, e0 in trace.host_ops if s0 <= at <= e0]
        named.append([max(inside)[1][:120] if inside else "no host operation", 1e-6 * length])
    return {"device_ops": [[n[:120], t] for n, t in ops], "idle_gaps": named}


class Setup(NamedTuple):
    cell: Cell
    device: object
    temps: object          # (max sweeps,) schedule on the device
    split: dict            # seconds of each part of the set-up


def set_up(wl: dict, device: str, seed: int) -> Setup:
    """Imports, CUDA context, kernel build (or load), system build and the
    warm-up of this cell's shapes on throwaway chains and draws."""
    split, mark = {}, time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        split[name] = now - mark
        mark = now

    import torch

    import surface_sampling_tpu_torch  # noqa: F401
    from surface_sampling_tpu_torch.core.engine import make_generator

    lap("imports_s")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    lap("cuda_context_s")
    if dev.type == "cuda":
        from surface_sampling_tpu_torch.ops.cuda_build import build_kernels

        build_kernels()
    lap("kernels_s")
    cell = build_cell(wl, dev)
    lattice = BENCH / wl["lattice"]
    differ = lattice_matches(cell.spec, lattice)
    if differ:
        raise RuntimeError(f"the program's lattice differs from {lattice} in {differ}")
    _sync(dev)
    lap("build_s")
    temps = torch.tensor(temperatures(wl["schedule"], wl.get("max_sweeps", 100000)),
                         dtype=torch.float32, device=dev)
    warm = cell.fresh()
    wgen = make_generator(seed + 1, dev)
    for i in range(wl.get("warmup_sweeps", 1)):
        warm, _ = cell.crun(warm, temps[i:i + 1], wgen)
    del warm
    _sync(dev)
    lap("warmup_s")
    return Setup(cell, dev, temps, split)


class Window(NamedTuple):
    t_start: float         # perf_counter at the first timed sweep
    sweeps: int
    window_s: float
    evals: int
    gen_start: object      # the generator's state at the window's start
    after_first: tuple     # _snapshot after the first sweep
    final: tuple           # _snapshot at the close
    trace: TraceSummary | None
    force_calls: int       # force calls in the traced sweeps


def run_window(su: Setup, wl: dict, seed: int, seconds: float, trace: bool) -> Window:
    """Sweeps of the chain run from the campaign's start until ``seconds``
    have passed, ended by a synchronize; with ``trace`` the sweeps
    1..``trace_sweeps`` run under the profiler."""
    import torch

    from surface_sampling_tpu_torch.core.engine import make_generator

    cell, dev, temps = su.cell, su.device, su.temps
    C, sweep = wl["chains"], wl["sweep_size"]
    state = cell.fresh()
    gen = make_generator(seed, dev)
    gen_start = gen.get_state()
    n_trace, trace_from = wl.get("trace_sweeps", 2), 1
    prof, summary, sweeps, after_first = None, None, 0, None
    _sync(dev)
    t_start = time.perf_counter()
    while True:
        if trace and sweeps == trace_from:
            _sync(dev)
            counts0 = _launch_counts()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            cell.recorder.states.clear()
            cell.recorder.force_calls = 0
            cell.recorder.on = True
            t_prof = time.perf_counter()
        state, _ = cell.crun(state, temps[sweeps:sweeps + 1], gen)
        if sweeps == 0:
            after_first = _snapshot(state)
        sweeps += 1
        if prof is not None and sweeps == trace_from + n_trace:
            _sync(dev)
            traced_s = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
            cell.recorder.on = False
            counts1 = _launch_counts()
            summary = summarise_profile(
                prof, traced_s, n_trace * sweep, n_trace * sweep * C, list(cell.recorder.states),
                {k: counts1[k] - counts0.get(k, 0) for k in counts1})
            prof = None
        if (time.perf_counter() - t_start >= seconds
                and (not trace or summary is not None)):
            break
        if sweeps >= temps.shape[0]:
            raise RuntimeError(f"the window outran the schedule's {temps.shape[0]} sweeps")
    _sync(dev)
    window_s = time.perf_counter() - t_start
    return Window(t_start, sweeps, window_s, C * sweep * sweeps, gen_start, after_first,
                  _snapshot(state), summary, cell.recorder.force_calls)


def _snapshot(state) -> tuple:
    """(site_state, energy, positions or None) copies of the chains' state."""
    pos = getattr(state, "relaxed_positions", None)
    return (state.site_state.clone(), state.energy.clone(),
            None if pos is None else pos.clone())


def run_cell(wl: dict, seed: int, seconds: float, trace: bool, device: str,
             t_process: float | None = None, pre_split: dict | None = None) -> dict:
    """One run of the cell: set-up, window, trace, check. Returns the
    result object (``checks`` holds each compared number with its limit,
    ``seen`` what else the check read)."""
    import torch

    t0 = time.perf_counter() if t_process is None else t_process
    su = set_up(wl, device, seed)
    t_setup = time.perf_counter()
    win = run_window(su, wl, seed, seconds, trace)
    # set-up: process start to the first timed sweep (the chains' first
    # evaluation included)
    setup_s = win.t_start - t0
    dev = su.device
    split = {**(pre_split or {}), **su.split, "first_states_s": win.t_start - t_setup}
    print("setup " + " ".join(f"{k}={v:.3f}" for k, v in split.items())
          + f" total={setup_s:.3f}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del su
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from benchmark.check import check_run

    checks, seen = check_run(wl, seed, dev, win.gen_start, win.after_first, win.final)
    failed = sum(int(c["limit"] is None or c["value"] > c["limit"]) for c in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": wl["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0, "attempted": win.evals, "failed": failed}
    if trace:
        ctx = {"workload": wl, "config": wl["config_file"], "trace": win.trace,
               "force_calls": win.force_calls,
               "setup": split, "lattice": BENCH / wl["lattice"], "device": dev}
        metrics = {}
        for m in metrics_of(wl["name"], "per_layer"):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=busy_seconds(win.trace.kernels), window_s=win.trace.window_s)
        result["breakdown"] = breakdown(win.trace)
    else:
        rate = win.evals / win.window_s
        values = {"setup_s": setup_s, "evals_per_s": rate, "host_paced_evals_per_s": rate,
                  "relaxed_evals_per_s": rate}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(wl["name"], "end_to_end")}
    result.update(metrics=metrics, device=device_info, sweeps=win.sweeps,
                  window_s=win.window_s, seen=seen, checks=checks)
    return result
