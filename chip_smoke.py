#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths — semigrand MC on the SrTiO3(001) 2x2 slab
scored by the 3-member PaiNN ensemble, 128 chains, on a rigid lattice and
with every trial state FIRE-relaxed — through their entry points on the
card, in ten phases, each printing one line or more:

  1. device     card name, count, and nvidia-smi's name and power limit
  2. build      compiles the four PaiNN kernels from csrc/ (nvcc -Xptxas -v)
  3. kernels    each forward kernel against its plain PyTorch version at the
                rigid path's shapes, with times and bounds
  4. anchor     pristine potential / surface energy on the card
  5. states     random occupancies: card energies vs the CPU plain path
  6. mc         rigid MC, 128 chains x 2 sweeps x 8 steps; launch counts of
                every kernel during that run, throughput, finite energies
  7. bwd        the message backward kernel against its plain version on
                relaxed-path geometry (C = 32, g_dw / g_db requested), its
                time at C = 128 and its bound
  8. forces     energy_and_forces at the compile entry point's inputs: card
                vs the CPU plain path
  9. relaxed    FIRE-relaxed pristine surface energy (the tutorial anchor)
 10. relax-mc   relaxed MC, 128 chains x 1 sweep x 4 steps; launch counts,
                FIRE iterations, throughput, and a bitwise repeat of the run

Then it prints one JSON line {"kernels": [...]} (per kernel: source, the
TPU kernel it replaces, launches on its path — the rigid run for the
forward kernels, the relaxed run for the backward, both under
launches_by_path — max abs error, ms, plain_ms, bound_ms, bound_by,
library_ms), the nvidia-smi line again, and last the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero. Without a CUDA device it exits 1
and prints no result.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores
# and HBM3 bandwidth. bound_ms = max(bytes / BW, flops / F32) for each kernel.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# A kernel agrees with its plain version when max|kernel - plain| is at
# most KERNEL_RTOL * max|plain|: both sum the same f32 terms in another
# order (R radial terms, then M edges or F channels), which moves the last
# few bits; an indexing fault moves values by O(max|plain|).
KERNEL_RTOL = 1e-4
N_CHAINS, SWEEPS, SWEEP_SIZE = 128, 2, 8
# relaxed MC: FIRE's 20 force calls per evaluation make a step ~2 orders
# of magnitude dearer than a rigid one, so the run is shorter
RELAX_SWEEPS, RELAX_SWEEP_SIZE = 1, 4
BWD_CHECK_CHAINS = 32     # the plain backward holds (C, K, E, 3F) tensors


def _cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cases(sys_, dev):
    """Inputs of the three kernels at the main path's shapes: real edge
    geometry of N_CHAINS random occupancies, the real layer weights, and
    seeded random features for the layer inputs."""
    from surface_sampling_tpu_torch.core.state import realize_alive, realize_numbers
    from surface_sampling_tpu_torch.models.painn import species_rows
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.static_edges import static_edge_geometry

    pot, d, spec = sys_.potential, sys_.run.d, sys_.spec
    rng = np.random.default_rng(0)
    ss = rng.integers(0, spec.n_codes, (N_CHAINS, spec.n_sites))
    ss = np.where(rng.random(ss.shape) < 0.75, 0, ss)
    ss = torch.as_tensor(ss, device=dev)
    alive = realize_alive(d, ss)
    (rbf, envm, nbr, unit, n_pad), _ = static_edge_geometry(pot.static_edge_pack, alive)
    numbers = realize_numbers(d, ss)
    rw, params, cfg = pot.rw, pot.params, pot.cfg
    K, F, N = params["atom_embed"].shape[0], cfg.feat_dim, numbers.shape[1]
    species = species_rows(rw, cfg, numbers, n_pad)
    alive_f = torch.nn.functional.pad(alive.float(), (0, n_pad - N))
    gen = torch.Generator(device=dev).manual_seed(0)

    def feat(width):
        return torch.randn((N_CHAINS, K, n_pad, width), generator=gen, device=dev)

    up = params["update"][0]
    E, R, M = rbf.shape[1], cfg.n_rbf, unit.shape[-1]
    C = N_CHAINS
    return [
        ("painn_message_l1", pk.painn_message_l1, "surface_sampling_tpu/ops/pallas_painn.py:162",
         (species, rw["philt"], rbf, envm, nbr, unit, rw["dw2"], rw["db2"]),
         # filter (2R mult-adds + bias + envelope) per edge per channel,
         # then phi product, ds sum and three dv mult-adds
         C * K * E * (2 * F * (2 * R + 2) + 2 * F + F + 6 * F)),
        ("painn_message_fused", pk.painn_message_fused,
         "surface_sampling_tpu/ops/pallas_painn.py:1100",
         (feat(3 * F), feat(3 * F), rbf, envm, nbr, unit, rw["dw"][1], rw["db"][1]),
         C * K * E * (3 * F * (2 * R + 2) + 3 * F + F + 12 * F)),
        ("painn_update_fused", pk.painn_update_fused, "surface_sampling_tpu/ops/pallas_painn.py:333",
         (feat(F), feat(3 * F), up["u_mat"]["w"], up["v_mat"]["w"], up["s_dense0"]["w"],
          up["s_dense0"]["b"], up["s_dense1"]["w"], up["s_dense1"]["b"], alive_f),
         # 6 + 2 + 3 F x F mat-vecs per row, plus ~30 F elementwise
         C * K * n_pad * (2 * 11 * F * F + 30 * F)),
    ]


def relax_edges(sys_relax, n_chains: int, seed: int):
    """Edges of the relaxed path: the topology selected at the ideal
    geometry of seeded random occupancies, the geometry recomputed at
    positions displaced as a relaxation moves them (0.05 A)."""
    from surface_sampling_tpu_torch.core.state import realize_alive, realize_positions

    d, spec, pot = sys_relax.run.d, sys_relax.spec, sys_relax.potential
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, spec.n_codes, (n_chains, spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=d.device)
    pos, alive = realize_positions(d, ss), realize_alive(d, ss)
    topo = pot.edge_topology(pos, alive)
    noise = torch.as_tensor(rng.normal(0, 0.05, tuple(pos.shape)), dtype=pos.dtype,
                            device=d.device)
    return pot.edges_of(pos + noise, topo)


def bwd_case(sys_relax, n_chains: int, seed: int):
    """Inputs of the message backward at the relaxed path's shapes: real
    geometry and layer-2 weights, seeded random features and cotangents."""
    from surface_sampling_tpu_torch.models.painn import prepare_message_geometry

    pot = sys_relax.potential
    cfg, params = pot.cfg, pot.params
    edges = relax_edges(sys_relax, n_chains, seed)
    rbf, envm, nbr, unit, n_pad, rev = prepare_message_geometry(cfg, edges)
    K, F = params["atom_embed"].shape[0], cfg.feat_dim
    mp = params["message"][1]
    dw = torch.nn.functional.pad(mp["dist_embed"]["w"],
                                 (0, 0, 0, rbf.shape[-1] - cfg.n_rbf)).contiguous()
    gen = torch.Generator(device=rbf.device).manual_seed(seed)

    def feat(width):
        return torch.randn((n_chains, K, n_pad, width), generator=gen, device=rbf.device)

    args = (feat(3 * F), feat(3 * F), rbf, envm, nbr, unit, dw,
            mp["dist_embed"]["b"].contiguous(), feat(F), feat(3 * F))
    return args, rev, int(edges.mask.sum())


def backward_phase(dev) -> dict:
    """7. The backward kernel against its plain version (all seven
    cotangents, g_dw requested) at C = 32; its time at C = 128, where the
    plain version would hold 4.8 GB tensors."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    sys_relax = srtio3_001_painn(relax=RelaxConfig(), device=dev)
    args, rev, _ = bwd_case(sys_relax, BWD_CHECK_CHAINS, seed=2)
    got = pk.painn_message_bwd(*args, rev=rev, want_dw=True)
    ref = pk.painn_message_bwd_plain(*args)
    torch.cuda.synchronize()
    names = ("g_phi", "g_vcat", "g_rbf", "g_envm", "g_unit", "g_dw", "g_db")
    errs = {}
    for n, g, r in zip(names, got, ref):
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        errs[n] = err
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"painn_message_bwd {n}: max abs error {err} exceeds "
                                 f"{KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale}")
    again = pk.painn_message_bwd(*args, rev=rev, want_dw=True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("painn_message_bwd: two launches on the same inputs differ")
    ms_check = _cuda_ms(lambda: pk.painn_message_bwd(*args, rev=rev), reps=10)
    plain_ms = _cuda_ms(lambda: pk.painn_message_bwd_plain(*args, want_dw=False), reps=3,
                        warm=1)
    del got, ref, again, args

    args, rev, n_live = bwd_case(sys_relax, N_CHAINS, seed=3)
    ms = _cuda_ms(lambda: pk.painn_message_bwd(*args, rev=rev), reps=10)
    ms_dw = _cuda_ms(lambda: pk.painn_message_bwd(*args, rev=rev, want_dw=True), reps=3)
    cfg = sys_relax.potential.cfg
    K, F, R = args[0].shape[1], cfg.feat_dim, cfg.n_rbf
    # per selected edge and member: the radial filter (3F channels x 2R),
    # the g_rbf product (3F x 2R), ~49F of elementwise products and sums
    flops = K * n_live * (12 * F * R + 49 * F)
    outs = (args[0], args[1], args[2], args[3], args[5])   # g_* have these shapes
    nbytes = _nbytes(*args, rev, *outs)
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)
    row = {
        "name": "painn_message_bwd", "route": "cuda",
        "source": "surface_sampling_tpu_torch/csrc/painn_message_bwd.cu",
        "replaces": "surface_sampling_tpu/ops/pallas_painn.py:452",
        "launches": None, "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES_PER_S
        else "bytes",
        "library_ms": None,
        "ms_chains": N_CHAINS, "plain_ms_chains": BWD_CHECK_CHAINS, "ms_at_plain_chains": ms_check,
        "ms_with_g_dw": ms_dw,
    }
    print(f"[bwd] painn_message_bwd errors {json.dumps(errs)} (tol {KERNEL_RTOL} x max|plain| "
          f"each, C={BWD_CHECK_CHAINS}, g_dw requested) bitwise repeat ok; "
          f"ms={ms:.4f} (C={N_CHAINS}) ms_with_g_dw={ms_dw:.4f} ms={ms_check:.4f} "
          f"plain_ms={plain_ms:.3f} (C={BWD_CHECK_CHAINS}) bound_ms={bound_ms:.4f} "
          f"live_edges={n_live} flops={flops:.4e} bytes={nbytes:.4e} library_ms=null "
          f"(no single PyTorch call computes this fused backward)")
    return row


def forces_phase(sys_gpu, sys_cpu, dev) -> None:
    """8. energy_and_forces at the compile entry point's inputs (one
    adsorbate, code 1 on site 0): card vs the CPU plain path."""
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )

    out = []
    for sys_, dv in ((sys_gpu, dev), (sys_cpu, torch.device("cpu"))):
        d = sys_.run.d
        ss = torch.zeros((1, sys_.spec.n_sites), dtype=torch.int64, device=dv)
        ss[0, 0] = 1
        e, f = sys_.potential.energy_and_forces(
            realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss))
        out.append((e.cpu(), f.cpu()))
    (eg, fg), (ec, fc) = out
    de, df = float((eg - ec).abs().max()), float((fg - fc).abs().max())
    print(f"[forces] card E={float(eg[0]):.6f} eV cpu E={float(ec[0]):.6f} eV |dE|={de:.3e} eV "
          f"max|F|={float(fg.abs().max()):.4f} eV/A max|dF|={df:.3e} eV/A")
    if not (de <= 1e-3 and df <= 1e-3):
        raise AssertionError(f"card and CPU forces differ: dE {de} eV, dF {df} eV/A")


def relaxed_phases(dev) -> dict:
    """9. The FIRE-relaxed pristine anchor; 10. relaxed MC with launch
    counts and a bitwise repeat. Returns the launch counts of the run."""
    from surface_sampling_tpu_torch.core import energy as core_energy
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        geometric_schedule,
        make_run_fn,
    )
    from surface_sampling_tpu_torch.core.state import realize_positions
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.parallel.chains import chain_states, make_chain_run
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    sys_relax = srtio3_001_painn(relax=RelaxConfig(), device=dev)
    run, pot = sys_relax.run, sys_relax.potential
    S = sys_relax.spec.n_sites
    out = run.state_energy_fn(torch.zeros((1, S), dtype=torch.int64, device=dev))
    se = float(out.surface_energy[0])
    print(f"[relaxed] pristine FIRE-relaxed potential {float(out.potential_energy[0]):.6f} eV "
          f"surface {se:.6f} eV (tutorial 12.471 +- 0.02)")
    if not (abs(se - 12.471) < 0.02 and not bool(out.oob[0])):
        raise AssertionError(f"relaxed anchor off: {se} eV")

    # count force calls, fresh-edge energies and FIRE iterations of the run
    calls = {"force": 0, "fresh": 0}
    n_steps = []
    force_fn, fresh_fn, fire = pot.energy_with_edges, pot.energy, core_energy.fire_relax

    def counted_force(*a, **k):
        calls["force"] += 1
        return force_fn(*a, **k)

    def counted_fresh(*a, **k):
        calls["fresh"] += 1
        return fresh_fn(*a, **k)

    def recorded_fire(*a, **k):
        res = fire(*a, **k)
        n_steps.append(res.n_steps)
        return res

    pot.energy_with_edges, pot.energy = counted_force, counted_fresh
    core_energy.fire_relax = recorded_fire
    crun = make_chain_run(make_run_fn(run.d, run.state_energy_fn,
                                      EngineConfig(sweep_size=RELAX_SWEEP_SIZE)))
    temps = geometric_schedule(1.0, RELAX_SWEEPS, 0.99)
    states = chain_states(run.d, N_CHAINS)
    first = run.state_energy_fn(states.site_state)
    states = states._replace(energy=first.surface_energy, relaxed_positions=first.positions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_counts()
    calls.update(force=0, fresh=0)
    n_steps.clear()
    res_a = crun(states, temps, seed=0)
    torch.cuda.synchronize()
    launches = pk.launch_counts()
    run_calls = dict(calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_fused = 3 * (run_calls["force"] + run_calls["fresh"])
    if not (launches["painn_message_fused"] == want_fused
            and launches["painn_message_bwd"] == 3 * run_calls["force"]
            and launches["painn_message_bwd.g_dw"] == 0
            and launches["painn_message_l1"] == 0 and launches["painn_update_fused"] == 0
            and run_calls["force"] > 0):
        raise AssertionError(f"relaxed launch counts {launches} for {run_calls}")
    iters = torch.stack(n_steps).float()
    (out_a, rec_a) = res_a
    if not (torch.isfinite(rec_a.energy).all() and torch.isfinite(out_a.energy).all()):
        raise AssertionError("non-finite energies in the relaxed MC run")
    out_b, rec_b = crun(states, temps, seed=0)
    torch.cuda.synchronize()
    same = (torch.equal(out_a.site_state, out_b.site_state)
            and torch.equal(out_a.energy, out_b.energy)
            and torch.equal(out_a.relaxed_positions, out_b.relaxed_positions)
            and torch.equal(rec_a.energy, rec_b.energy)
            and torch.equal(rec_a.positions, rec_b.positions))
    ideal = realize_positions(run.d, out_a.site_state)
    moved = float((out_a.relaxed_positions - ideal).abs().max())
    print(f"[relax-repeat] same seed twice: bitwise identical site states, energies and "
          f"relaxed positions: {same} (max relaxed displacement {moved:.4f} A)")
    if not same:
        raise AssertionError("the relaxed MC run does not repeat bitwise")
    pot.energy_with_edges, pot.energy = force_fn, fresh_fn
    core_energy.fire_relax = fire

    dt = float("inf")
    n_mc = RELAX_SWEEPS * RELAX_SWEEP_SIZE
    for rep in range(3):
        t0 = time.perf_counter()
        crun(states, temps, seed=rep + 1)
        torch.cuda.synchronize()
        dt = min(dt, time.perf_counter() - t0)
    print(f"[relax-mc] chains={N_CHAINS} sweeps={RELAX_SWEEPS}x{RELAX_SWEEP_SIZE} "
          f"evals/s={N_CHAINS * n_mc / dt:.2f} step_ms={1e3 * dt / n_mc:.3f} "
          f"fire_iters_mean={float(iters.mean()):.3f} fire_iters_max={int(iters.max())} "
          f"force_calls={run_calls['force']} fresh_energies={run_calls['fresh']} "
          f"accept={float(rec_a.accept_rate.mean()):.4f} "
          f"best={float(rec_a.energy.min()):.6f} eV peak_mem={peak_gb:.3f} GB "
          f"launches={json.dumps(launches)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        geometric_schedule,
        make_run_fn,
    )
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.parallel.chains import chain_states, make_chain_run
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    logs = pk.build_kernels()
    ptxas = {k: " | ".join(ln.strip() for ln in v.splitlines()
                           if "registers" in ln or "spill" in ln) for k, v in logs.items()}
    print(f"[build] {time.perf_counter() - t0:.1f}s {json.dumps(ptxas)}")

    # 3. kernels
    dev = torch.device("cuda")
    sys_gpu = srtio3_001_painn(device=dev)
    rows = []
    for kname, fn, replaces, args, flops in kernel_cases(sys_gpu, dev):
        got = fn(*args)
        ref = pk.PLAIN[fn](*args)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"{kname}: max abs error {err} exceeds "
                                 f"{KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale}")
        ms = _cuda_ms(lambda: fn(*args), reps=20)
        plain_ms = _cuda_ms(lambda: pk.PLAIN[fn](*args), reps=3, warm=1)
        nbytes = _nbytes(*args, *got)
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"surface_sampling_tpu_torch/csrc/{kname}.cu", "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS),
            "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES_PER_S
            else "bytes",
            "library_ms": None,
        })
        print(f"[kernel] {kname} max_abs_err={err:.3e} max_rel_err={err / scale:.3e} "
              f"(tol {KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale:.3e}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={rows[-1]['bound_ms']:.4f} "
              f"flops={flops:.4e} bytes={nbytes:.4e} library_ms=null (no single PyTorch "
              f"call computes this fused block)")
    del got, ref

    # 4. pristine anchor
    run = sys_gpu.run
    S = sys_gpu.spec.n_sites
    e0 = run.state_energy_fn(torch.zeros((1, S), dtype=torch.int64, device=dev))
    pe, se = float(e0.potential_energy[0]), float(e0.surface_energy[0])
    print(f"[anchor] potential {pe:.6f} eV surface {se:.6f} eV")
    if not (abs(pe + 467.52) < 0.05 and abs(se - 12.49) < 0.02):
        raise AssertionError(f"pristine anchor off: {pe} eV / {se} eV")

    # 5. random states: card vs the CPU plain path
    sys_cpu = srtio3_001_painn(device="cpu")
    rng = np.random.default_rng(1)
    ss = rng.integers(0, sys_gpu.spec.n_codes, (4, S))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss))
    e_gpu = run.state_energy_fn(ss.to(dev)).surface_energy.cpu()
    e_cpu = sys_cpu.run.state_energy_fn(ss).surface_energy
    diff = float((e_gpu - e_cpu).abs().max())
    print(f"[states] card {e_gpu.tolist()} cpu {e_cpu.tolist()} max diff {diff:.3e} eV")
    if not diff <= 1e-3:
        raise AssertionError(f"card and CPU energies differ by {diff} eV")

    # 6. MC run through the entry points
    d, sef = run.d, run.state_energy_fn
    crun = make_chain_run(make_run_fn(d, sef, EngineConfig(sweep_size=SWEEP_SIZE,
                                                           record_positions=False)))
    temps = geometric_schedule(1.0, SWEEPS, 0.99)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launch_counts()
    states = chain_states(d, N_CHAINS)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    out, recs = crun(states, temps, seed=0)
    torch.cuda.synchronize()
    launches = pk.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_evals = 1 + SWEEPS * SWEEP_SIZE
    want = {"painn_message_l1": n_evals, "painn_message_fused": 2 * n_evals,
            "painn_update_fused": 3 * n_evals, "painn_message_bwd": 0,
            "painn_message_bwd.g_dw": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not (torch.isfinite(recs.energy).all() and torch.isfinite(out.energy).all()):
        raise AssertionError("non-finite energies in the MC run")
    dt = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        _, r = crun(states, temps, seed=rep + 1)
        torch.cuda.synchronize()
        dt = min(dt, time.perf_counter() - t0)
    evals_per_s = N_CHAINS * SWEEPS * SWEEP_SIZE / dt
    print(f"[mc] chains={N_CHAINS} sweeps={SWEEPS}x{SWEEP_SIZE} evals/s={evals_per_s:.1f} "
          f"step_ms={1e3 * dt / (SWEEPS * SWEEP_SIZE):.3f} "
          f"accept={float(recs.accept_rate.mean()):.4f} best={float(recs.energy.min()):.6f} eV "
          f"peak_mem={peak_gb:.3f} GB launches={json.dumps(launches)}")

    bwd_row = backward_phase(dev)
    rows.append(bwd_row)
    forces_phase(sys_gpu, sys_cpu, dev)
    relax_launches = relaxed_phases(dev)

    for row in rows:
        by_path = {"rigid_mc": launches[row["name"]],
                   "relaxed_mc": relax_launches[row["name"]]}
        row["launches"] = by_path["relaxed_mc" if row is bwd_row else "rigid_mc"]
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
