#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — semigrand MC on the SrTiO3(001) 2x2 slab
scored by the 3-member PaiNN ensemble, 128 chains — through its entry
points on the card, in six phases, each printing one line:

  1. device   card name, count, and nvidia-smi's name and power limit
  2. build    compiles the three PaiNN kernels from csrc/ (nvcc -Xptxas -v)
  3. kernels  each kernel against its plain PyTorch version at the main
              path's shapes, with times and bounds (one line per kernel)
  4. anchor   pristine potential / surface energy on the card
  5. states   random occupancies: card energies vs the CPU plain path
  6. mc       128 chains x 2 sweeps x 8 steps; launch counts of every
              kernel during that run, throughput, finite energies

Then it prints one JSON line {"kernels": [...]} (per kernel: source, the
TPU kernel it replaces, launches in phase 6, max abs error, ms, plain_ms,
bound_ms, bound_by, library_ms), the nvidia-smi line again, and last the
JSON object {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
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
            "painn_update_fused": 3 * n_evals}
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

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
