#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

Traces windows with ``torch.profiler`` at the flagship's shapes
(SrTiO3(001) 2x2, 3-member PaiNN ensemble, 128 chains, seeded random
occupancies with 75% of the sites empty) and on its supercells:

  rigid        one rigid-lattice state evaluation (the MC step's energy)
  force_call   one force call of the relaxed path: energy and forces on a
               fixed edge topology, as every FIRE iteration makes it
  bwd          one launch of the message backward kernel
  sc           one full evaluation of the slab tiled 2x2 (496 slots,
               banded kernels), 128 chains
  inc          one delta-engine MC step at 2x2 (128 chains) and at 4x4
               (1984 slots, 32 chains): inc_2x2, inc_4x4
  force_call_3x3  one force call of the relaxed 3x3 supercell (1116 slots,
               16 chains): the banded general message and its backward
  local_relax  one warm-started ball-local relaxation MC step (one-hop
               balls) from FIRE-relaxed pristine chains: local_relax_1x1
               (128 chains), local_relax_3x3 (16 chains)
  chgnet_rigid one rigid-lattice state evaluation of the LaMnO3(001) CHGNet
               system (276 slots, 64 chains): edges ranked over the static
               table, the atom convs (row 10) and the plain bond/angle branch
  chgnet_force_call  one force call of its relaxed path (8 chains): rows 10
               and 12, and autograd through the rest
  cu_kernel_step  one semigrand MC step of Cu(100) 2x2x2 through the EAM
               kernel potential (row 13), 16,384 chains (bench.py's
               fallback shape); cu_rigid_step the same through
               make_eam_rigid
  cu_force_call  one force call of the relaxed Cu path (the cheb path and
               autograd), 1,024 chains
  au_canonical_step  one canonical MC step of au110_eam() (exact splines),
               1,024 chains
  train_step   one force-loss training step of the 3-member flagship
               ensemble on 16 jittered frames of the SrTiO3(001) 2x2 slab
               (chip_smoke.py's [train] shape): the loss with its force pass,
               the outer backward and the Adam update; the device ms of the
               general message (row 2), its backward (row 4), its second
               order (row 5) and of everything else

For each window it prints the wall time (host clock around work that ends
in a synchronize), the summed device time of every kernel, the device busy
share (kernel time over wall time; the port runs on one stream, so kernels
do not overlap) and the kernels by device time; for the CHGNet windows also
the span on the device timeline of each of the forward's stages (the
``chgnet.*`` ranges that ``models.chgnet.chgnet_apply`` marks, summed over
their calls). The last line of its output is all
of it as one JSON object. Each window runs twice untraced first.

Run from the repository root:  python3 tools/port_profile.py [WINDOW ...]
Window names as above (e.g. ``sc inc_2x2 inc_4x4 force_call_3x3``) trace
only those; the systems and draws before them are made as in a full run, so
a window sees the same states either way. None given traces them all.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_CHAINS = 128
SC44_CHAINS = 32
SC33_CHAINS = 16
CHG_CHAINS, CHG_RELAX_CHAINS = 64, 8    # chip_smoke.py's paths A and B
CU_CHAINS, CU_RELAX_CHAINS, AU_CHAINS = 16384, 1024, 1024   # chip_smoke.py's EAM paths
# the kernels of rows 2, 4 and 5 by their names in a trace
TRAIN_ROWS = {"row 2 painn_message_fused": "message_kernel",
              "row 4 painn_message_bwd": "msgbwd::", "row 5 painn_message_bwd2": "msgbwd2::"}


def _window(name: str, fn, top: int = 12) -> dict:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, stages = {}, {}
    for evt in prof.key_averages():
        t_us = getattr(evt, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(evt, "self_cuda_time_total", 0)
        if evt.key.startswith("chgnet."):
            # a marked range: its device time is its span on the device
            # timeline (gaps between its kernels included), not a kernel
            stages[evt.key] = t_us / 1e3
        elif t_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (kernels.get(evt.key, (0.0, 0))[0] + t_us / 1e3,
                                kernels.get(evt.key, (0.0, 0))[1] + evt.count)
    device_ms = sum(t for t, _ in kernels.values())
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy_share": device_ms / wall_ms if wall_ms else None,
           "kernels": [{"name": k[:120], "ms": t, "count": n} for k, (t, n) in rows]}
    print(f"[{name}] wall {wall_ms:.3f} ms, kernels {device_ms:.3f} ms, "
          f"busy share {out['busy_share']:.3f}, {len(rows)} distinct kernels")
    for k, (t, n) in rows[:top]:
        print(f"    {t:9.3f} ms  {n:5d}x  {k[:110]}")
    if stages:
        out["forward_stage_spans_ms"] = stages
        print(f"    forward stages, span on the device timeline (ms): {json.dumps(stages)}")
    return out


def force_call(pot, pos, types, alive):
    """One force call of a relaxation: energy and forces, on the edge
    topology selected at ``pos`` where the potential has topology hooks."""
    if not hasattr(pot, "edge_topology"):
        return lambda: pot.energy_and_forces(pos, types, alive)
    topo = pot.edge_topology(pos, alive)

    def call():
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e = pot.energy_with_edges(p, types, alive, edges=pot.edges_of(p, topo))
            torch.autograd.grad(e.sum(), p)

    return call


def local_relax_step(sys_relax, chains, rng):
    """One local-relax MC step (one-hop balls) of ``chains`` FIRE-relaxed
    pristine chains with seeded draws."""
    from surface_sampling_tpu_torch.core.local_relax import (
        build_ball_masks,
        make_local_relax_eval,
        make_local_relax_semigrand_step,
    )
    from surface_sampling_tpu_torch.parallel.chains import relaxed_chain_states

    run, spec, dev = sys_relax.run, sys_relax.spec, sys_relax.run.d.device
    balls = build_ball_masks(spec, sys_relax.static_nbr, hops=1)
    step = make_local_relax_semigrand_step(make_local_relax_eval(
        run.d, sys_relax.potential, run.surface_energy_fn, run.relax, balls))
    state = relaxed_chain_states(run.d, run.state_energy_fn, chains)
    draws = (torch.as_tensor(rng.integers(0, spec.n_sites, chains), device=dev),
             torch.as_tensor(rng.integers(0, spec.n_codes - 1, chains), device=dev),
             torch.as_tensor(rng.random(chains), dtype=torch.float32, device=dev))
    return lambda: step(state, 1.0, *draws)


def eam_windows(dev, rng) -> dict:
    """The EAM windows: one MC step of each EAM path at chip_smoke.py's
    shapes, from seeded states (a site filled with probability 0.15, a
    6-adsorbate occupancy on Au(110))."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.events import (
        canonical_draws,
        make_canonical_step,
        make_semigrand_step,
        semigrand_draws,
    )
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.parallel.chains import chain_states
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam, make_eam_rigid
    from surface_sampling_tpu_torch.systems import au110_eam, cu100_eam

    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    cu = cu100_eam(fast=True, device=dev)
    tables = builtin_eam("Cu_u3")
    runs = {"cu_kernel_step": MCMCRun(cu.spec, make_eam_kernel_potential(
                tables, cu.static_nbr, device=dev), device=dev),
            "cu_rigid_step": MCMCRun(cu.spec, make_eam_rigid(tables, cu.spec, device=dev),
                                     device=dev)}
    ss = torch.as_tensor((rng.random((CU_CHAINS, cu.spec.n_sites)) < 0.15).astype(np.int64),
                         device=dev)
    for name, run in runs.items():
        step = make_semigrand_step(run.d, run.state_energy_fn)
        state = chain_states(run.d, CU_CHAINS, ss)
        state = state._replace(energy=run.state_energy_fn(ss).surface_energy)
        draws = semigrand_draws(gen, CU_CHAINS, cu.spec.n_sites, cu.spec.n_codes)
        out[name] = _window(name, lambda: step(state, 1.0, *draws))
        out[name]["chains"] = CU_CHAINS
    relax = cu100_eam(fast=True, relax=RelaxConfig(), device=dev)
    d = relax.run.d
    ss = ss[:CU_RELAX_CHAINS]
    out["cu_force_call"] = _window("cu_force_call", force_call(
        relax.potential, realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss)))
    out["cu_force_call"]["chains"] = CU_RELAX_CHAINS
    au = au110_eam(device=dev)
    ss = np.zeros((AU_CHAINS, 8), np.int64)
    for c in range(AU_CHAINS):
        ss[c, rng.choice(8, 6, replace=False)] = 1
    state = chain_states(au.run.d, AU_CHAINS, ss)
    state = state._replace(energy=au.run.state_energy_fn(state.site_state).surface_energy)
    step = make_canonical_step(au.run.d, au.run.state_energy_fn)
    draws = canonical_draws(gen, AU_CHAINS, 8, au.spec.n_codes)
    out["au_canonical_step"] = _window("au_canonical_step", lambda: step(state, 0.3, *draws))
    out["au_canonical_step"]["chains"] = AU_CHAINS
    return out


def train_step_window(dev) -> dict:
    """The train_step window: one Trainer step (loss, force pass, outer
    backward, clipped Adam update) on chip_smoke.py's [train] ensemble,
    frames and labels; the window's kernels summed by row."""
    from chip_smoke import train_setup
    from surface_sampling_tpu_torch.models import train as tr

    params, cfg, frames, _, batch = train_setup(dev)
    dev_batch = tr.batch_to_device(batch, dev)
    trainer = tr.Trainer(params, cfg, tr.TrainConfig(learning_rate=1e-4), ensemble=True)
    out = _window("train_step", lambda: trainer.step(dev_batch))
    rows = {name: sum(k["ms"] for k in out["kernels"] if key in k["name"])
            for name, key in TRAIN_ROWS.items()}
    rows["rest (plain PyTorch)"] = out["device_ms"] - sum(rows.values())
    out["device_ms_by_row"] = rows
    out["frames"], out["members"] = len(frames), params["atom_embed"].shape[0]
    print(f"    device ms by row: {json.dumps(rows)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_painn_from_system,
        make_incremental_semigrand_step,
    )
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.models.painn import prepare_message_geometry
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.cuda_build import build_kernels
    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet, srtio3_001_painn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    build_kernels()
    rigid = srtio3_001_painn(device=dev)
    relax = srtio3_001_painn(relax=RelaxConfig(), device=dev)
    spec, d = relax.spec, relax.run.d
    rng = np.random.default_rng(0)
    ss = rng.integers(0, spec.n_codes, (N_CHAINS, spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
    pos, alive, types = realize_positions(d, ss), realize_alive(d, ss), realize_type_idx(d, ss)
    pot = relax.potential
    edges = pot.edges_of(pos, pot.edge_topology(pos, alive))
    rbf, envm, nbr, unit, n_pad, rev = prepare_message_geometry(pot.cfg, edges)
    K, F = pot.params["atom_embed"].shape[0], pot.cfg.feat_dim
    g = torch.Generator(device=dev).manual_seed(0)
    feats = [torch.randn((N_CHAINS, K, n_pad, w), generator=g, device=dev)
             for w in (3 * F, 3 * F, F, 3 * F)]
    mp = pot.params["message"][1]
    dw = torch.nn.functional.pad(mp["dist_embed"]["w"], (0, 0, 0, rbf.shape[-1] - pot.cfg.n_rbf))
    bwd_args = (feats[0], feats[1], rbf, envm, nbr, unit, dw.contiguous(),
                mp["dist_embed"]["b"].contiguous(), feats[2], feats[3])

    report = {"device": smi, "chains": N_CHAINS}
    only = set(sys.argv[1:])

    def trace(name, fn):
        if not only or name in only:
            report[name] = _window(name, fn)

    trace("rigid", lambda: rigid.run.state_energy_fn(ss))
    trace("force_call", force_call(pot, pos, types, alive))
    trace("bwd", lambda: pk.painn_message_bwd(*bwd_args, rev=rev))
    trace("local_relax_1x1", local_relax_step(relax, N_CHAINS, rng))
    del relax, rigid, feats, bwd_args, edges
    torch.cuda.empty_cache()

    sc33 = srtio3_001_painn(supercell=(3, 3), relax=RelaxConfig(), device=dev)
    spec, d = sc33.spec, sc33.run.d
    ss = rng.integers(0, spec.n_codes, (SC33_CHAINS, spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
    trace("force_call_3x3", force_call(
        sc33.potential, realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss)))
    if "force_call_3x3" in report:
        report["force_call_3x3"]["chains"] = SC33_CHAINS
    trace("local_relax_3x3", local_relax_step(sc33, SC33_CHAINS, rng))
    if "local_relax_3x3" in report:
        report["local_relax_3x3"]["chains"] = SC33_CHAINS
    del sc33
    torch.cuda.empty_cache()

    for cell, chains in (((2, 2), N_CHAINS), ((4, 4), SC44_CHAINS)):
        sc = srtio3_001_painn(supercell=cell, device=dev)
        spec, d = sc.spec, sc.run.d
        ss = rng.integers(0, spec.n_codes, (chains, spec.n_sites))
        ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
        if cell == (2, 2):
            trace("sc", lambda: sc.run.state_energy_fn(ss))
        engine = make_incremental_painn_from_system(sc)
        step = make_incremental_semigrand_step(engine)
        state = engine.init_state(ss)
        draws = (torch.as_tensor(rng.integers(0, spec.n_sites, chains), device=dev),
                 torch.as_tensor(rng.integers(0, spec.n_codes - 1, chains), device=dev),
                 torch.as_tensor(rng.random(chains), dtype=torch.float32, device=dev))
        name = f"inc_{cell[0]}x{cell[1]}"
        trace(name, lambda: step(state, 1.0, *draws))
        if name in report:
            report[name]["chains"] = chains
        del sc, engine, state
        torch.cuda.empty_cache()

    for relax, chains in ((None, CHG_CHAINS), (RelaxConfig(steps=10), CHG_RELAX_CHAINS)):
        chg = lamno3_001_chgnet(relax=relax, device=dev)
        spec, d = chg.spec, chg.run.d
        ss = rng.integers(0, spec.n_codes, (chains, spec.n_sites))
        ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
        if relax is None:
            name = "chgnet_rigid"
            trace(name, lambda: chg.run.state_energy_fn(ss))
        else:
            name = "chgnet_force_call"
            trace(name, force_call(chg.potential, realize_positions(d, ss),
                                   realize_type_idx(d, ss), realize_alive(d, ss)))
        if name in report:
            report[name]["chains"] = chains
        del chg
        torch.cuda.empty_cache()
    if not only or only & {"cu_kernel_step", "cu_rigid_step", "cu_force_call",
                           "au_canonical_step"}:
        report.update(eam_windows(dev, rng))
        torch.cuda.empty_cache()
    if not only or "train_step" in only:
        report["train_step"] = train_step_window(dev)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
