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
               table, the atom convs (row 10) and the plain readout
  chgnet_force_call  one force call of its relaxed path (8 chains): rows 10
               and 12, and autograd through the rest; both CHGNet windows
               also print their device ms by row (10, 12's centre and
               neighbour passes, the rest)
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

Two more modes, for the redesigned kernels (rows 1-3, 5, 6, 10-13) and the
tensor cores:

  --variants [NAME ...]   one-edit variants of rows 1-3, 5, 6 and 10-13
      (edits of a copy of csrc/, or a whole source replaced by a file of
      tools/variants/, built into _build/variants/, loaded in place of the
      built kernels), timed in turns by CUDA events at chip_smoke.py's
      shapes: row 10 at paths A and B, row 11 at path C, row 12 at path B,
      row 2 at the 1x1 rigid path's (128 chains) and a training step's (16
      frames, one member), row 13 at Cu (16,384 chains) and Au (1,024), row
      6 at the 2x2 supercell (128 chains), row 5 at a training step's shape
      (one member, c_dw absent and given), rows 1 and 3 at the 1x1 rigid
      path's (128 chains), row 3 also at the 2x2 supercell's (128 chains,
      port_compare.sc_update_args); two rounds, the second in
      reverse order; each variant's largest difference from the sources (a
      NaN counts as infinite). A variant builds and times only the kernels
      its edits reach (``FILE_KERNELS``); base builds and times them all.
      Built in: upd_block_ring (row 3 with one weight ring for the block, a
      barrier a k-slice, the tile loaded by plain loads: the first version
      of the design, tools/variants/update_block_ring.cu), upd_tm16 (tiles
      of 16 rows, not 32), upd_ks8 (k-slices of 8 weight rows, not 16),
      upd_ring2 / upd_ring4 (2 / 4 slots a warp's ring, not 3), upd_p2ks
      (P2's k-slices of 16 W0 rows, not 32), upd_l2_epi (the next tile
      loaded during the last product, the epilogue reading s and v from
      L2), upd_lds (A fragments by four
      32-bit shared loads, not one ldmatrix), upd_trunc (tf32_mma.cuh's
      truncating split, not the rounding one), upd_all
      (every row computed, the dead ones zeroed after: what the alive list
      buys), upd_fma (the products as f32 FMAs on the CUDA cores, the same
      fragments and rings), upd_clk (row 3's warp clocks by phase: the
      tile wait, each product, the epilogue, the dead-row zeros); l1_blk16
      / l1_blk4 / l1_blk2 (row 1 at 16 / 4 / 2 centres a block, not 8);
      l1_edges (row 6 as the layer-1 form of row 7's body, the
      per-edge design the binned kernel replaced), l1_8w (rows 1 and 6 at 8
      warps a block); bwd2_nb2 (row 5's neighbour kernel cut for 2 blocks an SM,
      not 3), bwd2_clk (its centre kernel's warp clocks by phase),
      bwd2_nodw / bwd2_noflush / bwd2_nodrbf / bwd2_noring (the centre
      kernel without its d_dw products, their add to the block's partial,
      the d_rbf product, or the ring's row copies: wrong results, for where
      the time goes); one_pass (one TF32 pass), no_mma, no_act (sigmoid(x) =
      x), fwd_4x3 (rows 10 / 11 at 4 warps x 3 blocks an SM), bwd_8x1 (row
      12 at 8 x 1), clk (clock64 marks: warp clocks by phase); msg_blk16 /
      msg_blk8 / msg_blk2 / msg_blk1 (row 2 at 16 / 8 / 2 / 1 centres a
      block, not 4), msg_ident (row 2 without the window arithmetic);
      eam_stage (row 13 with the candidate table staged in shared memory
      once per resident block, a persistent grid walking the chains), eam_4w
      / eam_8w (row 13 at 4 / 8 warps a block, not 16), eam_u1 / eam_u4 (its
      candidate loads one / four chunks of 32 at a time, not two), eam_cv25
      / eam_cv50 (a shared-memory carveout of 25 / 50% of the most, the rest
      L1), eam_lb3 / eam_8w_lb6 (registers capped for 3 blocks of 16 warps /
      6 of 8 an SM), eam_noseries (both series left out: the candidate pass,
      the compaction and the sums), eam_clk (row 13's warp clocks by phase,
      over its alive centres).
      --variants --spec FILE takes {name: [[file, old, new], ...]} instead.
  --mma-peak   mma.sync throughput: TF32 m16n8k8 with 1, 4, 8 accumulators
      a warp, BF16 m16n8k16, and the conv's inner loop (B from shared
      memory, split, three passes), at 4-32 warps an SM.

Run from the repository root:  python3 tools/port_profile.py [WINDOW ...]
Window names as above (e.g. ``sc inc_2x2 inc_4x4 force_call_3x3``) trace
only those; the systems and draws before them are made as in a full run, so
a window sees the same states either way. None given traces them all.
"""

from __future__ import annotations

import ctypes
import json
import shutil
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
# the kernels of rows 2, 4 and 5 by their names in a trace (row 2 runs the
# banded body, banded::message_kernel, which row 7 runs too)
TRAIN_ROWS = {"row 2 painn_message_fused": "message_kernel",
              "row 4 painn_message_bwd": "msgbwd::", "row 5 painn_message_bwd2": "msgbwd2::"}
# the kernels of rows 10 and 12 (centre and neighbour pass) by their names
CHGNET_ROWS = {"row 10 chgnet_conv": "::conv_kernel", "row 12 centre": "centre_kernel",
               "row 12 neighbour": "neighbour_kernel"}


def _by_row(out: dict, rows: dict) -> dict:
    """A window's device ms summed by row (kernel-name keys), the rest as
    plain PyTorch; stored under device_ms_by_row and printed."""
    ms = {name: sum(k["ms"] for k in out["kernels"] if key in k["name"])
          for name, key in rows.items()}
    ms["rest (plain PyTorch)"] = out["device_ms"] - sum(ms.values())
    out["device_ms_by_row"] = ms
    print(f"    device ms by row: {json.dumps(ms)}")
    return ms


# the prefixes of the port's span names (utils.tracing)
SPANS = ("chgnet.", "mc.", "delta.")


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
        if getattr(evt, "is_user_annotation", False) or evt.key.startswith(SPANS):
            # a span (utils.tracing.span): its device time is its span on
            # the device timeline (gaps between its kernels included), not
            # a kernel
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
        out["spans_ms"] = stages
        print(f"    spans, on the device timeline (ms): {json.dumps(stages)}")
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
    _by_row(out, TRAIN_ROWS)
    out["frames"], out["members"] = len(frames), params["atom_embed"].shape[0]
    return out


# ----------------------------------------------------------------------
# --variants: one-edit variants of rows 2 and 10-13 timed in turns
# ----------------------------------------------------------------------
HDR, BWD_SRC, MMA_HDR = "chgnet_conv.cuh", "chgnet_conv_bwd.cu", "tf32_mma.cuh"
MSG_SRC, BANDED_HDR, EAM_SRC = ("painn_message_fused.cu", "painn_message_banded.cuh",
                                "eam_rho_ep.cu")
L1_SRC, BWD2_SRC = "painn_message_l1_banded.cu", "painn_message_bwd2.cu"
L1_HDR, L1_ROW1, UPD_SRC = ("painn_message_l1_binned.cuh", "painn_message_l1.cu",
                            "painn_update_fused.cu")
CONV_KERNELS = ("chgnet_conv", "chgnet_conv_banded", "chgnet_conv_bwd")
# the kernels an edited file reaches (a variant builds and times only those)
FILE_KERNELS = {HDR: CONV_KERNELS, BWD_SRC: ("chgnet_conv_bwd",),
                MMA_HDR: CONV_KERNELS + ("painn_message_fused", "painn_message_bwd2",
                                         "painn_update_fused"),
                MSG_SRC: ("painn_message_fused",), BANDED_HDR: ("painn_message_fused",),
                EAM_SRC: ("eam_rho_ep",), L1_SRC: ("painn_message_l1_banded",),
                L1_HDR: ("painn_message_l1_banded", "painn_message_l1"),
                L1_ROW1: ("painn_message_l1",), UPD_SRC: ("painn_update_fused",),
                BWD2_SRC: ("painn_message_bwd2",)}
ALL_KERNELS = CONV_KERNELS + ("painn_message_fused", "eam_rho_ep", "painn_message_l1_banded",
                              "painn_message_bwd2", "painn_update_fused", "painn_message_l1")
# a whole source replaced (or a file added) by a file of tools/variants/: the
# edit [file, None, name]
VARIANT_DIR = Path(__file__).resolve().parent / "variants"
# row 13 with the candidate table staged in shared memory once per resident
# block, and a persistent grid of blocks walking the chains
EAM_STAGE = [
    [EAM_SRC, "  float* s_a = s_z + N;\n", """  float* s_a = s_z + N;
  int* s_tj = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                     n_warps * warp_smem_bytes(cap, N, M));
  float* s_tsh = reinterpret_cast<float*>(s_tj + N * M);
  for (int t = threadIdx.x; t < N * M; t += blockDim.x) s_tj[t] = kernel_j[t];
  for (int t = threadIdx.x; t < 3 * N * M; t += blockDim.x) s_tsh[t] = shift[t];
  __syncthreads();
"""],
    [EAM_SRC, "__ldg(kernel_j + i * M + m)", "s_tj[i * M + m]"],
    [EAM_SRC, "__ldg(shift + 3 * p)", "s_tsh[3 * p]"],
    [EAM_SRC, "__ldg(shift + 3 * p + 1)", "s_tsh[3 * p + 1]"],
    [EAM_SRC, "__ldg(shift + 3 * p + 2)", "s_tsh[3 * p + 2]"],
    [EAM_SRC, """  const int c_end = min(C, int(blockIdx.x + 1) * cpb);
  for (int c = int(blockIdx.x) * cpb + warp; c < c_end; c += n_warps) {""",
     """  for (int grp = blockIdx.x; grp < (C + cpb - 1) / cpb; grp += gridDim.x) {
  const int c_end = min(C, (grp + 1) * cpb);
  for (int c = grp * cpb + warp; c < c_end; c += n_warps) {"""],
    [EAM_SRC, """    retire(w, rho_out, ep_out);
  }
}""", """    retire(w, rho_out, ep_out);
  }
  }
}"""],
    [EAM_SRC, "  const size_t smem = n_warps * warp_smem_bytes(cap, N, M);",
     "  const size_t smem = n_warps * warp_smem_bytes(cap, N, M) + size_t(16) * N * M;"],
    [EAM_SRC, "  const int blocks = (C + cpb - 1) / cpb;",
     """  int blocks = (C + cpb - 1) / cpb, dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rho_ep_kernel, n_warps * 32, smem);
  if (blocks > n_sm * per_sm) blocks = n_sm * per_sm;"""],
]
# row 13's clock64 marks: each lane adds its clocks by phase in registers,
# lane 0 of each warp posts them once at the end
EAM_CLK_DEFS = """
__device__ unsigned long long g_clk[16];
#define CLK(i) { const long long now_ = clock64(); clk_acc[i] += now_ - t_prev; t_prev = now_; }
extern "C" int read_clk(unsigned long long* out) {
  return int(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));
}
extern "C" int reset_clk() {
  unsigned long long z[16] = {};
  return int(cudaMemcpyToSymbol(g_clk, z, sizeof(z)));
}
"""
EAM_WARPS = "constexpr int NWARP = 16; "
EAM_SMEM = """  cudaError_t err = cudaFuncSetAttribute(
      rho_ep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
"""
EAM_CARVEOUT = ("  cudaFuncSetAttribute(rho_ep_kernel,\n"
                "                       cudaFuncAttributePreferredSharedMemoryCarveout, {});\n")
MSG_BLK = "  int n_blk = 4;\n"
L1_BLK = "  int n_blk = 8;\n"
UPD_TILE = "inline int tile_rows(int F) { return F <= 128 ? 32 : 16; }"
UPD_SLICE = "inline int slice_rows(int F) { return F <= 128 ? 16 : 8; }"
UPD_LAUNCH = "    return int(launch<32, 16>("
UPD_STAGES = "constexpr int NSTAGE = 3;"
# row 3 computing every row (the alive list holding all of them; the dead
# rows' outputs, alive x (...) = 0, are zeroed again after)
UPD_ALL = ["    const int n = __popcll(bits);\n",
           "    bits = i0 >= N ? 0ull : N - i0 >= 64 ? ~0ull : ~0ull >> (64 - (N - i0));\n"
           "    const int n = __popcll(bits);\n"]
# row 3's products as f32 FMAs on the CUDA cores, the same fragments and
# weight rings: each lane computes its own accumulator elements
UPD_TILE_MMA = """  unsigned bh[NB][2], bl[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    split_rn(slot[(kk + t) * BS + b_col[j] + g], bh[j][0], bl[j][0]);
    split_rn(slot[(kk + t + 4) * BS + b_col[j] + g], bh[j][1], bl[j][1]);
  }
  const int lane = 4 * g + t;
  const float* a_lane = a_base + ((lane & 7) + (lane & 8)) * AS + 4 * (lane >> 4);
#pragma unroll
  for (int i = 0; i < MA; ++i) {
    float a[4];
    ldmatrix_x4(a, a_lane + a_off[i]);
    unsigned ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_rn(a[e], ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma3(acc[i][j], ah, al, bh[j], bl[j]);
  }"""
# row 3 loading the next item's tile during the current item's P3 (its
# cp.async group counted among the rings'), the epilogue reading s and v
# again from global memory (L2)
UPD_L2_EPI = [
    [UPD_SRC, "  int* s_row = reinterpret_cast<int*>(s_h + TM * HS + NW * NSTAGE * WS);   // TM flat rows\n"
     "  float* s_am = reinterpret_cast<float*>(s_row + TM);                       // TM alive values",
     "  int* s_row = reinterpret_cast<int*>(s_h + TM * HS + NW * NSTAGE * WS);\n"
     "  float* s_am = reinterpret_cast<float*>(s_row + 2 * TM);"],
    [UPD_SRC, "  return floats * sizeof(float) + size_t(TM) * (sizeof(int) + sizeof(float));",
     "  return floats * sizeof(float) + 2 * size_t(TM) * (sizeof(int) + sizeof(float));"],
    [UPD_SRC, "  auto consume = [&](int q) -> const float* {\n    cp_async_wait<NSTAGE - 2>();\n",
     "  auto consume = [&](int q, bool tile = false) -> const float* {\n    if (tile)\n"
     "      cp_async_wait<NSTAGE - 1>();\n    else\n      cp_async_wait<NSTAGE - 2>();\n"],
    [UPD_SRC, "  auto issue_tile = [&](int it) {\n",
     "  auto issue_tile = [&](int it, int buf) {\n    if (it >= my_items) {\n"
     "      cp_async_commit();\n      return;\n    }\n"],
    [UPD_SRC, "      s_row[my_r] = flat;\n      s_am[my_r] = flat >= 0 ? alive[flat] : 0.f;",
     "      s_row[buf * TM + my_r] = flat;\n      s_am[buf * TM + my_r] = flat >= 0 ? alive[flat] : 0.f;"],
    [UPD_SRC, "  for (int q = 0; q < NSTAGE - 1; ++q) issue();\n",
     "  issue_tile(0, 0);\n  for (int q = 0; q < NSTAGE - 1; ++q) issue();\n"],
    [UPD_SRC, "    __syncthreads();\n    issue_tile(it);\n    cp_async_wait<0>();\n    __syncthreads();\n",
     "    const int buf = it & 1;\n    if (NQ1 >= NSTAGE - 1)\n      cp_async_wait<NSTAGE - 1>();\n"
     "    else\n      cp_async_wait<0>();\n    __syncthreads();\n"],
    [UPD_SRC, "    __syncthreads();                  // every warp's h\n",
     "    __syncthreads();                  // every warp's h\n    issue_tile(it + 1, buf ^ 1);\n"],
    [UPD_SRC, "        const float* slot = consume(q);\n#pragma unroll\n        for (int ks = 0; ks < KSTEPS; ++ks)\n"
     "          tile_step<MT, 6>",
     "        const float* slot = consume(q, j < NSTAGE - 1);\n#pragma unroll\n"
     "        for (int ks = 0; ks < KSTEPS; ++ks)\n          tile_step<MT, 6>"],
    [UPD_SRC, "            const float am = s_am[r];\n            const int flat = s_row[r], c = flat / n_pad;",
     "            const float am = s_am[buf * TM + r];\n"
     "            const int flat = s_row[buf * TM + r], c = flat / n_pad;"],
    [UPD_SRC, "*reinterpret_cast<const float2*>(s_sv + r * SVS + ch)",
     "__ldg(reinterpret_cast<const float2*>(s + gr * F + ch))"],
    [UPD_SRC, "*reinterpret_cast<const float2*>(s_v + r * VS + x * F + ch)",
     "__ldg(reinterpret_cast<const float2*>(vcat + gr * F3 + x * F + ch))"],
]
# row 3's A fragments by four 32-bit shared loads each, not one ldmatrix
UPD_LDS = ["""    float a[4];
    ldmatrix_x4(a, a_lane + a_off[i]);
""", """    const float* lo = a_base + a_off[i] + g * AS + t;
    const float* hi = lo + 8 * AS;
    const float a[4] = {lo[0], hi[0], lo[4], hi[4]};
"""]
UPD_TILE_FMA = """#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float b[2][8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      b[0][k] = slot[(kk + k) * BS + b_col[j] + 2 * t];
      b[1][k] = slot[(kk + k) * BS + b_col[j] + 2 * t + 1];
    }
#pragma unroll
    for (int i = 0; i < MA; ++i) {
      const float4* lo = reinterpret_cast<const float4*>(a_base + a_off[i] + g * AS);
      const float4* hi = reinterpret_cast<const float4*>(a_base + a_off[i] + (g + 8) * AS);
      const float4 l0 = lo[0], l1 = lo[1], h0 = hi[0], h1 = hi[1];
      const float al[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      const float ahv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          acc[i][j][p] = fmaf(al[k], b[p][k], acc[i][j][p]);
          acc[i][j][2 + p] = fmaf(ahv[k], b[p][k], acc[i][j][2 + p]);
        }
    }
  }"""
MSG_WINDOW = "  return envm[e] == 0.f ? -1 : window_row(nbr[e], s, n_pad, W);"
FWD_PLAN = ("constexpr int FWD_WARPS = 6;   // warps a block of the forward (rows 10, 11)\n"
            "constexpr int FWD_BLOCKS_PER_SM = 2;")
BWD_PLAN = ("constexpr int BWD_WARPS = 4;   // warps a block of the centre kernel\n"
            "constexpr int BWD_BLOCKS_PER_SM = 2;")
MMA3 = "  mma_tf32(d, al, bh);\n  mma_tf32(d, ah, bl);\n  mma_tf32(d, ah, bh);"

# clock64 marks: CLK(i) adds the warp's clocks since the last mark to slot i
CLK_DEFS = """
__device__ unsigned long long g_clk[16];
#define CLK(i) { __syncwarp(); const long long now_ = clock64(); \\
  if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[i], (unsigned long long)(now_ - t_prev)); \\
  t_prev = now_; }
extern "C" int read_clk(unsigned long long* out) {
  return int(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));
}
extern "C" int reset_clk() {
  unsigned long long z[16] = {};
  return int(cudaMemcpyToSymbol(g_clk, z, sizeof(z)));
}
"""
CLK_FWD = ["compaction (warp 0) + barrier", "tile_pre", "hidden products",
           "elementwise + tile sums", "barrier", "agg"]
CLK_EAM = ["chain staging", "candidate list (j, alive)", "distances + append", "series",
           "centre sums", "queue push"]
CLK_BWD2 = ["compaction + zeros + staging", "ring wait + (k, cg) loads", "W, G products",
            "elementwise", "d_rbf product + slices", "d_dw products", "partial + d_gds flush",
            "centre end: barrier + slice sums"]
CLK_UPD = ["barrier + tile loads + barrier", "P1 products (v . [U | V])",
           "|Vv|, <Uv, Vv> + barrier", "P2 products (W0) + silu + barrier", "P3 products (W1)",
           "epilogue", "dead-row zeros"]
CLK_BWD = ["g_ai2 + compaction (warp 0) + barrier + zeros", "tile_pre + silu'",
           "hidden products", "LayerNorm backward", "dpre products + store", "tile sums",
           "g_be product", "barrier"]
VARIANTS = {
    "base": [],
    "msg_blk16": [[MSG_SRC, MSG_BLK, MSG_BLK.replace("4", "16")]],
    "msg_blk8": [[MSG_SRC, MSG_BLK, MSG_BLK.replace("4", "8")]],
    "msg_blk2": [[MSG_SRC, MSG_BLK, MSG_BLK.replace("4", "2")]],
    "msg_blk1": [[MSG_SRC, MSG_BLK, MSG_BLK.replace("4", "1")]],
    "msg_ident": [[BANDED_HDR, MSG_WINDOW, "  return envm[e] == 0.f ? -1 : nbr[e];"]],
    "eam_stage": EAM_STAGE,
    "eam_4w": [[EAM_SRC, EAM_WARPS, EAM_WARPS.replace("16", "4")]],
    "eam_8w": [[EAM_SRC, EAM_WARPS, EAM_WARPS.replace("16", "8")]],
    "eam_u1": [[EAM_SRC, "constexpr int U = 2; ", "constexpr int U = 1; "]],
    "eam_u4": [[EAM_SRC, "constexpr int U = 2; ", "constexpr int U = 4; "]],
    "eam_cv25": [[EAM_SRC, EAM_SMEM, EAM_SMEM + EAM_CARVEOUT.format(25)]],
    "eam_cv50": [[EAM_SRC, EAM_SMEM, EAM_SMEM + EAM_CARVEOUT.format(50)]],
    "eam_lb3": [[EAM_SRC, "__global__ void __launch_bounds__(NWARP * 32)\n",
                 "__global__ void __launch_bounds__(NWARP * 32, 3)\n"]],
    "eam_8w_lb6": [[EAM_SRC, EAM_WARPS, EAM_WARPS.replace("16", "8")],
                   [EAM_SRC, "__global__ void __launch_bounds__(NWARP * 32)\n",
                    "__global__ void __launch_bounds__(NWARP * 32, 6)\n"]],
    "eam_noseries": [[EAM_SRC, "    *e = pair_terms(e->x);", "    *e = make_float2(e->x, e->x);"]],
    "l1_edges": [[L1_SRC, None, "l1_edges.cu"],
                 ["painn_message_banded_l1.cuh", None, "painn_message_banded_l1.cuh"]],
    "l1_8w": [[L1_HDR, "constexpr int NW = 4, THREADS", "constexpr int NW = 8, THREADS"]],
    "l1_blk16": [[L1_ROW1, L1_BLK, L1_BLK.replace("8", "16")]],
    "l1_blk4": [[L1_ROW1, L1_BLK, L1_BLK.replace("8", "4")]],
    "l1_blk2": [[L1_ROW1, L1_BLK, L1_BLK.replace("8", "2")]],
    "upd_block_ring": [[UPD_SRC, None, "update_block_ring.cu"]],
    "upd_tm16": [[UPD_SRC, UPD_TILE, "inline int tile_rows(int F) { return 16; }"],
                 [UPD_SRC, UPD_LAUNCH, "    return int(launch<16, 16>("]],
    "upd_ks8": [[UPD_SRC, UPD_SLICE, "inline int slice_rows(int F) { return 8; }"],
                [UPD_SRC, UPD_LAUNCH, "    return int(launch<32, 8>("]],
    "upd_ring2": [[UPD_SRC, UPD_STAGES, "constexpr int NSTAGE = 2;"]],
    "upd_ring4": [[UPD_SRC, UPD_STAGES, "constexpr int NSTAGE = 4;"]],
    "upd_all": [[UPD_SRC] + UPD_ALL],
    "upd_p2ks": [[UPD_SRC, "constexpr int KS2 = 2 * KS;", "constexpr int KS2 = KS;"]],
    "upd_l2_epi": UPD_L2_EPI,
    "upd_lds": [[UPD_SRC] + UPD_LDS],
    "upd_trunc": [[UPD_SRC, "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                   "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;\n",
                   "  split(x, hi, lo);\n"]],
    "upd_fma": [[UPD_SRC, UPD_TILE_MMA, UPD_TILE_FMA]],
    "upd_clk": [
        [UPD_SRC, '#include "tf32_mma.cuh"\n', '#include "tf32_mma.cuh"\n' + CLK_DEFS],
        [UPD_SRC, "  for (int q = 0; q < NSTAGE - 1; ++q) issue();\n",
         "  long long t_prev = clock64();\n  for (int q = 0; q < NSTAGE - 1; ++q) issue();\n"],
        [UPD_SRC, "    __syncthreads();\n\n    // ---- P1:", "    __syncthreads();\n    CLK(0)\n\n    // ---- P1:"],
        [UPD_SRC, "  auto consume = [&](int q) -> const float* {\n",
         "  long long clk_wait = 0, clk_issue = 0;\n"
         "  auto consume = [&](int q) -> const float* {\n"
         "    const long long c0_ = clock64();\n"],
        [UPD_SRC, "    __syncwarp();\n    issue();\n",
         "    __syncwarp();\n    const long long c1_ = clock64();\n    clk_wait += c1_ - c0_;\n"
         "    issue();\n    clk_issue += clock64() - c1_;\n"],
        [UPD_SRC, "  if (!my_items) zero_dead(0, n_z);\n",
         "  if (!my_items) zero_dead(0, n_z);\n"
         "  if ((threadIdx.x & 31) == 0) {\n"
         "    atomicAdd(&g_clk[7], (unsigned long long)clk_wait);\n"
         "    atomicAdd(&g_clk[8], (unsigned long long)clk_issue);\n  }\n"],
        [UPD_SRC, "    // |Vv| into s_sv[:, F:]", "    CLK(1)\n    // |Vv| into s_sv[:, F:]"],
        [UPD_SRC, "    __syncthreads();                  // every warp's |Vv|\n",
         "    __syncthreads();                  // every warp's |Vv|\n    CLK(2)\n"],
        [UPD_SRC, "    __syncthreads();                  // every warp's h\n",
         "    __syncthreads();                  // every warp's h\n    CLK(3)\n"],
        [UPD_SRC, "      const float* b1k = b1 + size_t(k) * F3;\n",
         "      CLK(4)\n      const float* b1k = b1 + size_t(k) * F3;\n"],
        [UPD_SRC, "    zero_dead(it * z_per, min(n_z, (it + 1) * z_per));\n",
         "    CLK(5)\n    zero_dead(it * z_per, min(n_z, (it + 1) * z_per));\n    CLK(6)\n"
         "    if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[15], 1ull);\n"],
    ],
    "bwd2_nb2": [[BWD2_SRC, "NB_BLOCKS_PER_SM = 3;", "NB_BLOCKS_PER_SM = 2;"]],
    # row 5's centre kernel with one part of its work left out (wrong
    # results; for where the time goes): the d_dw products, their flush to
    # the block's partial, the d_rbf product, the ring's row copies
    "bwd2_nodw": [[BWD2_SRC, "            mma3(dacc[mt][T], ah, al, dh[T], dl[T]);\n"
                   "            mma3(dacc[mt][T], ch4, cl4, zh[T], zl[T]);\n", ""]],
    "bwd2_noflush": [[BWD2_SRC, "              if (r > R) continue;\n",
                      "              if (r >= 0) continue;\n"]],
    "bwd2_nodrbf": [[BWD2_SRC, "          mma3(dr[nt], ah, al, bh, bl);\n        }\n        if constexpr",
                     "        }\n        if constexpr"]],
    "bwd2_noring": [[BWD2_SRC, "        issue(kn, cgn, rtn, (u + CT_STAGES - 1) % CT_STAGES);\n", ""]],
    "bwd2_clk": [
        [BWD2_SRC, "using namespace tf32mma;\n", "using namespace tf32mma;\n" + CLK_DEFS],
        [BWD2_SRC, "  for (int q = q0; q < q1; ++q) {\n",
         "  long long t_prev = clock64();\n  for (int q = q0; q < q1; ++q) {\n"],
        [BWD2_SRC, "    const int n_rt = Lp / CT_ROWS;\n", "    CLK(0)\n    const int n_rt = Lp / CT_ROWS;\n"],
        [BWD2_SRC, "      // W_T = RBF . dw_T and G_T", "      CLK(1)\n      // W_T = RBF . dw_T and G_T"],
        [BWD2_SRC, "      // elementwise, on the accumulator fragments",
         "      CLK(2)\n      // elementwise, on the accumulator fragments"],
        [BWD2_SRC, "      // d_rbf (16 edges x R) = dwpre", "      CLK(3)\n      // d_rbf (16 edges x R) = dwpre"],
        [BWD2_SRC, "      // d_dw_k (R + 1 x 24 channels) += RBF^T",
         "      CLK(4)\n      // d_dw_k (R + 1 x 24 channels) += RBF^T"],
        [BWD2_SRC, "      if (rt == n_rt - 1) {\n        // the centre's d_dw",
         "      CLK(5)\n      if (rt == n_rt - 1) {\n        // the centre's d_dw"],
        [BWD2_SRC, "      __syncwarp();\n    }\n    cp_async_wait<0>();\n    __syncthreads();\n",
         "      __syncwarp();\n      CLK(6)\n      if (lane == 0) atomicAdd(&g_clk[15], 1ull);\n"
         "    }\n    cp_async_wait<0>();\n    __syncthreads();\n"],
        [BWD2_SRC, "n_pad + i) * M + m] = v;\n    }\n  }\n}",
         "n_pad + i) * M + m] = v;\n    }\n    CLK(7)\n  }\n}"],
    ],
    "one_pass": [[MMA_HDR, MMA3, "  mma_tf32(d, ah, bh);"]],
    "no_mma": [[MMA_HDR, MMA3, "  d[0] += __uint_as_float(ah[0] ^ al[1] ^ bh[0] ^ bl[1]);"]],
    "no_act": [[HDR, "float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }",
                "float sigmoid(float x) { return x; }"]],
    "fwd_4x3": [[HDR, FWD_PLAN, FWD_PLAN.replace("WARPS = 6", "WARPS = 4")
                 .replace("PER_SM = 2", "PER_SM = 3")]],
    "bwd_8x1": [[BWD_SRC, BWD_PLAN, BWD_PLAN.replace("WARPS = 4", "WARPS = 8")
                 .replace("PER_SM = 2", "PER_SM = 1")]],
    "eam_clk": [
        [EAM_SRC, "#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + EAM_CLK_DEFS],
        [EAM_SRC, "  float* s_a = s_z + N;\n", "  float* s_a = s_z + N;\n"
         "  long long t_prev = clock64(), clk_acc[6] = {}, n_centres = 0;\n"],
        [EAM_SRC, "    w.tail = w.done = w.qh = w.qt = 0;\n",
         "    w.tail = w.done = w.qh = w.qt = 0;\n    CLK(0)\n"],
        [EAM_SRC, "        __syncwarp();\n        // their distances",
         "        __syncwarp();\n        CLK(1)\n        // their distances"],
        [EAM_SRC, "          w.tail += __popc(bal);\n          __syncwarp();\n",
         "          w.tail += __popc(bal);\n          __syncwarp();\n          CLK(2)\n"],
        [EAM_SRC, "            evaluate(w, 32);\n            retire(w, rho_out, ep_out);\n",
         "            evaluate(w, 32);\n            CLK(3)\n"
         "            retire(w, rho_out, ep_out);\n"
         "            CLK(4)\n"],
        [EAM_SRC, "          ep_out[row0 + i] = 0.f;\n        }\n",
         "          ep_out[row0 + i] = 0.f;\n        }\n        CLK(5)\n        ++n_centres;\n"],
        [EAM_SRC, "    retire(w, rho_out, ep_out);\n  }\n}",
         "    retire(w, rho_out, ep_out);\n  }\n"
         "  if (lane == 0) {\n    for (int k = 0; k < 6; ++k) atomicAdd(&g_clk[k], "
         "(unsigned long long)clk_acc[k]);\n"
         "    atomicAdd(&g_clk[15], (unsigned long long)n_centres);\n  }\n}"],
    ],
    "clk": [
        [HDR, "using namespace tf32mma;\n", "using namespace tf32mma;\n" + CLK_DEFS],
        [HDR, "  const WorkList list{work, n_items, cs.s_item};\n  __syncthreads();\n",
         "  const WorkList list{work, n_items, cs.s_item};\n  __syncthreads();\n"
         "  long long t_prev = clock64();\n"],
        [HDR, "rows_of(item - c * n_pad));\n    __syncthreads();\n",
         "rows_of(item - c * n_pad));\n    __syncthreads();\n    CLK(0)\n"],
        [HDR, "      tile_pre(s, ai, aj2c, be, e0, r, p);\n",
         "      tile_pre(s, ai, aj2c, be, e0, r, p);\n      CLK(1)\n"],
        [HDR, "      tile_hidden<8>(s.wg, s.vec + F, p, hg);\n",
         "      tile_hidden<8>(s.wg, s.vec + F, p, hg);\n      CLK(2)\n"],
        [HDR, "out[4 * j + 3]);\n      }\n    }\n    list.post(next);\n    __syncthreads();\n",
         "out[4 * j + 3]);\n      }\n      CLK(3)\n"
         "      if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[15], 1ull);\n    }\n"
         "    list.post(next);\n    __syncthreads();\n    CLK(4)\n"],
        [HDR, "    item = following;\n  }\n  list.leave();\n}\n\n}  // namespace chgconv",
         "    item = following;\n    CLK(5)\n  }\n  list.leave();\n}\n\n"
         "}  // namespace chgconv"],
        [BWD_SRC, "  const WorkList list{work, n_items, cs.s_item};\n  __syncthreads();\n",
         "  const WorkList list{work, n_items, cs.s_item};\n  __syncthreads();\n"
         "  long long t_prev = clock64();\n"],
        [BWD_SRC, "    const float* gi = gagg + size_t(item) * F;\n",
         "    const float* gi = gagg + size_t(item) * F;\n    CLK(6)\n"],
        [BWD_SRC, "      float hc[8][4], hg[8][4];\n",
         "      CLK(7)\n      float hc[8][4], hg[8][4];\n"],
        [BWD_SRC, "      tile_hidden<8>(s.wg, s.vec + F, p, hg);\n",
         "      tile_hidden<8>(s.wg, s.vec + F, p, hg);\n      CLK(8)\n"],
        [BWD_SRC, "      tile_dpre<0>(s.wc, hc, s_dsp, p);\n",
         "      CLK(9)\n      tile_dpre<0>(s.wc, hc, s_dsp, p);\n"],
        [BWD_SRC, "      store_pre_rows(dpre_out, e0, r, p, Identity{});\n",
         "      store_pre_rows(dpre_out, e0, r, p, Identity{});\n      CLK(10)\n"],
        [BWD_SRC, "      // g_be = dpre . w2^T", "      CLK(11)\n      // g_be = dpre . w2^T"],
        [BWD_SRC, "      if (WANT_W) {\n        // the tile's LayerNorm cotangent sums",
         "      CLK(12)\n      if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[14], 1ull);\n"
         "      if (WANT_W) {\n        // the tile's LayerNorm cotangent sums"],
        [BWD_SRC, "    list.post(next);\n    __syncthreads();\n",
         "    list.post(next);\n    __syncthreads();\n    CLK(13)\n"],
    ],
}


def variant_kernels(edits) -> tuple:
    """The kernels a variant's edits reach; all of them for the sources."""
    if not edits:
        return ALL_KERNELS
    return tuple(k for k in ALL_KERNELS
                 if any(k in FILE_KERNELS.get(f, ()) for f, _, _ in edits))


def build_variants(spec: dict) -> dict:
    """Apply each variant's edits to a copy of csrc/ and build the libraries
    they reach, all nvcc processes at once. Returns {(variant, kernel):
    path}."""
    import chip_smoke as cs
    from surface_sampling_tpu_torch.ops import cuda_build as cb

    root = cb.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for name, edits in spec.items():
        src = root / name
        shutil.copytree(cb.CSRC, src)
        missing = [old[:60] for f, old, _ in edits
                   if old is not None and old not in (src / f).read_text()]
        if missing:
            print(f"[variants] {name}: edit no longer matches, left out: {missing}")
            continue
        for f, old, new in edits:
            text = (VARIANT_DIR / new).read_text() if old is None else \
                (src / f).read_text().replace(old, new)
            (src / f).write_text(text)
        for k in variant_kernels(edits):
            out = src / f"lib{k}.so"
            procs.append((name, k, out, subprocess.Popen(
                [cb._nvcc(), *cb.NVCC_FLAGS, "-o", str(out), str(src / f"{k}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, k, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[variants] {name} {k}: build failed\n{log[-2000:]}")
            continue
        libs[(name, k)] = out
        print(f"[ptxas] {name} {k} {json.dumps(cs.entry_registers(log))}")
    return libs


def use_variant(libs: dict, name: str) -> None:
    """Load the variant's libraries, and the sources' for the kernels it
    does not reach."""
    from surface_sampling_tpu_torch.ops import cuda_build as cb

    for k in ALL_KERNELS:
        lib = ctypes.CDLL(str(libs.get((name, k), libs[("base", k)])))
        fn = getattr(lib, k)
        n_ptr, n_int = cb.ARITY[k]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        cb._LIBS[k] = lib


def variant_cases(dev) -> dict:
    """{kernel: {case: fn}} at chip_smoke.py's shapes (fn returns the
    outputs to compare)."""
    import chip_smoke as cs
    from port_compare import sc_layer1_args, sc_update_args, train_bwd2_args
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.state import realize_alive, realize_positions
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.ops import eam_kernels as ek
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam
    from surface_sampling_tpu_torch.systems import (
        au110_eam,
        cu100_eam,
        lamno3_001_chgnet,
        srtio3_001_painn,
    )

    sys_a = lamno3_001_chgnet(device=dev)
    sys_b = lamno3_001_chgnet(relax=RelaxConfig(steps=cs.CHG_RELAX_STEPS), device=dev)
    sys_c = lamno3_001_chgnet(supercell=(3, 3), device=dev)
    a, _, _ = cs.chgnet_conv_case(sys_a, cs.CHG_CHAINS, seed=10)
    b, rev, _ = cs.chgnet_conv_case(sys_b, cs.CHG_RELAX_CHAINS, seed=12, relaxed=True)
    c, _, _ = cs.chgnet_conv_case(sys_c, cs.CHG_3X3_CHAINS, seed=11)
    band = sys_c.potential.band
    gagg = torch.randn(b[0].shape[:2] + (ck.KERNEL_F,), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(12))
    g = torch.Generator(device=dev).manual_seed(3)
    C, K, n_pad, M, R, F = 16, 1, 64, 64, 24, 128      # a training step's force pass
    envm = (torch.rand((C, n_pad * M), generator=g, device=dev) < 0.6).float()
    train = (torch.randn((C, K, n_pad, 3 * F), generator=g, device=dev),
             torch.randn((C, K, n_pad, 3 * F), generator=g, device=dev),
             torch.randn((C, n_pad * M, R), generator=g, device=dev), envm,
             torch.randint(0, n_pad, (C, n_pad * M), generator=g, device=dev,
                           dtype=torch.int32),
             torch.randn((C, 3, n_pad, M), generator=g, device=dev),
             torch.randn((K, R, 3 * F), generator=g, device=dev),
             torch.randn((K, 3 * F), generator=g, device=dev))
    cu = cu100_eam(fast=True, device=dev)
    cu_pot = ek.make_eam_kernel_potential(builtin_eam("Cu_u3"), cu.static_nbr, device=dev)
    au = au110_eam(device=dev)
    au_pot = ek.make_eam_kernel_potential(builtin_eam("Au_u3"), build_static_neighbor_table(
        au.spec, builtin_eam("Au_u3").cutoff, relax_slack=0.05), device=dev)

    def eam_args(system, pot, n_chains, seed):
        ss = cs._eam_states(system.spec.n_sites, n_chains, seed, dev)
        d = system.run.d
        return (realize_positions(d, ss).contiguous(), realize_alive(d, ss).float(), pot.pairs,
                pot.cheb)

    cu_args = eam_args(cu, cu_pot, cs.CU_MC_CHAINS, 32)
    au_args = eam_args(au, au_pot, cs.EAM_AU_CHAINS, 31)
    sys_sc = srtio3_001_painn(supercell=(2, 2), device=dev)
    l1 = sc_layer1_args(sys_sc, dev, N_CHAINS)
    upd_sc = sc_update_args(sys_sc, dev, N_CHAINS)
    rigid = {x[0]: x[3] for x in cs.kernel_cases(srtio3_001_painn(device=dev), dev)}
    bwd2, bwd2_cots, bwd2_rev = train_bwd2_args(dev)
    bwd2_cw = (bwd2[6], bwd2[7])
    return {
        "painn_message_l1_banded": {"row 6 2x2": lambda: pk.painn_message_l1_banded(*l1)},
        "painn_message_l1": {"row 1 1x1": lambda: pk.painn_message_l1(
            *rigid["painn_message_l1"])},
        "painn_update_fused": {
            "row 3 1x1": lambda: pk.painn_update_fused(*rigid["painn_update_fused"]),
            "row 3 2x2": lambda: pk.painn_update_fused(*upd_sc)},
        "painn_message_bwd2": {
            "row 5 train": lambda: pk.painn_message_bwd2(*bwd2, *bwd2_cots, rev=bwd2_rev),
            "row 5 train c_dw": lambda: pk.painn_message_bwd2(*bwd2, *bwd2_cots, *bwd2_cw,
                                                              rev=bwd2_rev)},
        "chgnet_conv": {"row 10 A": lambda: (ck.chgnet_conv(*a),),
                        "row 10 B": lambda: (ck.chgnet_conv(*b),)},
        "chgnet_conv_banded": {"row 11 C": lambda: (ck.chgnet_conv_banded(*c, band),)},
        "chgnet_conv_bwd": {"row 12 B": lambda: ck.chgnet_conv_bwd(*b, gagg, rev=rev)[:4]},
        "painn_message_fused": {"row 2 1x1": lambda: pk.painn_message_fused(
                                    *rigid["painn_message_fused"]),
                                "row 2 train": lambda: pk.painn_message_fused(*train)},
        "eam_rho_ep": {"row 13 Cu": lambda: ek.eam_rho_ep(*cu_args),
                       "row 13 Au": lambda: ek.eam_rho_ep(*au_args)},
    }


def variants_main(args: list) -> int:
    """--variants: the named built-in variants (all with none named), or
    those of --spec FILE, timed in turns beside the sources on the cases of
    the kernels each reaches."""
    import chip_smoke as cs

    if args[:1] == ["--spec"]:
        spec = {"base": [], **json.loads(Path(args[1]).read_text())}
    else:
        spec = {n: VARIANTS[n] for n in ["base"] + [a for a in args if a != "base"]} if args \
            else VARIANTS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build_variants(spec)
    kernels = {n: variant_kernels(spec[n]) for n in spec}
    names = [n for n in spec if all((n, k) in libs for k in kernels[n])]

    by_kernel = variant_cases(torch.device("cuda"))
    cases = {case: f for k in ALL_KERNELS for case, f in by_kernel[k].items()}
    mine = {n: [case for k in kernels[n] for case in by_kernel[k]] for n in names}
    use_variant(libs, "base")
    ref = {k: f() for k, f in cases.items()}
    ms = {n: {k: [] for k in mine[n]} for n in names}
    diff = {}
    for rnd in range(2):
        for n in names if rnd == 0 else names[::-1]:
            use_variant(libs, n)
            for k in mine[n]:
                ms[n][k].append(cs._cuda_ms(cases[k], reps=20))
            if rnd == 0:
                # a NaN counts as an infinite difference
                diff[n] = {k: max(float(torch.nan_to_num((x - y).abs(), nan=float("inf")).max())
                                  for x, y in zip(cases[k](), ref[k]))
                           for k in mine[n]}
    for n in names:
        print(f"[variant] {n:10s} " + "  ".join(f"{k} {ms[n][k][0]:.4f} {ms[n][k][1]:.4f}"
                                                for k in mine[n])
              + f"  max diff from base {json.dumps(diff[n])}")
    clk_cases = [("clk", "row 10 A", "chgnet_conv", CLK_FWD, range(0, 6), 15, "tiles"),
                 ("clk", "row 12 B", "chgnet_conv_bwd", CLK_BWD, range(6, 14), 14, "tiles"),
                 ("eam_clk", "row 13 Cu", "eam_rho_ep", CLK_EAM, range(0, 6), 15, "centres"),
                 ("bwd2_clk", "row 5 train", "painn_message_bwd2", CLK_BWD2, range(0, 8), 15,
                  "units"),
                 ("upd_clk", "row 3 2x2", "painn_update_fused", CLK_UPD, range(0, 7), 15,
                  "items")]
    # slots counted inside the phases above, printed apart
    inside = {"upd_clk": {"ring waits (inside P1-P3)": 7, "ring issues (inside P1-P3)": 8}}
    for variant, case, kernel, labels, slots, count, unit in clk_cases:
        if variant in names:
            use_variant(libs, variant)
            lib = ctypes.CDLL(str(libs[(variant, kernel)]))
            buf = (ctypes.c_ulonglong * 16)()
            lib.reset_clk()
            for _ in range(5):
                cases[case]()
            torch.cuda.synchronize()
            lib.read_clk(buf)
            v = np.array(list(buf), dtype=np.float64)
            total = v[list(slots)].sum()
            print(f"[clk] {case}: {v[count] / 5:.0f} {unit} a launch, {total / v[count]:.0f} warp "
                  f"clocks a {unit[:-1]}; share by phase: " + ", ".join(
                      f"{lab} {v[i] / total:.3f}" for lab, i in zip(labels, slots))
                  + "".join(f"; {lab} {v[i] / total:.3f}"
                            for lab, i in inside.get(variant, {}).items()))
    return 0



# ----------------------------------------------------------------------
# --mma-peak: what mma.sync reaches on the card
# ----------------------------------------------------------------------
MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include "tf32_mma.cuh"
using namespace tf32mma;

template <int CH>
__global__ void tf32_kernel(float* out, int iters) {
  float d[CH][4] = {};
  unsigned a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(threadIdx.x * 1e-3f + q) & 0xffffe000u;
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(threadIdx.x * 2e-3f + q) & 0xffffe000u;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CH; ++c) mma_tf32(d[c], a, b);
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void bf16_kernel(float* out, int iters) {
  float d[8][4] = {};
  unsigned a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = 0x3f803f80u + threadIdx.x;
  for (int q = 0; q < 2; ++q) b[q] = 0x3f803f80u + q;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void conv_loop_kernel(float* out, int iters) {
  __shared__ float w[16 * 64];
  for (int x = threadIdx.x; x < 16 * 64; x += blockDim.x) w[x] = x * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float d[16][4] = {};
  float a[4];
  for (int q = 0; q < 4; ++q) a[q] = lane * 1e-2f + q;
  unsigned ah[4], al[4];
  split_all(a, ah, al);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(w + nt * 64 + 2 * lane);
      unsigned bh[2], bl[2];
      split(b.x, bh[0], bl[0]);
      split(b.y, bh[1], bl[1]);
      mma3(d[nt], ah, al, bh, bl);
    }
  float s = 0.f;
  for (int c = 0; c < 16; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_sync_peak(float* out, int which, int blocks, int threads, int iters) {
  switch (which) {
    case 0: tf32_kernel<1><<<blocks, threads>>>(out, iters); break;
    case 1: tf32_kernel<4><<<blocks, threads>>>(out, iters); break;
    case 2: tf32_kernel<8><<<blocks, threads>>>(out, iters); break;
    case 3: bf16_kernel<<<blocks, threads>>>(out, iters); break;
    default: conv_loop_kernel<<<blocks, threads>>>(out, iters); break;
  }
  return int(cudaGetLastError());
}
"""
# (name, mma instructions an iteration, flop an mma)
MMA_CASES = [("tf32 m16n8k8, 1 accumulator a warp", 1, 2048),
         ("tf32 m16n8k8, 4 accumulators", 4, 2048),
         ("tf32 m16n8k8, 8 accumulators", 8, 2048),
         ("bf16 m16n8k16, 8 accumulators", 8, 4096),
         ("the conv loop: 16 accumulators x 3 passes", 48, 2048)]


def mma_peak_main() -> int:
    """--mma-peak: each case of MMA_CASES at 4, 8, 16 and 32 warps an SM."""
    from surface_sampling_tpu_torch.ops import cuda_build as cb

    out_dir = cb.BUILD_DIR / "mma_sync_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_sync_peak.cu").write_text(MMA_SOURCE)
    lib_path = out_dir / "libmma_sync_peak.so"
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC), "-o", str(lib_path),
                    str(out_dir / "mma_sync_peak.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_sync_peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    props = torch.cuda.get_device_properties(0)
    n_sm = props.multi_processor_count
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    out = torch.empty(n_sm * 32 * 32, device="cuda")
    iters = 2000
    for which, (name, per_iter, flop) in enumerate(MMA_CASES):
        for warps in (4, 8, 16, 32):
            threads = min(warps, 8) * 32
            blocks = n_sm * warps * 32 // threads
            lib.mma_sync_peak(out.data_ptr(), which, blocks, threads, 10)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            err = lib.mma_sync_peak(out.data_ptr(), which, blocks, threads, iters)
            e1.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"mma_sync_peak: launch failed with CUDA error {err}")
            s = e0.elapsed_time(e1) / 1e3
            n_mma = blocks * threads // 32 * iters * per_iter
            print(f"[mma] {name:42s} {warps:2d} warps an SM: {n_mma * flop / s / 1e12:7.1f} "
                  f"TFLOP/s, {n_mma / s / n_sm / clock_hz:.3f} mma a clock an SM")
    return 0



def main() -> int:
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--variants"]:
        return variants_main(sys.argv[2:])
    if sys.argv[1:2] == ["--mma-peak"]:
        return mma_peak_main()
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
            _by_row(report[name], CHGNET_ROWS)
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
