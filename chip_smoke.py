#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths — semigrand MC on the SrTiO3(001) 2x2 slab
scored by the 3-member PaiNN ensemble, 128 chains, on a rigid lattice and
with every trial state FIRE-relaxed; on the slab tiled 2x2 (496 slots),
rigid, by full evaluation through the banded kernels and by the
delta-energy engine; on the slab tiled 3x3 (1116 slots), relaxed through
the banded message and its backward, and by the warm-started ball-local
relaxation engine; and semigrand MC on the LaMnO3(001) 2x2x3 slab scored by
CHGNet (A: rigid, 64 chains; B: FIRE-relaxed, 8 chains, 10 steps; C: the
slab tiled 3x3, 2484 slots, rigid and banded, 8 chains); and the EAM
systems, Cu(100) 2x2x2 semigrand and Au(110) 2x2 canonical, through the
fused EAM kernel (row 13), the exact, Chebyshev and rigid paths and the
canonical engine; and force-loss training of the PaiNN ensemble on jittered
frames of the slab through the message block's second order (row 5), and
the fine-tuning CLI; and the rest of the MC engine (distance criteria,
multiple-try Metropolis, the delta and local-relax canonical steps, L-BFGS,
symmetric slabs) and the many-body systems GaN(0001) Tersoff and Si(111)
5x5 SW; and the frozen-far-field relaxed engine at campaign C's shape, the
dynamic-geometry delta, parallel tempering and population annealing; and
the chain runs and training sharded over an NCCL world of every card of
the machine, the PaiNN and CHGNet potentials that find their edges by image
search, and the MACE family; and force-loss training of CHGNet (with the
magmom term) and MACE, the fine-tuning CLI for both, and the Pourbaix
campaign on SrIrO3(001) with surface-atom sampling; and the sampling CLI
on the campaigns' own settings files, checkpoints and a bitwise resume
included; and the post-processing of a sampled campaign (latent-space
clustering, GMM and ensemble uncertainty, the structure tools) and the
workflows of examples 04, 05, 07 and 08 — through their entry points on
the card, in sixty-six phases, each printing one line or more:

  1. device     card name, count, and nvidia-smi's name and power limit
  2. build      compiles every kernel from csrc/ (nvcc -Xptxas -v, in parallel);
                registers, spills and static shared memory of each entry function,
                and those of rows 10-12 by entry (a spill fails the run)
  3. kernels    each forward kernel against its plain PyTorch version at the
                rigid path's shapes, with times and bounds; the general
                message (row 2) also bitwise equal to the banded message on
                an identity band, bitwise on repeat, and unchanged by NaN /
                out-of-range values on its dead edges (kernel-contract)
  4. anchor     pristine potential / surface energy on the card
  5. states     random occupancies: card energies vs the CPU plain path
  6. mc         rigid MC, 128 chains x 2 sweeps x 8 steps; launch counts of
                every kernel during that run, throughput, finite energies
  7. bwd        the message backward kernel against its plain version on
                relaxed-path geometry (C = 32, g_dw / g_db requested; g_envm
                on live edges, exactly 0 on dead ones), its time at C = 128,
                its live share, shared memory and two bounds (f32, and the
                radial products at 3 TF32 passes)
  8. forces     energy_and_forces at the compile entry point's inputs: card
                vs the CPU plain path
  9. relaxed    FIRE-relaxed pristine surface energy (the tutorial anchor)
 10. relax-mc   relaxed MC, 128 chains x 1 sweep x 4 steps; launch counts,
                FIRE iterations, throughput, and a bitwise repeat of the run
 11. sc-kernels the banded layer-1, banded general and subset message
                kernels against their plain versions at the 2x2 supercell's
                shapes (128 chains; the subset over the hop balls of random
                per-chain sites, all three layers), with times and bounds
                (rows 7 and 8 also their live share, shared memory a block
                and the bound with the filter at 3 TF32 passes; row 6 its
                live share, species present a centre, shared memory a
                block, a bitwise repeat and NaN on its dead edges); the subset
                kernel over every block bitwise equal to the banded one; the
                banded kernels against the unbanded ones on the same
                geometry in slot order
 12. sc-anchor  pristine 2x2 network energy = 4 x the 1x1 cell's; card vs the
                CPU plain path; banded vs unbanded rigid forward
 13. sc-mc      full-evaluation MC at 2x2, 128 chains x 1 sweep x 8 steps;
                launch counts, throughput, finite energies
 14. inc-mc     delta-engine MC at 2x2, 128 chains x 2 sweeps x 8 steps;
                launch counts, throughput, cached energies vs a fresh full
                evaluation, a bitwise repeat of the run
 15. inc-4x4    the 4x4 supercell (1984 slots), 32 chains x 1 sweep x 8
                steps: delta-engine steps/s vs full-evaluation evals/s
 16. bwd-banded the banded message backward against its plain version at
                the relaxed 3x3 supercell's geometry (16 chains, g_dw / g_db
                requested, the plain version on chunks of chains; g_envm as in
                7), its time, live share and bounds; against the unbanded
                backward on the same geometry in slot order
 17. sc-relax   the relaxed 3x3 cell: card vs the CPU plain path (one member:
                energies, forces and a short relaxation), banded vs unbanded
                forces, the FIRE-relaxed pristine surface energy
 18. sc-relax-mc relaxed MC at 3x3, 16 chains x 1 sweep x 4 steps; launch
                counts (the banded kernels only), FIRE iterations,
                throughput, a bitwise repeat
 19. local-relax warm-started ball-local relaxation MC at 1x1 (128 chains)
                and 3x3 (16 chains) beside the full relaxed path from the
                same start states: moves/s vs evals/s, FIRE iterations,
                outside-ball slots unchanged, carried energies vs a fresh
                evaluation, a bitwise repeat
 20. chgnet-kernel the three CHGNet atom-conv kernels against their plain
                versions at this slice's shapes (row 10 at path A's, row 11
                at path C's, row 12 at path B's, with and without the weight
                cotangents, a bitwise repeat of each), with times, bounds
                (also with the products at 3 TF32 passes), and the live and
                computed shares of the edge slots; then the three at M = 160
                slots a centre (max_neighbors=160: the kernels' 256-slot
                instantiation) against their plain versions
 21. chgnet-anchor the golden cases of tests/data/chgnet_golden.json at the
                JAX test's tolerances; the pristine system card vs CPU
 22. chgnet-mc  path A, 64 chains x 2 sweeps x 8 steps: launch counts (row
                10 four per evaluation), throughput, finite energies
 23. chgnet-forces card vs CPU energy and forces at the entry inputs
 24. chgnet-relax-mc path B, 8 chains x 1 sweep x 4 steps of 10 FIRE
                iterations: launch counts of rows 10 and 12, FIRE iterations,
                throughput, a bitwise repeat; one relaxed state card vs CPU
 25. chgnet-3x3 path C, 8 chains x 1 sweep x 8 steps: the band, launch
                counts (row 11 only), throughput; banded vs unbanded energies
 26. eam-build  the Cu(100) and Au(110) systems: exact, cheb, rigid and
                kernel potentials (the kernel's static tables at 0.05 A slack)
 27. eam-kernel row 13 against its plain version at Cu (16,384 chains, the
                shape of cu-mc, the row's numbers; and 8,192) and Au (1,024),
                rho and ep each within 1e-4 x max|plain|, a bitwise repeat,
                the same bits with NaN on dead pairs and dead slots, kernel
                vs cheb energies; times and bounds
 28. eam-anchor the Cu pristine pin and the Au(110) ground state -79.0349 eV
                by every path; card vs the CPU plain path
 29. cu-mc      semigrand Cu through the kernel potential, 16,384 chains x 8 x
                32 steps (row 13 once per evaluation), beside make_eam_rigid
 30. au-canonical au110_eam()'s canonical run at 1,024 chains (exact splines)
                and through the kernel potential: n_ads 6, ground state,
                bitwise repeat, row 13 once per state evaluation
 31. cu-relax-mc relaxed Cu (cheb, autograd forces) at 1,024 chains x 4
                steps: bitwise repeat, card vs CPU, the kernel refusing to
                relax
 32. bwd2       row 5 against its plain version at the training path's
                shapes (16 frames, the slab's real geometry, one member a
                launch, for each of the 3; and the 3 stacked as an extra),
                all nine outputs (d_envm on the live slots, exactly 0 on the
                dead ones), with c_dw / c_db zero (the skip) and not, a
                bitwise repeat; times, the live share and two bounds over
                live edges (f32, and the radial products at 3 TF32 passes)
 33. train-grad one member, 2 frames: a training step's loss and every
                parameter gradient, card vs the CPU plain path
 34. train      the main training path: the 3-member ensemble on 16 frames,
                labels the ensemble mean, 1 + 3 x 4 Adam steps of one
                trajectory; structures/s, launches of rows 2 / 4 / 5 per
                step, the loss falling below its start over the timed steps
 35. finetune-cli the port's CLI on the card (--init one member, 2 epochs):
                its four files, the saved model's energies
 36. criteria   make_distance_accept's masks card vs CPU at 1x1 and 2x2;
                metropolis_distance MC by full evaluation at 1x1 (dist-mc)
                and by the delta engine at 2x2 (inc-dist), 128 chains x 8
                steps: no recorded state violates the filter, launch counts
 37. mtm        semigrand MTM (K = 8) on the rigid 1x1, 128 chains x 4 steps
                (steps/s, evaluations/s, launches a step, bitwise repeat);
                canonical MTM (K = 4) on Au(110) through row 13, 1,024
                chains (mtm-canonical: n_ads 6, bitwise repeat)
 38. inc-canonical delta canonical MC at 2x2, 128 chains x 2 x 8 from 8
                adsorbates a chain: n_ads constant, cached vs fresh, bitwise
                repeat, rows 3, 7 and 8; one move from crowded occupancies,
                one- and two-site deltas bitwise a fresh evaluation (the JAX
                delta rule printed beside)
 39. lbfgs-relax the 1x1 with RelaxConfig(method="lbfgs"): the relaxed
                pristine energy, one state card vs CPU beside the card's own
                response to a 1e-6 A perturbation, relaxed MC at 32 chains x
                2 (force calls and line-search steps a move, rows 2 / 4,
                bitwise repeat); local-relax-canonical: the local-relax
                canonical step at 1x1, 128 chains x 4
 40. gan        gan0001_tersoff(): the tutorial slab anchor (-144.059 eV),
                card vs CPU, canonical MC exact (512) and fast (8,192) with
                n_ads constant and a bitwise repeat, FIRE-relaxed at 64
 41. si         si111_sw(): the SW85 pristine pin, fast vs exact, card vs
                CPU, semigrand MC exact (512) and fast (2,048), relaxed at
                64 under SW85 and a modified SW (relax_model=), the JAX
                test's dual-potential check
 42. symmetric  a mirrored Cu(100) slab under exact EAM, rigid and
                FIRE-relaxed, 1,024 chains, card vs CPU
 43. ff-relax   the frozen-far-field relaxed engine at campaign C's shape
                (relaxed 2x2, 20 FIRE steps, one-hop balls, 16 chains): init
                launches (rows 2, 4), outside-ball slots unchanged, 2 x 8
                semigrand moves (moves/s, FIRE iterations of a ball, row 2
                once per layer and move), bitwise repeat, carried vs fresh;
                4 canonical moves; at 1x1 one move card vs CPU and the
                full-ball move vs the full relaxed path
 44. inc-dynamic the 2x2 delta engine with static_geometry="off": crowded
                deltas bitwise fresh, 128 chains x 2 x 8 (rows 3, 7, 8),
                cached = fresh, bitwise repeat, steps/s beside the static
                delta's
 45. temper     example 06: Au(110) through row 13, 16 replicas, 30 rounds of
                8 steps: swap rates, energy multisets kept, bitwise repeat;
                inc-temper: the 2x2 delta engine tempered, 16 x 6 rounds,
                cached = fresh after the run
 46. pa         example 10: Cu(100) through row 13, 2,048 chains, 10 burn-in
                sweeps, 16 temperatures 2.0 -> 0.35, threshold 0.9: ESS / C,
                sum dlogZ, bitwise repeat
 47. shard      an NCCL world of one spawned rank per card (at most 4; a
                FileStore in a temporary directory): the flagship rigid 1x1
                (128 chains x 2 x 8) sharded over chain_mesh and over
                pod_mesh(1, world), Cu(100) through row 13 (16,384 chains)
                sharded, each against the unsharded run with the same
                generator (bitwise at world 1, else occupancies equal and
                energies within 1e-5 relative); the sharded ensemble energy
                against ensemble_apply; one data-parallel and one
                ensemble-sharded train step on [train]'s 16 frames against
                Trainer.step (bitwise at world 1; beyond, the clipped mean
                gradients and the loss within 1e-5 of each leaf's max and
                relative); evals/s and structures/s beside the card's
                name and power limit (no multi-GPU rate at world 1); then
                finetune --mesh 1 on the card (a world of one made and ended
                by the CLI)
 48. image-edges the PaiNN and CHGNet potentials without a static table
                (edges by image search every call): the flagship pristine
                anchor, random states vs the static-table path (5e-3 eV) and
                card vs CPU (1e-3 eV), relaxed MC at 128 chains x 1 x 4
                (rows 2 and 4) bitwise on repeat; ensemble_forces_std card vs
                CPU; CHGNet LaMnO3 pristine -405.206 eV, rigid (64 chains) and
                10-step relaxed (8 chains) runs (rows 10 and 12)
 49. mace       init_mace at the default width for l_max 2 and 3, layer-local
                and equivariant messages, on the flagship 1x1: card vs CPU
                energies and forces, a random rotation, static table vs image
                search, rigid MC at 128 chains x 2 x 8 (evals/s), relaxed MC
                at 16 chains bitwise on repeat (evals/s, peak memory)
 50. chgnet-bwd2 grad-of-grad through the CHGNet atom conv (row 10 forward,
                row 12 first order, the fixed-order double VJP) on the
                training frames' atom graph (F = 64, M = 96) against the same
                with the plain versions on the card, bitwise on repeat
 51. chgnet-train the LaMnO3 checkpoint at full width on 16 jittered frames
                labelled by itself, from its perturbed parameters, magmom
                term on: card vs CPU on 2 frames, 1 + 3 x 4 Adam steps
                (structures/s, peak memory, rows 10 / 12 a step), the loss
                falling
 52. mace-train a random MACE at the default width on [train]'s frames: card
                vs CPU, structures/s, peak memory
 53. finetune-families the CLI with --family chgnet (--init the checkpoint,
                --magmom-weight 0.5) and --family mace: each saved model
                gives the energies of the same training in-process
 54. pourbaix-mc campaign pourbaix_sriro through the library: the CIF, the
                Pourbaix atoms, surface-atom sampling (55 sites, 222 slots),
                the CHGNet checkpoint over the static table; the prefilled and
                4 random states card vs CPU, 32 chains x 4 x 48 annealed
                metropolis_distance steps (evals/s, row 10 four times an
                evaluation, bitwise repeat)
 55. cli-campaign-a campaign A's settings file (campaigns/srtio3_2x2: 2x2,
                32 chains, incremental, metropolis_distance, t_min) through
                cli.sample_surface, cut to 6 sweeps in chunks of 2: exact
                launches of rows 3 / 6 / 7 / 8, steps/s and the PhaseTimer
                split; 4 sweeps resumed to 6 bitwise the uninterrupted tail;
                checkpointed vs fresh energies and card vs CPU (1e-3 eV)
 56. cli-pourbaix campaign pourbaix_sriro's settings through
                cli.sample_pourbaix_surface, cut to 2 sweeps in chunks of 1:
                row 10 launches, a bitwise repeat, the prefilled state and
                the first sweep card vs CPU (1e-3 eV)
 57. cli-predict cli.predict on phase 55's best CIF with the flagship
                ensemble, card vs CPU (1e-3 eV, 1e-3 eV/A)
 58. cli-native runtime.native's g++ library on the card machine: the XYZ
                writer byte for byte the Python one, cell-list counts
 59. cli-ff     campaign C's settings (frozen-far-field relax) cut to 1 x 4:
                moves/s, carried energies vs a fresh full-cell evaluation of
                the carried geometry (5e-3 eV)
 60. cluster-cli cli.clustering on campaign A's history (every 100th sweep,
                576 states) with the flagship ensemble, --metric energy then
                gmm, maxclust 8: structures/s, row-2 launches, clusters and
                selections, the EM's iterations and log-likelihood; a bitwise
                repeat, one representative a cluster, 4 structures card vs
                CPU (embeddings 1e-4 x max, energies 1e-3 eV)
 61. uncertainty the torch EM on every per-atom embedding of those states
                (~2e5 x 128, chunk 4096, 8 components): time, iterations,
                peak memory, a bitwise refit, card vs CPU on 20,000 rows
                (1e-4 relative), system_mean NLL; ensemble_forces_std on 32
                states (rows 2, 4), card vs CPU (1e-3 eV/A)
 62. structure-tools cut_surfaces, filter_stoichiometries, perturb_structures
                --settings (flagship) and create_surface_formation_entries
                (the Pourbaix campaign's CHGNet, plain and --relax --mp2020
                --aqueous --oh-correction): card vs CPU, corrections equal
 63. ex04       example 04: flagship rigid MC, embed, cluster, select; bitwise
 64. ex05       example 05: slab, sites, supercell slab (host); repeat equal
 65. ex07       example 07: Pourbaix atoms, toy IrO2 with LJ, 10 sweeps;
                prefilled states card vs CPU, bitwise repeat
 66. ex08       example 08: 2 active-learning rounds at its widths; the loss
                falls, the dataset grows by the clusters, bitwise repeat

Then it prints one JSON line {"kernels": [...]} (per kernel: source, the
TPU kernel it replaces, launches on its main path — the rigid run for the
1x1 forward kernels, the relaxed run for the backward, the 2x2 full
evaluation run for the banded kernels, the delta run for the subset kernel,
the relaxed 3x3 run for the banded backward, paths A, B and C for the CHGNet
rows 10, 12 and 11, the Cu semigrand run for row 13, the training runs for
row 5, every path's count under launches_by_path, phases 36-39's,
43-46's, 47-49's, 50-54's, 55-59's and 60-66's paths included — max abs error, ms, plain_ms,
bound_ms, bound_by, library_ms), the nvidia-smi line again, and last the
JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero. Without a CUDA device it exits 1
and prints no result.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
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
# TF32 on the tensor cores (dense): the message backward's radial products
# run there as 3 TF32 passes (3xTF32), so its second bound counts them
# three times at this rate and the rest at PEAK_F32_FLOPS
PEAK_TF32_FLOPS = 495e12
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
# supercells: the 2x2 tiling's paths at the flagship's chain count; the 4x4
# tiling, where every layer's hop ball is a strict subset of the cell, at 32
SC_SWEEPS, INC_SWEEPS = 1, 2
SC44_CHAINS = 32
# the plain banded and subset messages hold (C, K, E, 3F) tensors, 18.7 GB
# each at 2x2 and 128 chains: they run on chunks of chains (chains are
# independent); the plain versions of rows 1-3 run whole
PLAIN_CHUNK = 16
# the relaxed 3x3 supercell (1116 slots; its relax table bands from 3x3 up)
# at the chain count of the JAX package's relaxed-supercell bench; the plain
# banded backward holds ~10 (C, K, E, 3F) tensors, 3.3 GB per chain
SC_RELAX_CHAINS = 16
PLAIN_BWD_CHUNK = 4
# FIRE steps of the 3x3 card-vs-CPU relaxation (the CPU plain path takes
# seconds per force call at this size); relaxed results are held to the
# tolerances the JAX package holds its own two topology modes to (FIRE
# amplifies summation-order noise; a 3x3 cell scores ~2.6e3 eV, whose f32
# spacing is 2.4e-4 eV)
SC_RELAX_CPU_STEPS = 3
RELAXED_E_TOL, RELAXED_POS_TOL = 5e-3, 1e-3
# steps of the local-relax runs and of the full relaxed runs beside them
LOCAL_SWEEP_SIZE = 4
# CHGNet on LaMnO3(001): path A, rigid 1x1 (276 slots), at the chain count
# of the JAX package's chgnet bench row; path B, FIRE-relaxed 1x1 with the
# example configuration's 10 steps and 8 chains; path C, the rigid 3x3
# supercell (2484 slots, banded) at the JAX package's chgnet_3x3super count.
# The plain conv holds (C, E, 2F) tensors, 0.9 GB per 64 chains at 1x1 and
# per 8 chains at 3x3: it runs on chunks of chains.
CHG_CHAINS, CHG_RELAX_CHAINS, CHG_3X3_CHAINS = 64, 8, 8
CHG_RELAX_STEPS = 10
# slots a centre past the atom-conv kernels' 128-slot instantiation:
# lamno3_001_chgnet(max_neighbors=CHG_WIDE_M) runs the 256-slot one
CHG_WIDE_M = 160
CHG_PLAIN_CHUNK, CHG_PLAIN_CHUNK_3X3 = 16, 4
# kernel launches per full rigid evaluation of 3 layers: the 1x1 trunk and
# the banded supercell trunk
RIGID_LAUNCHES = {"painn_message_l1": 1, "painn_message_fused": 2, "painn_update_fused": 3}
BANDED_LAUNCHES = {"painn_message_l1_banded": 1, "painn_message_fused_banded": 2,
                   "painn_update_fused": 3}
# the delta engine's full evaluation (its caches): layer 1 through the banded
# general message too, the body of the subset kernel that recomputes its rows
INC_INIT_LAUNCHES = {"painn_message_fused_banded": 3, "painn_update_fused": 3}


def l1_flops_per_edge(F: int, R: int) -> int:
    """Layer-1 message per contributing edge and member: the filter (2R
    mult-adds + bias + envelope on 2F channels), the phi product, the ds sum
    and three dv mult-adds."""
    return 2 * F * (2 * R + 2) + 2 * F + F + 6 * F


def l1_binned_work(species_ext, envm, nbr, band, M: int, K: int, F: int, R: int,
                   T1: int) -> tuple[int, int, int]:
    """Operations of row 6's species-binned kernel on these inputs (csrc/
    painn_message_l1_banded.cu): 8 (R + 1) per live edge for the bins, and
    8 (R + 1) + 8 per (chain, centre, member, channel, species present
    among the centre's live edges) for the products; with the number of
    live edges and of (chain, centre, species present) triples."""
    from surface_sampling_tpu_torch.ops.banding import edge_window_starts, window_rows

    C = envm.shape[0]
    row, inwin = window_rows(nbr, edge_window_starts(band, M)[None], band)
    live = (envm != 0) & inwin
    sp = torch.where(live, torch.gather(species_ext, 1, row).long(), T1)
    present = torch.zeros((C, envm.shape[1] // M, T1 + 1), device=envm.device)
    present.scatter_(2, sp.view(C, -1, M), 1.0)
    n_live, n_present = int(live.sum()), int(present[..., :T1].sum())
    return n_live * 8 * (R + 1) + K * F * n_present * (8 * (R + 1) + 8), n_live, n_present


def msg_flops_per_edge(F: int, R: int) -> int:
    """General message per contributing edge and member (3F channels)."""
    return 3 * F * (2 * R + 2) + 3 * F + F + 12 * F


def reset_launch_counts() -> None:
    """Zero the launch counters of every kernel of the port."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.ops import eam_kernels as ek
    from surface_sampling_tpu_torch.ops import painn_kernels as pk

    pk.reset_launch_counts()
    ck.reset_launch_counts()
    ek.reset_launch_counts()


def launch_counts() -> dict:
    """The launch counters of every kernel of the port."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.ops import eam_kernels as ek
    from surface_sampling_tpu_torch.ops import painn_kernels as pk

    return {**pk.launch_counts(), **ck.launch_counts(), **ek.launch_counts()}


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


def _best_of(fn, reps: int = 3) -> float:
    """Least wall seconds of ``fn(seed)`` over seeds 1..reps, each ending in
    a synchronize."""
    dt = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        fn(rep + 1)
        torch.cuda.synchronize()
        dt = min(dt, time.perf_counter() - t0)
    return dt


def _gen(seed: int) -> torch.Generator:
    """A fresh generator on the card for one run's draws."""
    from surface_sampling_tpu_torch.core.engine import make_generator

    return make_generator(seed, "cuda")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def update_work(args) -> tuple[int, int, int]:
    """Row 3's operations on these inputs, counting the alive rows only
    (alive != 0; the kernel writes zeros to the others without computing
    them): the products (22 F^2 per alive row and member: [v_0; v_1; v_2] .
    [U | V], [s, |Vv|] . W0, h . W1) and ~30 F elementwise; and the bytes it
    must move: an alive row's s and vcat read, every output row written, the
    mask and the weights once. Returns (products, rest, bytes)."""
    s, vcat, *weights, alive = args
    C, K, n_pad, F = s.shape
    rows = K * int((alive != 0).sum())
    nbytes = 4 * (rows * 4 * F + C * K * n_pad * 4 * F) + _nbytes(*weights, alive)
    return rows * 22 * F * F, rows * 30 * F, nbytes


def layer1_work(args, band, F: int) -> tuple[int, int, int, int]:
    """Row 1 or 6's operations on these inputs (l1_binned_work: the binned
    kernel's count over live edges and species present) and the bytes it
    must move: every slot's envelope, a live edge's rbf row, unit vector,
    neighbour index and species, the weights and tables once, the outputs.
    Returns (operations, bytes, live edges, (chain, centre, species
    present) triples)."""
    species, philt, rbf, envm, nbr, unit, dw2, db2 = args[:8]
    C, R, M, K, T1 = rbf.shape[0], rbf.shape[2], unit.shape[-1], philt.shape[0], philt.shape[1]
    n_pad = unit.shape[2]
    flops, live, present = l1_binned_work(species, envm, nbr, band, M, K, F, R, T1)
    nbytes = 4 * (envm.numel() + live * (R + 5) + C * K * n_pad * 4 * F) + _nbytes(
        philt, dw2, db2, band.win_start)
    return flops, nbytes, live, present


def kernel_cases(sys_, dev):
    """Inputs of the three kernels at the main path's shapes: real edge
    geometry of N_CHAINS random occupancies, the real layer weights, and
    seeded random features for the layer inputs. Each case: (name, wrapper,
    TPU kernel, arguments, which arguments carry the chain axis, operations,
    bytes it must move)."""
    from surface_sampling_tpu_torch.core.state import realize_alive, realize_numbers
    from surface_sampling_tpu_torch.models.painn import species_rows
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.banding import identity_band
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
    R = cfg.n_rbf
    n_live = int((envm != 0).sum())      # edges that contribute (the rest are masked)
    l1_args = (species, rw["philt"], rbf, envm, nbr, unit, rw["dw2"], rw["db2"])
    l1_flops, l1_bytes, _, _ = layer1_work(l1_args, identity_band(n_pad, 8, dev), F)
    # the features drawn in the rows' order: row 2's, then row 3's
    msg_args = (feat(3 * F), feat(3 * F), rbf, envm, nbr, unit, rw["dw"][1], rw["db"][1])
    upd_args = (feat(F), feat(3 * F), up["u_mat"]["w"], up["v_mat"]["w"], up["s_dense0"]["w"],
                up["s_dense0"]["b"], up["s_dense1"]["w"], up["s_dense1"]["b"], alive_f)
    products, rest, upd_bytes = update_work(upd_args)
    return [
        ("painn_message_l1", pk.painn_message_l1, "surface_sampling_tpu/ops/pallas_painn.py:162",
         l1_args, (True, False, True, True, True, True, False, False), l1_flops, l1_bytes),
        ("painn_message_fused", pk.painn_message_fused,
         "surface_sampling_tpu/ops/pallas_painn.py:1100", msg_args,
         (True,) * 6 + (False, False), K * n_live * msg_flops_per_edge(F, R), None),
        ("painn_update_fused", pk.painn_update_fused, "surface_sampling_tpu/ops/pallas_painn.py:333",
         upd_args, (True, True) + (False,) * 6 + (True,), products + rest, upd_bytes),
    ]


def _states(spec, n_chains: int, rng, device):
    """Seeded random occupancies with 75% of the sites empty."""
    ss = rng.integers(0, spec.n_codes, (n_chains, spec.n_sites))
    return torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=device)


def relax_edges(sys_relax, n_chains: int, seed: int):
    """Edges of the relaxed path: the topology selected at the ideal
    geometry of seeded random occupancies, the geometry recomputed at
    positions displaced as a relaxation moves them (0.05 A). Returns the
    edges and the occupancies."""
    from surface_sampling_tpu_torch.core.state import realize_alive, realize_positions

    d, spec, pot = sys_relax.run.d, sys_relax.spec, sys_relax.potential
    rng = np.random.default_rng(seed)
    ss = _states(spec, n_chains, rng, d.device)
    pos, alive = realize_positions(d, ss), realize_alive(d, ss)
    topo = pot.edge_topology(pos, alive)
    noise = torch.as_tensor(rng.normal(0, 0.05, tuple(pos.shape)), dtype=pos.dtype,
                            device=d.device)
    return pot.edges_of(pos + noise, topo), ss


def bwd_case(sys_relax, n_chains: int, seed: int):
    """Inputs of the message backward at the relaxed path's shapes: real
    geometry and layer-2 weights, seeded random features and cotangents."""
    from surface_sampling_tpu_torch.models.painn import prepare_message_geometry

    pot = sys_relax.potential
    cfg, params = pot.cfg, pot.params
    edges, _ = relax_edges(sys_relax, n_chains, seed)
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


def bwd_flops(K: int, n_live: int, F: int, R: int) -> tuple[int, int]:
    """Operations of the message backward (rows 4 and 9) per call, over the
    live edges: the radial products (the filter and the g_rbf product, 3F
    channels x 2R each, per edge and member) and ~49F of elementwise
    products and sums."""
    return K * n_live * 12 * F * R, K * n_live * 49 * F


def bwd_bounds(products: int, rest: int, nbytes: int) -> tuple[float, float, bool]:
    """bound_ms with every operation at the f32 rate; the bound of the
    tensor-core design (products at 3 TF32 passes, the rest at f32); and
    whether operations, not bytes, bound the first."""
    ops_s = (products + rest) / PEAK_F32_FLOPS
    tc_s = 3 * products / PEAK_TF32_FLOPS + rest / PEAK_F32_FLOPS
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), 1e3 * max(bytes_s, tc_s), ops_s > bytes_s


def bwd_smem(R: int, M: int, D: int) -> tuple[int, int]:
    """Dynamic shared memory (bytes) of a centre and a neighbour block of
    rows 4 and 9 on the forces path (no g_dw), as the library's launch asks
    for it."""
    from surface_sampling_tpu_torch.ops.cuda_build import _lib

    size = _lib("painn_message_bwd").painn_message_bwd_smem
    return size(R, M, D, 0, 0), size(R, M, D, 0, 1)


def banded_smem(R: int, M: int, n_blk: int) -> int:
    """Dynamic shared memory (bytes) of a block of rows 7 and 8, as the
    library's launch asks for it."""
    from surface_sampling_tpu_torch.ops.cuda_build import _lib

    return _lib("painn_message_fused_banded").painn_message_banded_smem(R, M, n_blk)


def layer1_smem(R: int, n_blk: int, T1: int) -> int:
    """Dynamic shared memory (bytes) of a block of row 6, as the library's
    launch asks for it."""
    from surface_sampling_tpu_torch.ops.cuda_build import _lib

    return _lib("painn_message_l1_banded").painn_message_l1_banded_smem(R, n_blk, T1)


def layer1_contract(args) -> None:
    """Row 6 on the main path's inputs: bitwise on repeat, and dead edges
    inert (NaN rbf and unit vector on every envm == 0 edge leave ds and dv
    bitwise unchanged); raises otherwise."""
    from surface_sampling_tpu_torch.ops import painn_kernels as pk

    species, philt, rbf, envm, nbr, unit = args[:6]
    C, M = envm.shape[0], unit.shape[-1]
    got = pk.painn_message_l1_banded(*args)
    dead = envm == 0
    nan = float("nan")
    dirty = (species, philt, torch.where(dead[..., None], nan, rbf), envm, nbr,
             torch.where(dead.reshape(C, 1, -1, M), nan, unit), *args[6:])
    for label, out in (("a second launch", pk.painn_message_l1_banded(*args)),
                       ("NaN rbf / unit on dead edges", pk.painn_message_l1_banded(*dirty))):
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise AssertionError(f"painn_message_l1_banded vs {label}: not bitwise equal")
    print(f"[sc-kernel] painn_message_l1_banded bitwise equal to a second launch and with NaN "
          f"rbf / unit on its {int(dead.sum())} dead edges")


def message_fused_contract(args, m: dict) -> str:
    """Row 2 on the main path's inputs: bitwise equal to row 7 on an
    identity band (the banded body it runs), bitwise on repeat, and dead
    edges inert (NaN rbf and unit, out-of-range nbr on every envm == 0 edge
    leave ds and dv bitwise unchanged); raises otherwise. Returns the text
    of its live share, block and shared memory, and the bound with the
    filter at 3 TF32 passes."""
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.banding import identity_band
    from surface_sampling_tpu_torch.ops.cuda_build import _lib

    phi, vcat, rbf, envm, nbr, unit, dw, db = args
    C, K, n_pad, F3 = phi.shape
    M, R = unit.shape[-1], rbf.shape[-1]
    dev = phi.device
    got = pk.painn_message_fused(*args)
    dead = envm == 0
    nan = float("nan")
    far = torch.randint(-2 ** 30, 2 ** 30, nbr.shape, generator=_gen(2), device=dev,
                        dtype=torch.int32)
    dirty = (phi, vcat, torch.where(dead[..., None], nan, rbf), envm,
             torch.where(dead, far, nbr), torch.where(dead.reshape(C, 1, n_pad, M), nan, unit),
             dw, db)
    for label, out in (("a second launch", pk.painn_message_fused(*args)),
                       ("row 7 on an identity band",
                        pk.painn_message_fused_banded(*args, identity_band(n_pad, 16, dev))),
                       ("NaN rbf / unit and out-of-range nbr on dead edges",
                        pk.painn_message_fused(*dirty))):
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise AssertionError(f"painn_message_fused vs {label}: not bitwise equal")
    print(f"[kernel-contract] painn_message_fused bitwise equal to a second launch, to "
          f"painn_message_fused_banded on an identity band, and with NaN rbf / unit and "
          f"out-of-range nbr on its {int(dead.sum())} dead edges")
    n_live = int((~dead).sum())
    products = K * n_live * 6 * (F3 // 3) * R
    _, bound_tc_ms, _ = bwd_bounds(products, m["flops"] - products, m["bytes"])
    lib = _lib("painn_message_fused")
    return (f"bound_tc_ms={bound_tc_ms:.4f} (3xTF32 filter) live_edges={n_live} of "
            f"{envm.numel()} slots (live share {n_live / envm.numel():.4f}) n_blk="
            f"{lib.painn_message_fused_n_blk(n_pad)} shared memory="
            f"{lib.painn_message_fused_smem(R, M, n_pad)} B a block ")


def layer1_unbanded_contract(args, m: dict) -> str:
    """Row 1 on the main path's inputs: bitwise equal to row 6 on an
    identity band (the binned body it runs), bitwise on repeat, and dead
    edges inert (NaN rbf and unit, out-of-range nbr on every envm == 0 edge
    leave ds and dv bitwise unchanged); raises otherwise. Returns the text
    of its live share, species present, block and shared memory."""
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.banding import identity_band
    from surface_sampling_tpu_torch.ops.cuda_build import _lib

    species, philt, rbf, envm, nbr, unit, dw2, db2 = args
    C, n_pad, M, R = species.shape[0], species.shape[1], unit.shape[-1], rbf.shape[-1]
    T1, F = philt.shape[1], philt.shape[2] // 2
    dev = rbf.device
    got = pk.painn_message_l1(*args)
    dead = envm == 0
    nan = float("nan")
    far = torch.randint(-2 ** 30, 2 ** 30, nbr.shape, generator=_gen(3), device=dev,
                        dtype=torch.int32)
    dirty = (species, philt, torch.where(dead[..., None], nan, rbf), envm,
             torch.where(dead, far, nbr), torch.where(dead.reshape(C, 1, n_pad, M), nan, unit),
             dw2, db2)
    for label, out in (("a second launch", pk.painn_message_l1(*args)),
                       ("row 6 on an identity band",
                        pk.painn_message_l1_banded(*args, identity_band(n_pad, 16, dev))),
                       ("NaN rbf / unit and out-of-range nbr on dead edges",
                        pk.painn_message_l1(*dirty))):
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise AssertionError(f"painn_message_l1 vs {label}: not bitwise equal")
    print(f"[kernel-contract] painn_message_l1 bitwise equal to a second launch, to "
          f"painn_message_l1_banded on an identity band, and with NaN rbf / unit and "
          f"out-of-range nbr on its {int(dead.sum())} dead edges")
    _, _, live, present = layer1_work(args, identity_band(n_pad, 8, dev), F)
    lib = _lib("painn_message_l1")
    return (f"live_edges={live} of {envm.numel()} slots (live share {live / envm.numel():.4f}) "
            f"species present per centre {present / (C * n_pad):.3f} (T1={T1}) n_blk="
            f"{lib.painn_message_l1_n_blk(n_pad)} shared memory="
            f"{lib.painn_message_l1_smem(R, n_pad, T1)} B a block (binned operations, f32; no "
            f"tensor-core product, so no bound_tc_ms) ")


def update_contract(args, m: dict, tag: str = "kernel-contract") -> str:
    """Row 3 on these inputs: bitwise on repeat, dead rows exactly 0 and
    inert (NaN s and vcat on every alive == 0 row leave the outputs bitwise
    unchanged); raises otherwise. Returns the text of its alive share,
    tile, shared memory, and the bound with the products at 3 TF32
    passes."""
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.cuda_build import _lib

    s, vcat, *_, alive = args
    C, K, n_pad, F = s.shape
    got = pk.painn_update_fused(*args)
    dead = (alive == 0)[:, None, :, None]
    nan = float("nan")
    dirty = (torch.where(dead, nan, s), torch.where(dead, nan, vcat), *args[2:])
    for label, out in (("a second launch", pk.painn_update_fused(*args)),
                       ("NaN s / vcat on dead rows", pk.painn_update_fused(*dirty))):
        if not all(torch.equal(a, b) for a, b in zip(got, out)):
            raise AssertionError(f"painn_update_fused vs {label}: not bitwise equal")
    if not all(bool((x.masked_select(dead) == 0).all()) for x in got):
        raise AssertionError("painn_update_fused: a dead row is not exactly 0")
    n_alive = int((alive != 0).sum())
    print(f"[{tag}] painn_update_fused bitwise equal to a second launch and with NaN s / vcat "
          f"on its {C * n_pad - n_alive} dead rows of each member, which are exactly 0")
    products, rest, nbytes = update_work(args)
    _, bound_tc_ms, _ = bwd_bounds(products, rest, nbytes)
    lib = _lib("painn_update_fused")
    return (f"bound_tc_ms={bound_tc_ms:.4f} (3xTF32 products) alive_rows={n_alive} of "
            f"{C * n_pad} (alive share {n_alive / (C * n_pad):.4f}) tile rows="
            f"{lib.painn_update_fused_tile_rows(F)} shared memory="
            f"{lib.painn_update_fused_smem(F)} B a block ")


def bwd_errors(name: str, got, ref, envm, names) -> dict:
    """Max abs error of each cotangent of rows 4 / 9 against the plain
    version, each within KERNEL_RTOL x max|plain|, under the dead-edge
    contract: g_envm (index 3) on the edges with envm != 0, and exactly 0
    on the others (where the plain version's value never reaches a
    position)."""
    live = envm != 0
    if bool((got[3][~live] != 0).any()):
        raise AssertionError(f"{name}: g_envm is not exactly zero on dead edges")
    errs = {}
    for k, (n, g, r) in enumerate(zip(names, got, ref)):
        if k == 3:
            g, r = g[live], r[live]
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        errs[n] = err
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"{name} {n}: max abs error {err} exceeds "
                                 f"{KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale}")
    return errs


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
    errs = bwd_errors("painn_message_bwd", got, ref, args[3], names)
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
    C, n_pad, M = N_CHAINS, args[0].shape[2], args[5].shape[-1]
    products, rest = bwd_flops(K, n_live, F, R)
    flops = products + rest
    outs = (args[0], args[1], args[2], args[3], args[5])   # g_* have these shapes
    nbytes = _nbytes(*args, rev, *outs)
    bound_ms, bound_tc_ms, by_ops = bwd_bounds(products, rest, nbytes)
    smem = bwd_smem(args[2].shape[-1], M, rev.shape[-1])
    row = {
        "name": "painn_message_bwd", "route": "cuda",
        "source": "surface_sampling_tpu_torch/csrc/painn_message_bwd.cu",
        "replaces": "surface_sampling_tpu/ops/pallas_painn.py:452",
        "launches": None, "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if by_ops else "bytes",
        "library_ms": None,
        "ms_chains": N_CHAINS, "plain_ms_chains": BWD_CHECK_CHAINS, "ms_at_plain_chains": ms_check,
        "ms_with_g_dw": ms_dw, "live_share": n_live / (C * n_pad * M),
    }
    print(f"[bwd] painn_message_bwd errors {json.dumps(errs)} (tol {KERNEL_RTOL} x max|plain| "
          f"each, g_envm on live edges and 0 on dead ones, C={BWD_CHECK_CHAINS}, g_dw requested) "
          f"bitwise repeat ok; ms={ms:.4f} (C={N_CHAINS}) ms_with_g_dw={ms_dw:.4f} "
          f"ms={ms_check:.4f} plain_ms={plain_ms:.3f} (C={BWD_CHECK_CHAINS}) "
          f"bound_ms={bound_ms:.4f} (f32) bound_tc_ms={bound_tc_ms:.4f} (3xTF32 products) "
          f"live_edges={n_live} of {C * n_pad * M} slots (live share {row['live_share']:.4f}) "
          f"flops={flops:.4e} bytes={nbytes:.4e} shared memory centre/neighbour={smem[0]}/"
          f"{smem[1]} B (D={rev.shape[-1]}) library_ms=null "
          f"(no single PyTorch call computes this fused backward)")
    return row


def forces_phase(sys_gpu, sys_cpu, dev, tag: str = "forces") -> None:
    """8. / 23. energy_and_forces at the compile entry point's inputs (one
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
    print(f"[{tag}] card E={float(eg[0]):.6f} eV cpu E={float(ec[0]):.6f} eV |dE|={de:.3e} eV "
          f"max|F|={float(fg.abs().max()):.4f} eV/A max|dF|={df:.3e} eV/A")
    if not (de <= 1e-3 and df <= 1e-3):
        raise AssertionError(f"card and CPU forces differ: dE {de} eV, dF {df} eV/A")


@contextlib.contextmanager
def counting(pot):
    """Count the force calls (``energy_with_edges``) and fresh-edge energies
    (``energy``) made through ``pot`` and record every FIRE relaxation's
    per-chain iteration counts, while the block runs."""
    from surface_sampling_tpu_torch.core import energy as core_energy

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
    try:
        yield calls, n_steps
    finally:
        pot.energy_with_edges, pot.energy = force_fn, fresh_fn
        core_energy.fire_relax = fire


def relaxed_anchor_phase(sys_relax, dev) -> None:
    """9. The FIRE-relaxed pristine anchor."""
    run = sys_relax.run
    out = run.state_energy_fn(torch.zeros((1, run.spec.n_sites), dtype=torch.int64, device=dev))
    se = float(out.surface_energy[0])
    print(f"[relaxed] pristine FIRE-relaxed potential {float(out.potential_energy[0]):.6f} eV "
          f"surface {se:.6f} eV (tutorial 12.471 +- 0.02)")
    if not (abs(se - 12.471) < 0.02 and not bool(out.oob[0])):
        raise AssertionError(f"relaxed anchor off: {se} eV")


def _n_layers(pot) -> int:
    """Message-passing layers of a potential's model (PaiNN or CHGNet)."""
    return getattr(pot.cfg, "n_layers", None) or pot.cfg.n_conv


def _expect_relaxed(launches, calls, fwd: str, bwd: str, layers: int) -> None:
    """Per force call every layer launches the forward ``fwd`` and the
    backward ``bwd`` once, per fresh-edge energy the forward; no other
    kernel, and never the weight-gradient part."""
    want = {name: 0 for name in launches}
    want[fwd] = layers * (calls["force"] + calls["fresh"])
    want[bwd] = layers * calls["force"]
    if launches != want or calls["force"] == 0:
        raise AssertionError(f"relaxed launch counts {launches} for {calls}, expected {want}")


def relaxed_mc_phase(tag: str, sys_relax, n_chains: int, fwd: str, bwd: str) -> dict:
    """10. / 18. Relaxed MC through the entry points, ``n_chains`` chains x
    RELAX_SWEEPS x RELAX_SWEEP_SIZE steps from pristine chains: launch
    counts (``fwd`` / ``bwd``: the message kernels of its force calls),
    FIRE iterations, finite energies, a bitwise repeat, throughput. Returns
    the launch counts of the run."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, geometric_schedule, make_run_fn
    from surface_sampling_tpu_torch.core.state import realize_positions
    from surface_sampling_tpu_torch.parallel.chains import make_chain_run, relaxed_chain_states

    run, pot = sys_relax.run, sys_relax.potential
    crun = make_chain_run(make_run_fn(run.d, run.state_energy_fn,
                                      EngineConfig(sweep_size=RELAX_SWEEP_SIZE)))
    temps = geometric_schedule(1.0, RELAX_SWEEPS, 0.99)
    states = relaxed_chain_states(run.d, run.state_energy_fn, n_chains)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with counting(pot) as (calls, n_steps):
        out_a, rec_a = crun(states, temps, _gen(0))
        torch.cuda.synchronize()
        launches = launch_counts()
        run_calls = dict(calls)
        iters = torch.stack(n_steps).float()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _expect_relaxed(launches, run_calls, fwd, bwd, _n_layers(pot))
    if not (torch.isfinite(rec_a.energy).all() and torch.isfinite(out_a.energy).all()):
        raise AssertionError(f"[{tag}] non-finite energies in the relaxed MC run")
    out_b, rec_b = crun(states, temps, _gen(0))
    torch.cuda.synchronize()
    same = (torch.equal(out_a.site_state, out_b.site_state)
            and torch.equal(out_a.energy, out_b.energy)
            and torch.equal(out_a.relaxed_positions, out_b.relaxed_positions)
            and torch.equal(rec_a.energy, rec_b.energy)
            and torch.equal(rec_a.positions, rec_b.positions))
    ideal = realize_positions(run.d, out_a.site_state)
    moved = float((out_a.relaxed_positions - ideal).abs().max())
    print(f"[{tag}-repeat] same seed twice: bitwise identical site states, energies and "
          f"relaxed positions: {same} (max relaxed displacement {moved:.4f} A)")
    if not same:
        raise AssertionError(f"[{tag}] the relaxed MC run does not repeat bitwise")
    n_mc = RELAX_SWEEPS * RELAX_SWEEP_SIZE
    dt = _best_of(lambda seed: crun(states, temps, _gen(seed)))
    print(f"[{tag}] slots={sys_relax.spec.n_slots} chains={n_chains} "
          f"sweeps={RELAX_SWEEPS}x{RELAX_SWEEP_SIZE} "
          f"evals/s={n_chains * n_mc / dt:.2f} step_ms={1e3 * dt / n_mc:.3f} "
          f"fire_iters_mean={float(iters.mean()):.3f} fire_iters_max={int(iters.max())} "
          f"force_calls={run_calls['force']} fresh_energies={run_calls['fresh']} "
          f"accept={float(rec_a.accept_rate.mean()):.4f} "
          f"best={float(rec_a.energy.min()):.6f} eV peak_mem={peak_gb:.3f} GB "
          f"launches={json.dumps(launches)}")
    return launches


def _chunked(fn, args, per_chain, chunk):
    """``fn`` over chunks of ``chunk`` chains (axis 0 of the arguments
    marked in ``per_chain``), outputs concatenated."""
    C = next(a.shape[0] for a, pc in zip(args, per_chain) if pc)
    parts = [fn(*(a[c0:c0 + chunk] if pc else a for a, pc in zip(args, per_chain)))
             for c0 in range(0, C, chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _measure(name, fn, plain, args, per_chain, flops, chunk=None, nbytes=None) -> dict:
    """The kernel against its plain version on the same inputs (max abs
    error within KERNEL_RTOL x max|plain|), its time and the plain version's
    by CUDA events, and its bound. The plain version runs in one call, or
    on chunks of ``chunk`` chains where its temporaries would not fit.
    ``nbytes`` is the bytes the function must move; None counts every
    tensor argument and output whole."""
    C = next(a.shape[0] for a, pc in zip(args, per_chain) if pc)
    chunk = chunk or C

    def run_plain():
        return _chunked(plain, args, per_chain, chunk)

    got = fn(*args)
    ref = run_plain()
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    if not err <= KERNEL_RTOL * scale:
        raise AssertionError(f"{name}: max abs error {err} exceeds "
                             f"{KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale}")
    del ref
    ms = _cuda_ms(lambda: fn(*args), reps=10)
    plain_ms = _cuda_ms(run_plain, reps=1, warm=1)
    if nbytes is None:
        nbytes = _nbytes(*(a for a in args if torch.is_tensor(a)), *got)
    return {"err": err, "scale": scale, "ms": ms, "plain_ms": plain_ms, "flops": flops,
            "bytes": nbytes, "plain_chunk_chains": chunk,
            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)}


def _print_measure(tag: str, name: str, m: dict, extra: str = "") -> None:
    print(f"[{tag}] {name} max_abs_err={m['err']:.3e} max_rel_err={m['err'] / m['scale']:.3e} "
          f"(tol {KERNEL_RTOL} x max|plain|) ms={m['ms']:.4f} plain_ms={m['plain_ms']:.3f} "
          f"(chains per plain call {m['plain_chunk_chains']}) bound_ms={m['bound_ms']:.4f} "
          f"flops={m['flops']:.4e} bytes={m['bytes']:.4e} {extra}library_ms=null (no single "
          f"PyTorch call computes this fused block)")


def _row(name, replaces, m: dict, **extra) -> dict:
    by_ops = m["flops"] / PEAK_F32_FLOPS > m["bytes"] / PEAK_BYTES_PER_S
    return {"name": name, "route": "cuda",
            "source": f"surface_sampling_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": None, "max_abs_err": m["err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": "operations" if by_ops else "bytes",
            "library_ms": None, "plain_chunk_chains": m["plain_chunk_chains"], **extra}


def _band_contract(envm, nbr, ws_rows, band, M) -> None:
    """Every selected edge's neighbour rank lies in its centre's window."""
    off = torch.remainder(nbr.long() - ws_rows.long().repeat_interleave(M, dim=-1), band.n_pad)
    bad = int(((envm != 0) & (off >= band.window)).sum())
    if bad:
        raise AssertionError(f"{bad} selected edges lie outside their routing window")


def sc_kernels_phase(sys_sc, dev) -> list:
    """11. Rows 6-8 against their plain versions at the 2x2 supercell's
    shapes: banded static geometry of N_CHAINS seeded occupancies, the real
    layer weights, seeded random features; the subset kernel over each
    chain's hop-ball blocks of a random site at every layer. Then rows 6
    and 7 against rows 1 and 2 on the same geometry in slot order."""
    from surface_sampling_tpu_torch.core.incremental import build_inc_tables, take_blocks
    from surface_sampling_tpu_torch.core.state import realize_alive, realize_numbers
    from surface_sampling_tpu_torch.models.painn import species_rows, with_halo
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.static_edges import (
        build_static_edge_pack,
        static_edge_geometry,
    )

    pot, d, spec = sys_sc.potential, sys_sc.run.d, sys_sc.spec
    pack = pot.static_edge_pack
    band = pack.band
    rng = np.random.default_rng(4)
    ss = rng.integers(0, spec.n_codes, (N_CHAINS, spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
    alive = realize_alive(d, ss)
    (rbf, envm, nbr, unit, n_pad), _ = static_edge_geometry(pack, alive)
    M, n_blocks = unit.shape[-1], n_pad // band.n_blk
    ws_rows = band.win_start[torch.arange(n_pad, device=dev) // band.n_blk]
    _band_contract(envm, nbr, ws_rows, band, M)
    rw, params, cfg = pot.rw, pot.params, pot.cfg
    K, F, R = params["atom_embed"].shape[0], cfg.feat_dim, cfg.n_rbf
    species = species_rows(rw, cfg, realize_numbers(d, ss), n_pad)
    gen = torch.Generator(device=dev).manual_seed(4)
    phi, vcat = (torch.randn((N_CHAINS, K, n_pad, 3 * F), generator=gen, device=dev)
                 for _ in range(2))
    p, ip = band.perm, band.inv_perm
    phi_ext, vcat_ext = with_halo(phi[:, :, p], band.halo, 2), with_halo(vcat[:, :, p], band.halo, 2)
    n_live = int((envm != 0).sum())
    msg_w = (rw["dw"][1], rw["db"][1])
    l1_args = (with_halo(species[:, p], band.halo, 1), rw["philt"], rbf, envm, nbr, unit,
               rw["dw2"], rw["db2"], band)
    l1_pc = (True, False, True, True, True, True, False, False, False)
    msg_args = (phi_ext, vcat_ext, rbf, envm, nbr, unit, *msg_w, band)
    msg_pc = (True, True, True, True, True, True, False, False, False)
    rows, by = [], {}
    # row 6 (species-binned): its operations, and the bytes it must move:
    # every slot's envelope, a live edge's rbf row, unit vector, rank and
    # species, the weights and tables once, the outputs
    T1 = rw["philt"].shape[1]
    l1_flops, l1_bytes, l1_live, l1_present = layer1_work(l1_args, band, F)
    by["l1"] = _measure("painn_message_l1_banded", pk.painn_message_l1_banded,
                        pk.painn_message_l1_banded_plain, l1_args, l1_pc, l1_flops,
                        PLAIN_CHUNK, nbytes=l1_bytes)
    layer1_contract(l1_args)
    by["msg"] = _measure("painn_message_fused_banded", pk.painn_message_fused_banded,
                         pk.painn_message_fused_banded_plain, msg_args, msg_pc,
                         K * n_live * msg_flops_per_edge(F, R), PLAIN_CHUNK)

    tables = build_inc_tables(spec, sys_sc.static_nbr, sys_sc.routing_band, cfg.n_layers)
    sites = torch.as_tensor(rng.integers(0, spec.n_sites, N_CHAINS), device=dev)
    layers = []
    for li, tbl in enumerate(tables.blocks):
        blocks = torch.as_tensor(tbl, dtype=torch.int64, device=dev)[sites]      # (C, NB)

        def take(x, dim):
            return take_blocks(x, blocks, dim, n_blocks)

        envm_s = take(envm, 1)
        sub_args = (phi_ext, vcat_ext, take(rbf, 1), envm_s, take(nbr, 1), take(unit, 2),
                    rw["dw"][li], rw["db"][li], band.win_start[blocks], band)
        live_s = int((envm_s != 0).sum())
        layers.append(_measure("painn_message_subset", pk.painn_message_subset,
                               pk.painn_message_subset_plain, sub_args,
                               (True,) * 6 + (False, False, True, False),
                               K * live_s * msg_flops_per_edge(F, R), PLAIN_CHUNK))
        layers[-1].update(n_live=live_s, n_slots=envm_s.numel())
    by["subset"] = {k: (max if k in ("err", "scale", "plain_chunk_chains") else np.mean)(
        [m[k] for m in layers]) for k in layers[0]}
    replaces = {"l1": "surface_sampling_tpu/ops/pallas_painn.py:240",
                "msg": "surface_sampling_tpu/ops/pallas_painn.py:802",
                "subset": "surface_sampling_tpu/ops/pallas_painn.py:838"}
    names = {"l1": "painn_message_l1_banded", "msg": "painn_message_fused_banded",
             "subset": "painn_message_subset"}
    # rows 7 and 8: the live share of the edge slots they read, a block's
    # shared memory, and the bound with the filter at 3 TF32 passes
    smem = banded_smem(rbf.shape[-1], M, band.n_blk)
    live_slots = {"msg": (n_live, envm.numel()),
                  "subset": (sum(x["n_live"] for x in layers),
                             sum(x["n_slots"] for x in layers))}
    for key in ("l1", "msg", "subset"):
        m = by[key]
        extra, text = {}, ""
        if key == "l1":
            # the per-edge form's f32 bound, for comparison (the work the
            # TPU kernel's design does: 2R x 2F filter products an edge)
            edges_bound_ms = 1e3 * K * n_live * l1_flops_per_edge(F, R) / PEAK_F32_FLOPS
            n_centres = N_CHAINS * n_pad
            extra = {"live_share": l1_live / envm.numel(),
                     "species_present_per_centre": l1_present / n_centres,
                     "per_edge_bound_ms": edges_bound_ms}
            text = (f"live_edges={l1_live} of {envm.numel()} slots (live share "
                    f"{l1_live / envm.numel():.4f}) species present per centre "
                    f"{l1_present / n_centres:.3f} (T1={T1}) shared memory="
                    f"{layer1_smem(R, band.n_blk, T1)} B a block (n_blk={band.n_blk}) "
                    f"per_edge_bound_ms={edges_bound_ms:.4f} (f32, the per-edge sum's work; "
                    f"no tensor-core product, so no bound_tc_ms) ")
        if key == "subset":
            extra = {"blocks_per_layer": list(tables.nb),
                     "ms_by_layer": [x["ms"] for x in layers]}
            text = (f"blocks_per_layer={list(tables.nb)} ms_by_layer="
                    f"{[round(x['ms'], 4) for x in layers]} (mean per launch) ")
        if key in live_slots:
            live, slots = live_slots[key]
            products = K * live * 6 * F * R // (1 if key == "msg" else len(layers))
            _, bound_tc_ms, _ = bwd_bounds(products, m["flops"] - products, m["bytes"])
            text += (f"bound_tc_ms={bound_tc_ms:.4f} (3xTF32 filter) live_edges={live} of "
                     f"{slots} slots (live share {live / slots:.4f}) shared memory={smem} B "
                     f"a block (n_blk={band.n_blk}, W={band.window}) ")
        rows.append(_row(names[key], replaces[key], m, **extra))
        _print_measure("sc-kernel", names[key], m, text)

    # row 8 over every block of the cell, in block order, is row 7 bitwise
    every = torch.arange(n_blocks, device=dev).expand(N_CHAINS, -1)
    sub = pk.painn_message_subset(*msg_args[:8], band.win_start[every].contiguous(), band)
    full = pk.painn_message_fused_banded(*msg_args)
    same = all(torch.equal(a, b) for a, b in zip(full, sub))
    print(f"[sc-subset-vs-full] painn_message_subset over all {n_blocks} blocks of each of "
          f"{N_CHAINS} chains vs painn_message_fused_banded on the 2x2 geometry: bitwise equal: "
          f"{same}")
    if not same:
        raise AssertionError("painn_message_subset over every block differs from "
                             "painn_message_fused_banded")
    del sub, full

    # row 3 at the 2x2 trunk's shape (its update, in the band's sorted
    # order): printed here, its kernels-line entry is the 1x1's
    up = params["update"][0]
    alive_s = torch.nn.functional.pad(alive.float(), (0, n_pad - alive.shape[1]))[:, p]
    upd_args = (torch.randn((N_CHAINS, K, n_pad, F), generator=gen, device=dev),
                torch.randn((N_CHAINS, K, n_pad, 3 * F), generator=gen, device=dev),
                up["u_mat"]["w"], up["v_mat"]["w"], up["s_dense0"]["w"], up["s_dense0"]["b"],
                up["s_dense1"]["w"], up["s_dense1"]["b"], alive_s.contiguous())
    products, rest, upd_bytes = update_work(upd_args)
    m = _measure("painn_update_fused", pk.painn_update_fused, pk.painn_update_fused_plain,
                 upd_args, (True, True) + (False,) * 6 + (True,), products + rest, PLAIN_CHUNK,
                 nbytes=upd_bytes)
    _print_measure("sc-kernel", "painn_update_fused", m,
                   "(2x2, C = 128; the kernels line holds the 1x1's) "
                   + update_contract(upd_args, m, "sc-kernel"))
    del upd_args

    # banded vs unbanded on the same geometry, slot order
    pack_u = build_static_edge_pack(spec, sys_sc.static_nbr, cfg, dev)
    (rbf_u, envm_u, nbr_u, unit_u, _), _ = static_edge_geometry(pack_u, alive)
    pairs = (
        ("painn_message_l1_banded vs painn_message_l1",
         lambda: pk.painn_message_l1_banded(*l1_args),
         lambda: pk.painn_message_l1(species, rw["philt"], rbf_u, envm_u, nbr_u, unit_u,
                                     rw["dw2"], rw["db2"])),
        ("painn_message_fused_banded vs painn_message_fused",
         lambda: pk.painn_message_fused_banded(*msg_args),
         lambda: pk.painn_message_fused(phi, vcat, rbf_u, envm_u, nbr_u, unit_u, *msg_w)),
    )
    for row, (label, banded, plain_order) in zip(rows, pairs):
        got_b, got_u = banded(), plain_order()
        diff = max(float((b[:, :, ip] - u).abs().max()) for b, u in zip(got_b, got_u))
        ms_u = _cuda_ms(plain_order, reps=10)
        ms_b = _cuda_ms(banded, reps=10)
        row["unbanded_ms"], row["max_diff_vs_unbanded"] = ms_u, diff
        print(f"[sc-banding] {label} on the same 2x2 geometry: banded ms={ms_b:.4f} "
              f"unbanded ms={ms_u:.4f} max|banded[inv_perm] - unbanded|={diff:.3e}")
    return rows


def sc_anchor_phase(sys_sc, sys_gpu, dev) -> None:
    """12. The pristine 2x2 network energy is 4 x the 1x1 cell's; the card
    agrees with the CPU plain path, and the banded with the unbanded rigid
    forward, on random occupancies."""
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_numbers,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.models.ensemble import ensemble_apply_rigid
    from surface_sampling_tpu_torch.ops.static_edges import (
        build_static_edge_pack,
        static_edge_geometry,
    )
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    def nn_sum(s):
        d = s.run.d
        ss = torch.zeros((1, s.spec.n_sites), dtype=torch.int64, device=dev)
        out = s.potential.rigid_outputs(realize_type_idx(d, ss), realize_alive(d, ss))
        return float(out["per_atom_energy"].sum())

    e4, e1 = nn_sum(sys_sc), nn_sum(sys_gpu)
    rel = abs(e4 - 4 * e1) / abs(4 * e1)
    print(f"[sc-anchor] pristine network energy 2x2 {e4:.6f} vs 4 x 1x1 {4 * e1:.6f} "
          f"(training units, member mean) rel diff {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"2x2 network energy is not 4 x the 1x1's: {e4} vs {4 * e1}")

    S = sys_sc.spec.n_sites
    rng = np.random.default_rng(5)
    ss = rng.integers(0, sys_sc.spec.n_codes, (3, S))
    ss = torch.as_tensor(np.concatenate([np.zeros((1, S), np.int64),
                                         np.where(rng.random(ss.shape) < 0.9, 0, ss)]))
    e_gpu = sys_sc.run.state_energy_fn(ss.to(dev)).surface_energy.cpu()
    sys_cpu = srtio3_001_painn(supercell=(2, 2), device="cpu")
    e_cpu = sys_cpu.run.state_energy_fn(ss).surface_energy
    diff = float((e_gpu - e_cpu).abs().max())

    # the same occupancies through the rigid forward over banded and
    # unbanded static edges: member-mean network energies in eV
    pot, d = sys_sc.potential, sys_sc.run.d
    alive, numbers = realize_alive(d, ss.to(dev)), realize_numbers(d, ss.to(dev))
    packs = (pot.static_edge_pack,
             build_static_edge_pack(sys_sc.spec, sys_sc.static_nbr, pot.cfg, dev))
    e_b, e_u = (pot.factor * ensemble_apply_rigid(pot.params, pot.rw, pot.cfg, numbers, alive,
                                                  *static_edge_geometry(pack, alive),
                                                  pack.band)["energy"].cpu()
                for pack in packs)
    diff_u = float((e_b - e_u).abs().max())
    print(f"[sc-anchor] card {e_gpu.tolist()} cpu {e_cpu.tolist()} max diff {diff:.3e} eV; "
          f"network energy banded {e_b.tolist()} unbanded {e_u.tolist()} eV, max diff "
          f"{diff_u:.3e} eV")
    if not (diff <= 1e-3 and diff_u <= 1e-3):
        raise AssertionError(f"2x2 energies differ: card vs CPU {diff} eV, "
                             f"banded vs unbanded {diff_u} eV")


def full_mc_phase(tag: str, sys_, sweeps: int, per_eval: dict, n_chains: int = N_CHAINS,
                  sweep_size: int = SWEEP_SIZE):
    """6. / 13. Full-evaluation MC through the entry points, ``n_chains``
    chains x ``sweeps`` x ``sweep_size`` steps: launch counts (``per_eval``
    launches of each named kernel per evaluation, none of any other), finite
    energies, throughput (best of 3 runs after the counted one). Returns the
    launch counts of the run, its evaluations per second and its final state
    (seed 0)."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, geometric_schedule, make_run_fn
    from surface_sampling_tpu_torch.parallel.chains import chain_states, make_chain_run

    d, sef = sys_.run.d, sys_.run.state_energy_fn
    crun = make_chain_run(make_run_fn(d, sef, EngineConfig(sweep_size=sweep_size,
                                                           record_positions=False)))
    temps = geometric_schedule(1.0, sweeps, 0.99)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    states = chain_states(d, n_chains)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    out, recs = crun(states, temps, _gen(0))
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_evals = 1 + sweeps * sweep_size
    want = {name: per_eval.get(name, 0) * n_evals for name in launches}
    if launches != want:
        raise AssertionError(f"[{tag}] launch counts {launches}, expected {want}")
    if not (torch.isfinite(recs.energy).all() and torch.isfinite(out.energy).all()):
        raise AssertionError(f"[{tag}] non-finite energies in the MC run")
    n_mc = sweeps * sweep_size
    dt = _best_of(lambda seed: crun(states, temps, _gen(seed)))
    print(f"[{tag}] chains={n_chains} sweeps={sweeps}x{sweep_size} "
          f"evals/s={n_chains * n_mc / dt:.1f} step_ms={1e3 * dt / n_mc:.3f} "
          f"accept={float(recs.accept_rate.mean()):.4f} best={float(recs.energy.min()):.6f} eV "
          f"peak_mem={peak_gb:.3f} GB launches={json.dumps(launches)}")
    return launches, n_chains * n_mc / dt, out


def _inc_run(sys_, n_chains, sweeps):
    """The delta engine of a supercell system, a chain run over it, its
    initial states and schedule."""
    from surface_sampling_tpu_torch.core.engine import geometric_schedule
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_painn_from_system,
        make_incremental_run,
        make_incremental_semigrand_step,
    )
    from surface_sampling_tpu_torch.parallel.chains import incremental_chain_states, make_chain_run

    engine = make_incremental_painn_from_system(sys_)
    crun = make_chain_run(make_incremental_run(make_incremental_semigrand_step(engine),
                                               SWEEP_SIZE, engine.n_sites, engine.n_codes))
    return engine, crun, (lambda: incremental_chain_states(engine, sys_.run.d, n_chains)), \
        geometric_schedule(1.0, sweeps, 0.99)


def inc_mc_phase(sys_sc, dev) -> dict:
    """14. Delta-engine MC at 2x2; returns the launch counts of the run
    (initial full evaluation included)."""

    engine, crun, init, temps = _inc_run(sys_sc, N_CHAINS, INC_SWEEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    states = init()
    out_a, rec_a = crun(states, temps, _gen(0))
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_mc = INC_SWEEPS * SWEEP_SIZE
    L = len(states.caches.s)
    # the initial full evaluation is the banded rigid trunk, each step a delta
    want = {name: INC_INIT_LAUNCHES.get(name, 0) for name in launches}
    want["painn_message_subset"] = L * n_mc
    want["painn_update_fused"] += L * n_mc
    if launches != want:
        raise AssertionError(f"delta-engine launch counts {launches}, expected {want}")
    if not (torch.isfinite(rec_a.energy).all() and torch.isfinite(out_a.energy).all()):
        raise AssertionError("non-finite energies in the delta-engine run")
    fresh, _, _ = engine.energy_full(out_a.site_state)
    drift = float((fresh - out_a.energy).abs().max())
    out_b, rec_b = crun(states, temps, _gen(0))
    torch.cuda.synchronize()
    same = (torch.equal(out_a.site_state, out_b.site_state)
            and torch.equal(out_a.energy, out_b.energy)
            and torch.equal(rec_a.energy, rec_b.energy)
            and all(torch.equal(a, b) for a, b in zip(out_a.caches.s + out_a.caches.phi
                                                       + out_a.caches.vcat,
                                                       out_b.caches.s + out_b.caches.phi
                                                       + out_b.caches.vcat))
            and torch.equal(out_a.caches.e_atom, out_b.caches.e_atom))
    print(f"[inc-repeat] cached energies vs a fresh energy_full of the final states: max "
          f"|diff| {drift:.3e} eV (tol 1e-3); same seed twice: bitwise identical site states, "
          f"energies and caches: {same}")
    if not drift <= 1e-3:
        raise AssertionError(f"cached energies drift from full evaluation by {drift} eV")
    if not same:
        raise AssertionError("the delta-engine run does not repeat bitwise")
    dt = _best_of(lambda seed: crun(states, temps, _gen(seed)))
    print(f"[inc-mc] chains={N_CHAINS} sweeps={INC_SWEEPS}x{SWEEP_SIZE} "
          f"steps/s={N_CHAINS * n_mc / dt:.1f} step_ms={1e3 * dt / n_mc:.3f} "
          f"accept={float(rec_a.accept_rate.mean()):.4f} best={float(rec_a.energy.min()):.6f} eV "
          f"peak_mem={peak_gb:.3f} GB launches={json.dumps(launches)}")
    return launches


def inc_4x4_phase(dev) -> None:
    """15. The 4x4 supercell: delta-engine steps/s vs full-evaluation
    evals/s at SC44_CHAINS chains, 1 sweep x 8 steps each, from the same
    seed."""
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    t0 = time.perf_counter()
    sys44 = srtio3_001_painn(supercell=(4, 4), device=dev)
    t_build = time.perf_counter() - t0
    band = sys44.potential.static_edge_pack.band
    engine, icrun, init, temps = _inc_run(sys44, SC44_CHAINS, SC_SWEEPS)
    states = init()
    out_i, rec_i = icrun(states, temps, _gen(0))
    fresh, _, _ = engine.energy_full(out_i.site_state)
    drift = float((fresh - out_i.energy).abs().max())
    dt_inc = _best_of(lambda seed: icrun(states, temps, _gen(seed)))
    del states
    _, full_rate, out_f = full_mc_phase("4x4-mc", sys44, SC_SWEEPS, BANDED_LAUNCHES,
                                        SC44_CHAINS)
    inc_rate = SC44_CHAINS * SC_SWEEPS * SWEEP_SIZE / dt_inc
    same = torch.equal(out_i.site_state, out_f.site_state)
    print(f"[inc-4x4] slots={sys44.spec.n_slots} sites={sys44.spec.n_sites} W={band.window} "
          f"halo={band.halo} build_s={t_build:.1f} chains={SC44_CHAINS} "
          f"sweeps={SC_SWEEPS}x{SWEEP_SIZE} incremental steps/s={inc_rate:.1f} "
          f"(step_ms={1e3 * dt_inc / (SC_SWEEPS * SWEEP_SIZE):.3f}) full evals/s={full_rate:.1f} "
          f"speedup={inc_rate / full_rate:.3f} cached vs fresh max |diff| {drift:.3e} eV; "
          f"same site states as the full run: {same}")
    if not (drift <= 1e-3 and torch.isfinite(rec_i.energy).all()):
        raise AssertionError(f"4x4 delta-engine run off: drift {drift} eV")
    if not same:
        raise AssertionError("the 4x4 delta-engine and full-evaluation runs of one seed reach "
                             "different site states")


def _fold_halo(g_ext, band, dim):
    """Cotangents of a sorted, halo-extended table folded onto its n_pad
    rows (the backward of ``with_halo``), put back in slot order."""
    g = g_ext.narrow(dim, 0, band.n_pad).clone()
    g.narrow(dim, 0, band.halo).add_(g_ext.narrow(dim, band.n_pad, band.halo))
    return g.index_select(dim, band.inv_perm)


def bwd_banded_phase(sys33, dev) -> dict:
    """16. Row 9, the banded message backward, against its plain version
    at the relaxed 3x3 supercell's geometry (SC_RELAX_CHAINS seeded
    occupancies, topology at the ideal geometry, positions displaced
    0.05 A; layer-2 weights; seeded features and cotangents), g_dw
    requested, the plain version on chunks of chains; then against row 4
    on the same geometry in slot order (un-permuted, halo folded)."""
    from surface_sampling_tpu_torch.models.painn import prepare_message_geometry, with_halo
    from surface_sampling_tpu_torch.ops import painn_kernels as pk

    pot, C = sys33.potential, SC_RELAX_CHAINS
    band, cfg, params = pot.band, pot.cfg, pot.params
    edges, _ = relax_edges(sys33, C, seed=6)
    geom_b = prepare_message_geometry(cfg, edges, band)
    geom_u = prepare_message_geometry(cfg, edges)
    rbf, envm, nbr, unit, n_pad, rev = geom_b
    K, F = params["atom_embed"].shape[0], cfg.feat_dim
    mp = params["message"][1]
    dw = torch.nn.functional.pad(mp["dist_embed"]["w"],
                                 (0, 0, 0, rbf.shape[-1] - cfg.n_rbf)).contiguous()
    db = mp["dist_embed"]["b"].contiguous()
    gen = torch.Generator(device=dev).manual_seed(6)
    phi, vcat, gdv = (torch.randn((C, K, n_pad, 3 * F), generator=gen, device=dev)
                      for _ in range(3))
    gds = torch.randn((C, K, n_pad, F), generator=gen, device=dev)
    p = band.perm
    args = (with_halo(phi[:, :, p], band.halo, 2), with_halo(vcat[:, :, p], band.halo, 2),
            rbf, envm, nbr, unit, dw, db, gds[:, :, p].contiguous(), gdv[:, :, p].contiguous())
    got = pk.painn_message_bwd_banded(*args, band, rev=rev, want_dw=True)

    def plain_chunked(want_dw):
        parts, dws = [], []
        for c0 in range(0, C, PLAIN_BWD_CHUNK):
            ch = [a[c0:c0 + PLAIN_BWD_CHUNK] if i not in (6, 7) else a
                  for i, a in enumerate(args)]
            out = pk.painn_message_bwd_banded_plain(*ch, band, want_dw=want_dw)
            parts.append(out[:5])
            dws.append(out[5:])
        per_chain = [torch.cat(x) for x in zip(*parts)]
        return per_chain + ([sum(x) for x in zip(*dws)] if want_dw else [None, None])

    ref = plain_chunked(True)
    torch.cuda.synchronize()
    names = ("g_phi_ext", "g_vcat_ext", "g_rbf", "g_envm", "g_unit", "g_dw", "g_db")
    errs = bwd_errors("painn_message_bwd_banded", got, ref, envm, names)
    again = pk.painn_message_bwd_banded(*args, band, rev=rev, want_dw=True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("painn_message_bwd_banded: two launches on the same inputs differ")
    del ref, again
    ms = _cuda_ms(lambda: pk.painn_message_bwd_banded(*args, band, rev=rev), reps=10)
    ms_dw = _cuda_ms(lambda: pk.painn_message_bwd_banded(*args, band, rev=rev, want_dw=True),
                     reps=3)
    plain_ms = _cuda_ms(lambda: plain_chunked(False), reps=1, warm=1)

    # row 4 on the same geometry in slot order
    rbf_u, envm_u, nbr_u, unit_u, _, rev_u = geom_u
    args_u = (phi, vcat, rbf_u, envm_u, nbr_u, unit_u, dw, db, gds, gdv)
    got_u = pk.painn_message_bwd(*args_u, rev=rev_u)
    got_b = pk.painn_message_bwd_banded(*args, band, rev=rev)
    M = unit.shape[-1]
    ip = band.inv_perm

    def edge_slot_order(x):
        return x.reshape(C, n_pad, M, -1)[:, ip].reshape(x.shape)

    # g_envm on selected edges only: an unselected edge (envm = 0, which
    # carries its mask, so no position sees this cotangent) reads zeros
    # outside its window in the banded layout and the slot-0 sentinel in
    # slot order
    sel = envm_u != 0
    as_slots = (_fold_halo(got_b[0], band, 2), _fold_halo(got_b[1], band, 2),
                edge_slot_order(got_b[2]), edge_slot_order(got_b[3]) * sel,
                got_b[4][:, :, ip])
    row4 = (*got_u[:3], got_u[3] * sel, got_u[4])
    diffs = {n: float((b - u).abs().max()) / max(float(u.abs().max()), 1e-30)
             for n, b, u in zip(names, as_slots, row4)}
    ms_u = _cuda_ms(lambda: pk.painn_message_bwd(*args_u, rev=rev_u), reps=10)
    ms_b = _cuda_ms(lambda: pk.painn_message_bwd_banded(*args, band, rev=rev), reps=10)
    if not all(d <= KERNEL_RTOL for d in diffs.values()):
        raise AssertionError(f"row 9 and row 4 differ on the same geometry: {diffs}")

    n_live = int((envm != 0).sum())
    R = cfg.n_rbf
    products, rest = bwd_flops(K, n_live, F, R)
    flops = products + rest
    nbytes = _nbytes(*args, band.win_start, rev, *got[:5])
    bound_ms, bound_tc_ms, by_ops = bwd_bounds(products, rest, nbytes)
    live_share = n_live / envm.numel()
    smem = bwd_smem(rbf.shape[-1], M, rev.shape[-1])
    print(f"[bwd-banded] painn_message_bwd_banded errors {json.dumps(errs)} (tol {KERNEL_RTOL} x "
          f"max|plain| each, g_envm on live edges and 0 on dead ones, C={C}, g_dw requested, "
          f"plain on chunks of {PLAIN_BWD_CHUNK}) bitwise repeat ok; ms={ms:.4f} "
          f"ms_with_g_dw={ms_dw:.4f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
          f"({'operations' if by_ops else 'bytes'}, f32) bound_tc_ms={bound_tc_ms:.4f} (3xTF32 "
          f"products) live_edges={n_live} of {envm.numel()} slots (live share {live_share:.4f}) "
          f"flops={flops:.4e} bytes={nbytes:.4e} n_ext={n_pad + band.halo} shared memory "
          f"centre/neighbour={smem[0]}/{smem[1]} B (D={rev.shape[-1]}) library_ms=null "
          f"(no single PyTorch call computes this fused backward)")
    print(f"[bwd-banding] row 9 vs row 4 on the same 3x3 geometry: banded ms={ms_b:.4f} "
          f"unbanded ms={ms_u:.4f}; max|row 9 (un-permuted, halo folded) - row 4| / max|row 4| "
          f"{json.dumps(diffs)}")
    return {"name": "painn_message_bwd_banded", "route": "cuda",
            "source": "surface_sampling_tpu_torch/csrc/painn_message_bwd_banded.cu",
            "replaces": "surface_sampling_tpu/ops/pallas_painn.py:966",
            "launches": None, "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if by_ops else "bytes",
            "library_ms": None, "live_share": live_share,
            "ms_chains": C, "plain_chunk_chains": PLAIN_BWD_CHUNK,
            "ms_with_g_dw": ms_dw, "unbanded_ms": ms_u, "max_rel_diff_vs_unbanded": diffs}


def _sc_states(spec, n, seed, empty=0.95):
    """Seeded sparse occupancies of a supercell, the first pristine."""
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, spec.n_codes, (n, spec.n_sites))
    ss = np.where(rng.random(ss.shape) < empty, 0, ss)
    ss[0] = 0
    return torch.as_tensor(ss)


def sc_relax_phase(sys33, dev) -> None:
    """17. The relaxed 3x3 supercell: card vs the CPU plain path (one
    member: energies and forces of seeded sparse states, and the pristine
    cell relaxed for SC_RELAX_CPU_STEPS FIRE steps), banded vs unbanded
    forces on the card (three members), and the pristine cell's surface
    energy after the full 20-step relaxation on the card."""
    import dataclasses

    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
    from surface_sampling_tpu_torch.systems import SYSTEMS_DATA, srtio3_001_painn

    def forces(sys_, ss):
        d = sys_.run.d
        ss = ss.to(d.device)
        e, f = sys_.potential.energy_and_forces(realize_positions(d, ss),
                                                realize_type_idx(d, ss), realize_alive(d, ss))
        return e.cpu(), f.cpu()

    short = RelaxConfig(steps=SC_RELAX_CPU_STEPS)
    pair = [srtio3_001_painn(supercell=(3, 3), relax=short, n_models=1, device=dv)
            for dv in (dev, "cpu")]
    ss = _sc_states(sys33.spec, 2, seed=7)
    (eg, fg), (ec, fc) = (forces(s, ss) for s in pair)
    de, df = float((eg - ec).abs().max()), float((fg - fc).abs().max())
    zero = torch.zeros((1, sys33.spec.n_sites), dtype=torch.int64)
    rg, rc = (s.run.state_energy_fn(zero.to(s.run.d.device)) for s in pair)
    dr = abs(float(rg.surface_energy[0]) - float(rc.surface_energy[0]))
    dp = float((rg.positions.cpu() - rc.positions).abs().max())
    print(f"[sc-relax] one member, card vs CPU: E {eg.tolist()} vs {ec.tolist()} eV |dE|={de:.3e} "
          f"eV max|dF|={df:.3e} eV/A (max|F| {float(fg.abs().max()):.4f}); pristine relaxed "
          f"{SC_RELAX_CPU_STEPS} FIRE steps: card {float(rg.surface_energy[0]):.6f} cpu "
          f"{float(rc.surface_energy[0]):.6f} eV |d|={dr:.3e} eV (tol {RELAXED_E_TOL}) max "
          f"|d position|={dp:.3e} A (tol {RELAXED_POS_TOL})")
    if not (de <= 1e-3 and df <= 1e-3 and dr <= RELAXED_E_TOL and dp <= RELAXED_POS_TOL):
        raise AssertionError(f"3x3 card vs CPU: dE {de} eV, dF {df} eV/A, relaxed {dr} eV, "
                             f"positions {dp} A")
    del pair

    pot = sys33.potential
    offsets = json.loads((SYSTEMS_DATA / "srtio3_offset_data.json").read_text())
    unbanded = make_painn_potential(pot.params, pot.cfg, pot.znums.tolist(), units="kcal/mol",
                                    stoidict=offsets["stoidict"], static_nbr=sys33.static_nbr,
                                    device=dev)
    ss = _sc_states(sys33.spec, 4, seed=8).to(dev)
    d = sys33.run.d
    inputs = (realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss))
    (eb, fb), (eu, fu) = (p.energy_and_forces(*inputs) for p in (pot, unbanded))
    dbe, dbf = float((eb - eu).abs().max()), float((fb - fu).abs().max())
    out = sys33.run.state_energy_fn(zero.to(dev))
    se = float(out.surface_energy[0])
    print(f"[sc-relax] three members on the card, banded vs unbanded: |dE|={dbe:.3e} eV "
          f"max|dF|={dbf:.3e} eV/A; pristine 3x3 FIRE-relaxed "
          f"({dataclasses.asdict(sys33.run.relax)}) surface energy {se:.6f} eV (the nff constant offset enters once per cell, "
          f"so this is not 9 x the 1x1's)")
    if not (dbe <= 1e-3 and dbf <= 1e-3 and np.isfinite(se) and not bool(out.oob[0])):
        raise AssertionError(f"3x3 banded vs unbanded: dE {dbe} eV, dF {dbf} eV/A; "
                             f"relaxed pristine {se} eV")


def local_relax_phase(tag: str, sys_relax, n_chains: int, dev) -> dict:
    """19. Warm-started ball-local relaxation MC (one-hop balls), n_chains x
    1 sweep x LOCAL_SWEEP_SIZE steps from FIRE-relaxed pristine chains:
    moves/s beside the full relaxed path's evals/s from the same start
    states and seed, mean FIRE iterations of each, slots outside the ball
    unchanged by an evaluation, carried energies vs a fresh evaluation of
    the carried geometry, a bitwise repeat. Returns the launch counts of
    the local run."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, make_run_fn
    from surface_sampling_tpu_torch.core.local_relax import (
        build_ball_masks,
        make_local_relax_eval,
        make_local_relax_run,
        make_local_relax_semigrand_step,
    )
    from surface_sampling_tpu_torch.core.state import (
        change_site,
        element_counts,
        realize_alive,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.parallel.chains import relaxed_chain_states

    run, pot, spec, d = sys_relax.run, sys_relax.potential, sys_relax.spec, sys_relax.run.d
    balls = build_ball_masks(spec, sys_relax.static_nbr, hops=1)
    evaluate = make_local_relax_eval(d, pot, run.surface_energy_fn, run.relax, balls)
    step = make_local_relax_semigrand_step(evaluate)
    lrun = make_local_relax_run(step, LOCAL_SWEEP_SIZE, spec.n_sites, spec.n_codes)
    frun = make_run_fn(d, run.state_energy_fn, EngineConfig(sweep_size=LOCAL_SWEEP_SIZE))
    temps = np.array([1.0])
    states = relaxed_chain_states(d, run.state_energy_fn, n_chains)

    # one evaluation: nothing outside the moved site's ball moves
    rng = np.random.default_rng(9)
    site = torch.as_tensor(rng.integers(0, spec.n_sites, n_chains), device=dev)
    trial = change_site(states.site_state, site, torch.ones_like(site))
    e = evaluate(trial, states.relaxed_positions, torch.stack([site, site], 1))
    outside = ~torch.as_tensor(balls, device=dev)[site]
    kept = torch.equal(e.positions[outside], states.relaxed_positions[outside])
    if not kept:
        raise AssertionError(f"[{tag}] slots outside the ball moved")

    torch.cuda.synchronize()
    reset_launch_counts()
    with counting(pot) as (calls, n_steps):
        out_a, rec_a = lrun(states, temps, _gen(0))
        torch.cuda.synchronize()
        launches = launch_counts()
        local_calls = dict(calls)
        iters_local = torch.stack(n_steps).float()
    with counting(pot) as (calls, n_steps):
        frun(states, temps, _gen(0))
        iters_full = torch.stack(n_steps).float()
    ss = out_a.site_state
    e_fresh = pot.energy(out_a.relaxed_positions, realize_type_idx(d, ss), realize_alive(d, ss))
    se_fresh = run.surface_energy_fn(e_fresh, element_counts(d, ss))
    drift = float((se_fresh - out_a.energy).abs().max())
    t0 = time.perf_counter()
    out_b, rec_b = lrun(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt_local = time.perf_counter() - t0
    same = (torch.equal(out_a.site_state, out_b.site_state)
            and torch.equal(out_a.energy, out_b.energy)
            and torch.equal(out_a.relaxed_positions, out_b.relaxed_positions))
    t0 = time.perf_counter()
    frun(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt_full = time.perf_counter() - t0
    n_mc = LOCAL_SWEEP_SIZE
    print(f"[{tag}] slots={spec.n_slots} chains={n_chains} steps={n_mc} one-hop ball slots mean "
          f"{float(balls.sum(1).mean()):.1f} of {spec.n_slots}: local moves/s="
          f"{n_chains * n_mc / dt_local:.2f} (step_ms={1e3 * dt_local / n_mc:.3f}, fire_iters_mean="
          f"{float(iters_local.mean()):.3f}, force_calls={local_calls['force']}) vs full relaxed "
          f"evals/s={n_chains * n_mc / dt_full:.2f} (step_ms={1e3 * dt_full / n_mc:.3f}, "
          f"fire_iters_mean={float(iters_full.mean()):.3f}) speedup={dt_full / dt_local:.3f}; "
          f"outside-ball slots unchanged: {kept}; carried vs fresh max |diff| {drift:.3e} eV "
          f"(tol 1e-3); bitwise repeat: {same}; accept={float(rec_a.accept_rate.mean()):.4f} "
          f"launches={json.dumps(launches)}")
    if not (drift <= 1e-3 and same and torch.isfinite(rec_a.energy).all()):
        raise AssertionError(f"[{tag}] local relax: drift {drift} eV, repeat {same}")
    return launches


# ----------------------------------------------------------------------
# CHGNet on LaMnO3(001): paths A (rigid 1x1), B (relaxed 1x1), C (rigid 3x3)
# ----------------------------------------------------------------------
def conv_flops_per_edge(F: int) -> int:
    """Row 10 per edge: be @ w2 (F x 2F) and h0 @ [wc1 | wg1] (2 x F x F)
    multiply-adds, ~30 F of activations, LayerNorms and gates."""
    return 8 * F * F + 30 * F


def conv_bwd_flops_per_edge(F: int, weights: bool) -> int:
    """Row 12 per edge: the forward recomputed, dh @ [wc1 | wg1]^T and
    dpre @ w2^T, ~60 F elementwise; the weight pass adds be^T dpre and
    h0^T dh."""
    return conv_flops_per_edge(F) + 8 * F * F + 60 * F + (8 * F * F if weights else 0)


def conv_products_per_edge(F: int, backward: bool) -> int:
    """The part of rows 10 / 12's operations per edge that runs on the
    tensor cores: be . w2 and h0 . [wc1 | wg1] (8 F^2 flop), and for the
    backward also dh . [wc1 | wg1]^T and dpre . w2^T (8 F^2 more)."""
    return (16 if backward else 8) * F * F


def conv_computed_rows(maskf, M: int) -> int:
    """Edge rows rows 10-12 compute: each centre's live slots, padded to the
    16-edge tiles of the mma (csrc/chgnet_conv.cuh)."""
    live = (maskf != 0).reshape(-1, M).sum(-1)
    return int(((live + 15) // 16 * 16).sum())


def conv_blocks_per_sm(name: str, M: int) -> int:
    """Blocks of row 10 / 11's forward or row 12's centre kernel an SM
    holds at M slots (registers and shared memory), as the library's
    occupancy query gives it."""
    from surface_sampling_tpu_torch.ops.cuda_build import _lib

    if name == "chgnet_conv_bwd":
        return _lib(name).chgnet_conv_bwd_blocks_per_sm(M, 0)
    return getattr(_lib(name), f"{name}_blocks_per_sm")(M)


def conv_extra(args, n_live: int, backward: bool, nbytes: int) -> tuple[float, str]:
    """bound_tc_ms of rows 10-12 (the products at 3 TF32 passes, the rest at
    f32) and the text of their live and computed shares."""
    maskf = args[4]
    slots, M = maskf.numel(), maskf.shape[1] // args[0].shape[1]
    F = args[0].shape[-1] // 2
    flops = n_live * (conv_bwd_flops_per_edge(F, False) if backward else conv_flops_per_edge(F))
    products = n_live * conv_products_per_edge(F, backward)
    _, bound_tc_ms, _ = bwd_bounds(products, flops - products, nbytes)
    rows = conv_computed_rows(maskf, M)
    return bound_tc_ms, (
        f"bound_tc_ms={bound_tc_ms:.4f} (3xTF32 products) live_edges={n_live} of {slots} slots "
        f"(live share {n_live / slots:.4f}) computed_rows={rows} (computed share "
        f"{rows / slots:.4f}: live slots padded to 16-edge tiles) ")


def conv_bytes(args, n_live: int, *rest) -> int:
    """Bytes rows 10-12 must move: be and bw of the live edges only (a
    masked edge's are never needed), maskf and nbr of every edge, and the
    per-row tensors, the weights and ``rest`` (cotangents, tables, outputs)
    whole."""
    ai2, aj2, be, bw, maskf, nbr, *weights = args
    return (_nbytes(ai2, aj2, maskf, nbr, *weights, *rest)
            + n_live * (be.shape[-1] + bw.shape[-1]) * be.element_size())


def chgnet_conv_case(sys_, n_chains: int, seed: int, relaxed: bool = False):
    """Inputs of the atom conv at a path's shapes: the edges of seeded
    occupancies (75% of the sites empty; on the relaxed path the topology
    at the ideal geometry and positions displaced 0.05 A), the real layer-1
    pre-activations and weights, in the band's sorted order where the
    system has a band. Returns the conv's arguments, the edges' reverse
    table and the number of live edges."""
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.models.chgnet import (
        atom_graph_edges,
        atom_preactivations,
        conv_weights,
        initial_atoms,
    )
    from surface_sampling_tpu_torch.models.painn import with_halo

    pot, d = sys_.potential, sys_.run.d
    if relaxed:
        edges, ss = relax_edges(sys_, n_chains, seed)
    else:
        ss = _states(sys_.spec, n_chains, np.random.default_rng(seed), d.device)
        edges = pot.edge_fn(realize_positions(d, ss), realize_alive(d, ss))
    alive = realize_alive(d, ss)
    numbers = pot.znums[realize_type_idx(d, ss)] * alive
    be, bw, maskf, nbr, n_pad = atom_graph_edges(pot.params, pot.cfg, edges, pot.band)
    atom = torch.nn.functional.pad(initial_atoms(pot.params, pot.cfg, numbers, alive),
                                   (0, 0, 0, n_pad - numbers.shape[1]))
    gmlp = pot.params["atom_convs"][0]["gmlp"]
    ai2, aj2 = atom_preactivations(gmlp, atom, pot.cfg.atom_fea_dim)
    if pot.band is not None:
        ai2, aj2 = ai2[:, pot.band.perm], with_halo(aj2[:, pot.band.perm], pot.band.halo, 1)
    args = (ai2.contiguous(), aj2.contiguous(), be, bw, maskf, nbr,
            *conv_weights(gmlp, pot.cfg.atom_fea_dim))
    return args, edges.rev, int((maskf != 0).sum())


def chgnet_bwd_measure(args, rev, gagg, n_live: int) -> dict:
    """Row 12 against its plain version (autograd of the plain conv) with
    and without the weight cotangents, the plain version on chunks of
    CHG_PLAIN_CHUNK chains (its weight cotangents summed over the chunks);
    a bitwise repeat; times and bounds."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    def plain_chunked(want_w):
        parts, wsum = [], None
        C = args[0].shape[0]
        for c0 in range(0, C, CHG_PLAIN_CHUNK):
            ch = [a[c0:c0 + CHG_PLAIN_CHUNK] if i < 6 else a for i, a in enumerate(args)]
            out = ck.chgnet_conv_bwd_plain(*ch, gagg[c0:c0 + CHG_PLAIN_CHUNK],
                                           want_weights=want_w)
            parts.append(out[:4])
            if want_w:
                wsum = out[4:] if wsum is None else [a + b for a, b in zip(wsum, out[4:])]
        return [torch.cat(x) for x in zip(*parts)] + list(wsum or [None] * 7)

    errs = {}
    for want_w in (True, False):
        got = ck.chgnet_conv_bwd(*args, gagg, rev=rev, want_weights=want_w)
        ref = plain_chunked(want_w)
        torch.cuda.synchronize()
        for n, g, r in zip(ck.GRAD_NAMES, got, ref):
            if r is None:
                if g is not None:
                    raise AssertionError(f"chgnet_conv_bwd {n}: returned without being asked")
                continue
            err, scale = float((g - r).abs().max()), float(r.abs().max())
            errs[f"{n}{'' if want_w else ' (no weights)'}"] = err
            if not err <= KERNEL_RTOL * scale:
                raise AssertionError(f"chgnet_conv_bwd {n}: max abs error {err} exceeds "
                                     f"{KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale}")
        again = ck.chgnet_conv_bwd(*args, gagg, rev=rev, want_weights=want_w)
        if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("chgnet_conv_bwd: two launches on the same inputs differ")
        del got, ref, again
    ms = _cuda_ms(lambda: ck.chgnet_conv_bwd(*args, gagg, rev=rev), reps=10)
    ms_w = _cuda_ms(lambda: ck.chgnet_conv_bwd(*args, gagg, rev=rev, want_weights=True), reps=3)
    plain_ms = _cuda_ms(lambda: plain_chunked(False), reps=1, warm=1)
    F = args[0].shape[-1] // 2
    flops = n_live * conv_bwd_flops_per_edge(F, False)
    # g_ai2, g_aj2 and the dense g_be, g_bw have the shapes of ai2 .. bw
    nbytes = conv_bytes(args, n_live, gagg, rev, *args[:4])
    return {"err": max(errs.values()), "errs": errs, "ms": ms, "ms_with_weights": ms_w,
            "plain_ms": plain_ms, "flops": flops, "bytes": nbytes,
            "plain_chunk_chains": CHG_PLAIN_CHUNK,
            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)}


def _repeat_bitwise(name: str, fn) -> None:
    """Two launches on the same inputs give the same bits."""
    if not torch.equal(fn(), fn()):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def chgnet_kernels_phase(sys_a, sys_b, sys_c) -> list:
    """20. Rows 10, 11 and 12 at this slice's shapes against their plain
    versions: row 10 at path A's (1x1, CHG_CHAINS chains), row 11 at path
    C's (3x3 banded, CHG_3X3_CHAINS chains), row 12 at path B's (the relax
    table's displaced geometry, CHG_RELAX_CHAINS chains, seeded random
    cotangents) with and without the weight cotangents; a bitwise repeat of
    each; their live and computed shares and the bound with the products at
    3 TF32 passes (printed, not in the kernels line). Then the three at M =
    CHG_WIDE_M slots a centre (``lamno3_001_chgnet(max_neighbors=160)``,
    the kernels' 256-slot instantiation) against their plain versions, their
    times under ``m160`` in the kernels line."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet

    rows = []
    args, _, n_live = chgnet_conv_case(sys_a, CHG_CHAINS, seed=10)
    F = args[0].shape[-1] // 2
    per_chain = (True,) * 6 + (False,) * 7
    agg_bytes = _nbytes(args[0]) // 2       # agg (C, n_pad, F): half of ai2
    m = _measure("chgnet_conv", lambda *a: (ck.chgnet_conv(*a),),
                 lambda *a: (ck.chgnet_conv_plain(*a),), args, per_chain,
                 n_live * conv_flops_per_edge(F), CHG_PLAIN_CHUNK,
                 conv_bytes(args, n_live) + agg_bytes)
    _repeat_bitwise("chgnet_conv", lambda: ck.chgnet_conv(*args))
    blocks = conv_blocks_per_sm("chgnet_conv", args[2].shape[1] // args[0].shape[1])
    _print_measure("chgnet-kernel", "chgnet_conv", m,
                   conv_extra(args, n_live, False, m["bytes"])[1]
                   + f"blocks an SM {blocks} bitwise repeat ok ")
    rows.append(_row("chgnet_conv", "surface_sampling_tpu/ops/pallas_chgnet.py:104", m,
                     ms_chains=CHG_CHAINS))
    del args
    band = sys_c.potential.band
    args, _, n_live = chgnet_conv_case(sys_c, CHG_3X3_CHAINS, seed=11)
    m = _measure("chgnet_conv_banded", lambda *a: (ck.chgnet_conv_banded(*a, band),),
                 lambda *a: (ck.chgnet_conv_banded_plain(*a, band),), args, per_chain,
                 n_live * conv_flops_per_edge(F), CHG_PLAIN_CHUNK_3X3,
                 conv_bytes(args, n_live, band.win_start) + _nbytes(args[0]) // 2)
    _repeat_bitwise("chgnet_conv_banded", lambda: ck.chgnet_conv_banded(*args, band))
    blocks = conv_blocks_per_sm("chgnet_conv_banded", args[2].shape[1] // args[0].shape[1])
    _print_measure("chgnet-kernel", "chgnet_conv_banded", m,
                   conv_extra(args, n_live, False, m["bytes"])[1]
                   + f"n_pad={band.n_pad} W={band.window} halo={band.halo} blocks an SM {blocks} "
                   "bitwise repeat ok ")
    rows.append(_row("chgnet_conv_banded", "surface_sampling_tpu/ops/pallas_chgnet.py:184", m,
                     ms_chains=CHG_3X3_CHAINS))
    del args
    torch.cuda.empty_cache()
    args, rev, n_live = chgnet_conv_case(sys_b, CHG_RELAX_CHAINS, seed=12, relaxed=True)
    gen = torch.Generator(device=args[0].device).manual_seed(12)
    gagg = torch.randn(args[0].shape[:2] + (F,), generator=gen, device=args[0].device)
    m = chgnet_bwd_measure(args, rev, gagg, n_live)
    blocks = conv_blocks_per_sm("chgnet_conv_bwd", args[2].shape[1] // args[0].shape[1])
    print(f"[chgnet-kernel] chgnet_conv_bwd errors {json.dumps(m['errs'])} (tol {KERNEL_RTOL} x "
          f"max|plain| each, C={CHG_RELAX_CHAINS}) bitwise repeat ok; ms={m['ms']:.4f} "
          f"ms_with_weights={m['ms_with_weights']:.4f} plain_ms={m['plain_ms']:.3f} "
          f"bound_ms={m['bound_ms']:.4f} {conv_extra(args, n_live, True, m['bytes'])[1]}"
          f"blocks an SM {blocks} "
          f"flops={m['flops']:.4e} bytes={m['bytes']:.4e} library_ms=null (no single PyTorch "
          f"call computes this fused backward)")
    rows.append(_row("chgnet_conv_bwd", "surface_sampling_tpu/ops/pallas_chgnet.py:327", m,
                     ms_chains=CHG_RELAX_CHAINS, ms_with_weights=m["ms_with_weights"],
                     max_abs_err_by_output=m["errs"]))
    del args, rev, gagg
    torch.cuda.empty_cache()

    # M = CHG_WIDE_M: rows 10 and 12 on the rigid 1x1 system (row 12 at path
    # B's chain count), row 11 on the banded 3x3
    dev = sys_a.run.d.device
    keep = ("err", "ms", "plain_ms", "bound_ms")
    wide = lamno3_001_chgnet(max_neighbors=CHG_WIDE_M, device=dev)
    args, _, n_live = chgnet_conv_case(wide, CHG_CHAINS, seed=13)
    M = args[2].shape[1] // args[0].shape[1]
    if M != CHG_WIDE_M:
        raise AssertionError(f"max_neighbors={CHG_WIDE_M} gave M={M}")
    m = _measure("chgnet_conv", lambda *a: (ck.chgnet_conv(*a),),
                 lambda *a: (ck.chgnet_conv_plain(*a),), args, per_chain,
                 n_live * conv_flops_per_edge(F), CHG_PLAIN_CHUNK,
                 conv_bytes(args, n_live) + _nbytes(args[0]) // 2)
    _repeat_bitwise("chgnet_conv", lambda: ck.chgnet_conv(*args))
    _print_measure("chgnet-kernel", f"chgnet_conv M={M}", m,
                   conv_extra(args, n_live, False, m["bytes"])[1]
                   + f"blocks an SM {conv_blocks_per_sm('chgnet_conv', M)} bitwise repeat ok ")
    rows[0]["m160"] = {k: m[k] for k in keep}
    del args
    args, rev, n_live = chgnet_conv_case(wide, CHG_RELAX_CHAINS, seed=14)
    gen = torch.Generator(device=dev).manual_seed(14)
    gagg = torch.randn(args[0].shape[:2] + (F,), generator=gen, device=dev)
    m = chgnet_bwd_measure(args, rev, gagg, n_live)
    print(f"[chgnet-kernel] chgnet_conv_bwd M={M} errors {json.dumps(m['errs'])} (tol "
          f"{KERNEL_RTOL} x max|plain| each, C={CHG_RELAX_CHAINS}) bitwise repeat ok; "
          f"ms={m['ms']:.4f} ms_with_weights={m['ms_with_weights']:.4f} "
          f"plain_ms={m['plain_ms']:.3f} bound_ms={m['bound_ms']:.4f} "
          f"{conv_extra(args, n_live, True, m['bytes'])[1]}"
          f"blocks an SM {conv_blocks_per_sm('chgnet_conv_bwd', M)}")
    rows[2]["m160"] = {k: m[k] for k in keep}
    del args, rev, gagg, wide
    torch.cuda.empty_cache()
    wide = lamno3_001_chgnet(supercell=(3, 3), max_neighbors=CHG_WIDE_M, device=dev)
    band = wide.potential.band
    args, _, n_live = chgnet_conv_case(wide, CHG_3X3_CHAINS, seed=15)
    m = _measure("chgnet_conv_banded", lambda *a: (ck.chgnet_conv_banded(*a, band),),
                 lambda *a: (ck.chgnet_conv_banded_plain(*a, band),), args, per_chain,
                 n_live * conv_flops_per_edge(F), CHG_PLAIN_CHUNK_3X3,
                 conv_bytes(args, n_live, band.win_start) + _nbytes(args[0]) // 2)
    _repeat_bitwise("chgnet_conv_banded", lambda: ck.chgnet_conv_banded(*args, band))
    _print_measure("chgnet-kernel", f"chgnet_conv_banded M={M}", m,
                   conv_extra(args, n_live, False, m["bytes"])[1]
                   + f"n_pad={band.n_pad} W={band.window} bitwise repeat ok ")
    rows[1]["m160"] = {k: m[k] for k in keep}
    return rows


def _slab_potential(dev):
    """CHGNet on the bare LaMnO3 slab (no sites) over its static table with
    0.5 A of slack: the goldens' geometry, rattled."""
    from surface_sampling_tpu_torch.core.spec import make_spec
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential
    from surface_sampling_tpu_torch.models.weights import from_jax_params, load_chgnet_npz
    from surface_sampling_tpu_torch.structure import Structure
    from surface_sampling_tpu_torch.systems import MODEL_DATA, SYSTEMS_DATA

    data = np.load(SYSTEMS_DATA / "LaMnO3_001_2x2x3.npz")
    tree, cfg = load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    types = [57, 25, 8]
    spec = make_spec(Structure(data["numbers"], data["positions"], data["cell"]),
                     np.zeros((0, 3)), [], potential_numbers=types, cutoff=cfg.atom_graph_cutoff)
    table = build_static_neighbor_table(spec, cfg.atom_graph_cutoff, relax_slack=0.5)
    pot = make_chgnet_potential(from_jax_params(tree, dev), cfg, types, static_nbr=table,
                                device=dev)
    return pot, data, torch.as_tensor(spec.type_of_z[data["numbers"]], device=dev)[None]


def chgnet_anchor_phase(sys_a, dev) -> None:
    """21. The golden cases of tests/data/chgnet_golden.json on the card at
    the JAX test's tolerances; the pristine 2x2x3 system's potential and
    surface energy, card vs the CPU plain path."""
    from pathlib import Path

    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet

    golden = json.loads((Path(__file__).resolve().parent / "tests" / "data" /
                         "chgnet_golden.json").read_text())
    pot, data, types = _slab_potential(dev)
    alive = torch.ones_like(types, dtype=torch.bool)
    rng = np.random.default_rng(12345)
    worst = {}
    for case in golden["cases"]:
        p = data["positions"] + case["perturbation_scale"] * rng.standard_normal(
            data["positions"].shape)
        out = {k: v[0].cpu().numpy() for k, v in pot.outputs(
            torch.as_tensor(p, dtype=torch.float32, device=dev)[None], types, alive).items()}
        mn = data["numbers"] == 25
        checks = {
            "energy": (abs(float(out["energy"]) - case["energy"]), 2e-3),
            "energy_per_atom": (abs(float(out["energy_per_atom"]) - case["energy_per_atom"]),
                                5e-5),
            "per_atom_energy_first8": (float(np.abs(out["per_atom_energy"][:8]
                                                    - case["per_atom_energy_first8"]).max()),
                                       1e-3),
            "magmom_first8": (float(np.abs(out["magmom"][:8] - case["magmom_first8"]).max()),
                              1e-3),
            "magmom_mn_mean": (abs(float(out["magmom"][mn].mean()) - case["magmom_mn_mean"]),
                               1e-3),
            "embedding_norm_rel": (abs(float(np.linalg.norm(out["embedding"]))
                                       / case["embedding_norm"] - 1.0), 1e-4),
        }
        for k, (err, tol) in checks.items():
            worst[k] = max(worst.get(k, 0.0), err)
            if not err <= tol:
                raise AssertionError(f"golden case {case['perturbation_scale']}: {k} off by "
                                     f"{err} (tol {tol})")
    print(f"[chgnet-anchor] {len(golden['cases'])} golden cases within the JAX test's "
          f"tolerances on the card, worst deviations {json.dumps(worst)}")
    zero = torch.zeros((1, sys_a.spec.n_sites), dtype=torch.int64)
    e_gpu = sys_a.run.state_energy_fn(zero.to(dev))
    e_cpu = lamno3_001_chgnet(device="cpu").run.state_energy_fn(zero)
    pe, se = float(e_gpu.potential_energy[0]), float(e_gpu.surface_energy[0])
    dpe = abs(pe - float(e_cpu.potential_energy[0]))
    dse = abs(se - float(e_cpu.surface_energy[0]))
    print(f"[chgnet-anchor] pristine potential {pe:.6f} eV surface {se:.6f} eV (golden "
          f"{golden['cases'][0]['energy']:.6f}); card vs CPU |dE| {dpe:.3e} |dSE| {dse:.3e} eV")
    if not (abs(pe - golden["cases"][0]["energy"]) <= 1e-3 and dpe <= 1e-3 and dse <= 1e-3):
        raise AssertionError(f"CHGNet pristine anchor off: {pe} eV / {se} eV")


def chgnet_relax_phase(sys_b, dev) -> dict:
    """24. Path B: relaxed MC (relaxed_mc_phase), then one state (an O on
    site 0) FIRE-relaxed on the card and on the CPU plain path: relaxed
    energies within RELAXED_E_TOL."""
    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet

    launches = relaxed_mc_phase("chgnet-relax-mc", sys_b, CHG_RELAX_CHAINS, "chgnet_conv",
                                "chgnet_conv_bwd")
    ss = torch.zeros((1, sys_b.spec.n_sites), dtype=torch.int64)
    ss[0, 0] = 1
    gpu = sys_b.run.state_energy_fn(ss.to(dev))
    cpu = lamno3_001_chgnet(relax=sys_b.run.relax, device="cpu").run.state_energy_fn(ss)
    de = abs(float(gpu.surface_energy[0]) - float(cpu.surface_energy[0]))
    dp = float((gpu.positions.cpu() - cpu.positions).abs().max())
    print(f"[chgnet-relax-mc] one O on site 0, {sys_b.run.relax.steps} FIRE steps: card "
          f"{float(gpu.surface_energy[0]):.6f} cpu {float(cpu.surface_energy[0]):.6f} eV "
          f"|d|={de:.3e} eV (tol {RELAXED_E_TOL}) max|d position|={dp:.3e} A")
    if not de <= RELAXED_E_TOL:
        raise AssertionError(f"CHGNet relaxed energy card vs CPU differs by {de} eV")
    return launches


def chgnet_3x3_phase(sys_c, dev) -> dict:
    """25. Path C: the rigid 3x3 supercell's band, full-evaluation MC through
    row 11 only (full_mc_phase), and banded vs unbanded energies of seeded
    states on the same geometry (the unbanded potential runs row 10)."""
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential

    pot, band = sys_c.potential, sys_c.potential.band
    if band is None:
        raise AssertionError("the rigid 3x3 LaMnO3 cell has no routing band")
    launches, _, _ = full_mc_phase("chgnet-3x3-mc", sys_c, SC_SWEEPS, {"chgnet_conv_banded": 4},
                                   n_chains=CHG_3X3_CHAINS)
    unbanded = make_chgnet_potential(pot.params, pot.cfg, pot.znums.tolist(),
                                     static_nbr=sys_c.static_nbr, device=dev)
    d = sys_c.run.d
    ss = _sc_states(sys_c.spec, 4, seed=13, empty=0.9).to(dev)
    inputs = (realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss))
    e_b, e_u = pot.energy(*inputs), unbanded.energy(*inputs)
    diff = float((e_b - e_u).abs().max())
    print(f"[chgnet-3x3] slots={sys_c.spec.n_slots} n_pad={band.n_pad} W={band.window} "
          f"halo={band.halo} n_blk={band.n_blk}; banded {e_b.tolist()} unbanded {e_u.tolist()} "
          f"eV, max diff {diff:.3e} eV (tol 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError(f"3x3 banded and unbanded CHGNet energies differ by {diff} eV")
    return launches


# ----------------------------------------------------------------------
# EAM: Cu(100) 2x2x2 semigrand and Au(110) 2x2 canonical (row 13)
# ----------------------------------------------------------------------
# chain counts of the JAX package's own benchmark scripts: tools/bench_all.py's
# bench_cu100_pallas (8,192) and bench_au110_canonical (1,024); bench.py's
# fallback bench_cu_rigid and the README quick start (16,384 chains, 8 x 32
# steps)
EAM_CU_CHAINS, EAM_AU_CHAINS = 8192, 1024
CU_MC_CHAINS, CU_MC_SWEEPS, CU_MC_SWEEP_SIZE = 16384, 8, 32
AU_CANONICAL_CHAINS, CU_RELAX_CHAINS, CU_RELAX_CPU_CHAINS = 1024, 1024, 16
# f32 operations of one live pair in row 13: r (6 for the displacement, 5
# for |d|^2, max, sqrt, the cutoff test), u (clip 2, subtract, divide),
# 2u, two 24-step Clenshaw recurrences (3 each a step), their two final
# steps (3 each), the wall (7), and the two accumulations (2 + 3)
EAM_FLOPS_PER_PAIR = 14 + 4 + 1 + 2 * 24 * 3 + 2 * 3 + 7 + 5
PRISTINE_CU100_E = -24.058476294465656   # tests/test_regression_eam.py (x64, exact splines)
AU_REFERENCE_MIN = -79.03490823689619    # tests/test_regression_eam.py (LAMMPS reference)
# the Chebyshev fit sits 1.94e-4 eV from the exact pristine Cu energy (in the
# JAX package too): the cheb and kernel paths meet the pin within the JAX
# package's own fast-path bound (tests/test_fast_eam.py)
CHEB_PIN_TOL = 5e-4


def _eam_states(n_sites: int, n_chains: int, seed: int, device, p_occ: float = 0.15):
    """Seeded occupancies, each site filled with probability ``p_occ``: at
    Cu(100) ~3.6 adsorbates a chain on 24 sites 1.3-1.8 A apart, so most
    chains are physical and some hold overlapping pairs (the wall's regime)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.random((n_chains, n_sites)) < p_occ).astype(np.int64),
                           device=device)


def eam_live_pairs(positions, alive_f, pairs, cutoff: float) -> int:
    """Pairs row 13 evaluates: valid, both ends alive, r < cutoff."""
    pj = positions[:, pairs.slot_j]
    r = ((positions[:, :, None, :] - (pj + pairs.shift)) ** 2).sum(-1).clamp(min=1e-12).sqrt()
    alive = alive_f > 0.5
    live = pairs.valid & alive[:, :, None] & alive[:, pairs.slot_j] & (r < cutoff)
    return int(live.sum())


def eam_kernel_case(tag: str, spec, kernel_pot, cheb_pot, d, n_chains: int, seed: int) -> dict:
    """Row 13 against its plain version on seeded occupancies at a path's
    shapes: rho and ep each within KERNEL_RTOL x max|plain|, a bitwise
    repeat, the same bits with NaN in the shift of every padding pair and in
    the position of every dead slot (dead pairs are never read), the kernel
    potential's energies against the cheb path's within
    1e-3 eV where |E| < 999 eV (tests/test_pallas_eam.py's rule); times and
    the bound (live pairs x EAM_FLOPS_PER_PAIR, or the bytes: positions,
    alive, the table and the coefficients read once, rho and ep written
    once)."""
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.ops import eam_kernels as ek

    pairs, cheb = kernel_pot.pairs, kernel_pot.cheb
    ss = _eam_states(spec.n_sites, n_chains, seed, d.device)
    pos = realize_positions(d, ss).contiguous()
    ti, alive = realize_type_idx(d, ss), realize_alive(d, ss)
    alive_f = alive.float()
    got = ek.eam_rho_ep(pos, alive_f, pairs, cheb)
    ref = ek.eam_rho_ep_plain(pos, alive_f, pairs, cheb)
    again = ek.eam_rho_ep(pos, alive_f, pairs, cheb)
    torch.cuda.synchronize()
    errs = {}
    for name, g, r in zip(("rho", "ep"), got, ref):
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        errs[name] = err
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"[{tag}] eam_rho_ep {name}: max abs error {err} exceeds "
                                 f"{KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"[{tag}] eam_rho_ep does not repeat bitwise")
    nan = float("nan")
    pad, dead = pairs.kernel_j < 0, alive_f == 0
    dirty = ek.eam_rho_ep(torch.where(dead[..., None], nan, pos).contiguous(), alive_f,
                          pairs._replace(shift=torch.where(pad[..., None], nan, pairs.shift)
                                         .contiguous()), cheb)
    if not all(torch.equal(a, b) for a, b in zip(got, dirty)):
        raise AssertionError(f"[{tag}] eam_rho_ep: NaN on dead pairs changed its output")
    del again, dirty
    e_k = kernel_pot.energy(pos, ti, alive)
    e_c = cheb_pot.energy(pos, ti, alive)
    phys = e_c.abs() < 999.0
    de = float((e_k - e_c).abs()[phys].max())
    if not (int(phys.sum()) > 0 and de <= 1e-3):
        raise AssertionError(f"[{tag}] kernel vs cheb energies differ by {de} eV")
    n_live = eam_live_pairs(pos, alive_f, pairs, cheb.rng.cutoff)
    nbytes = _nbytes(pos, alive_f, pairs.kernel_j, pairs.shift, cheb.operand, *got)
    m = _measure("eam_rho_ep", lambda *a: ek.eam_rho_ep(*a, pairs, cheb),
                 lambda *a: ek.eam_rho_ep_plain(*a, pairs, cheb), (pos, alive_f), (True, True),
                 n_live * EAM_FLOPS_PER_PAIR, nbytes=nbytes)
    N, M = pairs.slot_j.shape
    _print_measure(tag, "eam_rho_ep", m,
                   f"C={n_chains} N={N} M={M} live_pairs={n_live} ({n_live / n_chains:.1f} a "
                   f"chain) errors rho {errs['rho']:.3e} ep {errs['ep']:.3e} bitwise repeat ok; "
                   f"NaN shifts on {int(pad.sum())} padding pairs and NaN positions on "
                   f"{int(dead.sum())} dead slots: bitwise unchanged; "
                   f"kernel vs cheb energies max|d| {de:.3e} eV over {int(phys.sum())} physical "
                   f"states (tol 1e-3); ")
    return {**m, "errs": errs, "live_pairs": n_live, "chains": n_chains, "N": N, "M": M}


def eam_systems(dev) -> dict:
    """The EAM systems and potentials of these phases on ``dev``: Cu(100)
    exact, cheb, rigid and kernel; Au(110) exact, rigid, kernel and cheb
    (the kernel's static tables at 0.05 A of slack)."""
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.potentials.eam import (
        builtin_eam,
        make_eam_rigid,
        make_eam_static,
    )
    from surface_sampling_tpu_torch.systems import ExampleSystem, au110_eam, cu100_eam

    cu_t, au_t = builtin_eam("Cu_u3"), builtin_eam("Au_u3")
    cu_fast = cu100_eam(fast=True, device=dev)
    spec = cu_fast.spec
    cu_kernel_pot = make_eam_kernel_potential(cu_t, cu_fast.static_nbr, device=dev)
    cu_rigid_pot = make_eam_rigid(cu_t, spec, device=dev)
    au_exact = au110_eam(device=dev)
    au_nbr = build_static_neighbor_table(au_exact.spec, au_t.cutoff, relax_slack=0.05)
    au_kernel_pot = make_eam_kernel_potential(au_t, au_nbr, device=dev)

    def system(spec_, pot, nbr=None):
        return ExampleSystem(spec_, pot, MCMCRun(spec_, pot, device=dev), nbr)

    return {
        "cu_exact": cu100_eam(device=dev), "cu_cheb": cu_fast,
        "cu_rigid": system(spec, cu_rigid_pot),
        "cu_kernel": system(spec, cu_kernel_pot, cu_fast.static_nbr),
        "au_exact": au_exact, "au_rigid": au110_eam(fast=True, device=dev),
        "au_kernel": system(au_exact.spec, au_kernel_pot, au_nbr),
        "au_cheb": system(au_exact.spec, make_eam_static(au_t, au_nbr, mode="cheb", device=dev),
                          au_nbr),
    }


def eam_kernel_phase(eam: dict) -> dict:
    """27. Row 13 at Cu(100) with CU_MC_CHAINS chains, the shape of its
    main path `[cu-mc]` (the row's numbers), with EAM_CU_CHAINS
    (bench_cu100_pallas's shape) and at Au(110) with EAM_AU_CHAINS."""
    def case(system: str, n_chains: int, seed: int) -> dict:
        kern = eam[f"{system}_kernel"]
        return eam_kernel_case("eam-kernel", kern.spec, kern.potential,
                               eam[f"{system}_cheb"].potential, kern.run.d, n_chains, seed)

    keep = ("ms", "plain_ms", "bound_ms", "live_pairs", "chains", "errs")
    cu = case("cu", CU_MC_CHAINS, 32)
    cu_8k = case("cu", EAM_CU_CHAINS, 30)
    au = case("au", EAM_AU_CHAINS, 31)
    return _row("eam_rho_ep", "surface_sampling_tpu/ops/pallas_eam.py:51", cu,
                ms_chains=CU_MC_CHAINS, live_pairs=cu["live_pairs"],
                max_abs_err_by_output=cu["errs"],
                cu_8192={k: cu_8k[k] for k in keep}, au={k: au[k] for k in keep})


def _au_states():
    import itertools

    ss = np.zeros((28, 8), np.int64)
    for row, combo in enumerate(itertools.combinations(range(8), 6)):
        ss[row, list(combo)] = 1
    return torch.as_tensor(ss)


def eam_anchor_phase(eam: dict, dev) -> None:
    """28. The Cu(100) pristine pin by the exact, rigid, cheb and
    kernel paths; the Au(110) ground state over the 28 six-adsorbate states
    by the exact, rigid and kernel paths; each card value against the CPU
    plain path's within 1e-4 eV."""
    cpu = eam_systems("cpu")
    zero = torch.zeros((1, eam["cu_cheb"].spec.n_sites), dtype=torch.int64)
    au_ss = _au_states()
    checks = []
    for name, tol, pick in (("cu_exact", 1e-4, None), ("cu_rigid", 1e-4, None),
                            ("cu_cheb", CHEB_PIN_TOL, None), ("cu_kernel", CHEB_PIN_TOL, None),
                            ("au_exact", 1e-4, "min"), ("au_rigid", 1e-4, "min"),
                            ("au_kernel", 5e-3, "min")):
        ss = zero if pick is None else au_ss
        want = PRISTINE_CU100_E if pick is None else AU_REFERENCE_MIN
        e_gpu = float(eam[name].run.state_energy_fn(ss.to(dev)).surface_energy.min())
        e_cpu = float(cpu[name].run.state_energy_fn(ss).surface_energy.min())
        checks.append(f"{name} {e_gpu:.6f} (|d ref| {abs(e_gpu - want):.2e}, tol {tol}; "
                      f"card-cpu {abs(e_gpu - e_cpu):.1e})")
        if not (abs(e_gpu - want) <= tol and abs(e_gpu - e_cpu) <= 1e-4):
            raise AssertionError(f"[eam-anchor] {name}: card {e_gpu} eV, cpu {e_cpu} eV, "
                                 f"reference {want} eV (tol {tol})")
    e_k = float(eam["cu_kernel"].run.state_energy_fn(zero.to(dev)).surface_energy[0])
    e_c = float(eam["cu_cheb"].run.state_energy_fn(zero.to(dev)).surface_energy[0])
    print(f"[eam-anchor] Cu(100) pristine pin {PRISTINE_CU100_E:.6f} eV, Au(110) ground state "
          f"{AU_REFERENCE_MIN:.6f} eV: " + "; ".join(checks)
          + f"; Cu kernel vs cheb {abs(e_k - e_c):.1e} eV")
    if not abs(e_k - e_c) <= 1e-4:
        raise AssertionError(f"[eam-anchor] Cu pristine kernel {e_k} vs cheb {e_c}")


def au_canonical_phase(eam: dict) -> dict:
    """30. ``au110_eam()``'s canonical run (exact splines) and the
    same through the kernel potential: AU_CANONICAL_CHAINS chains, the
    regression test's configuration; n_ads 6 in every record, the best
    energy within 5e-3 eV of the ground state, a bitwise repeat; the
    kernel run launches row 13 once per state evaluation. Returns the
    kernel run's launch counts."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, geometric_schedule

    cfg = EngineConfig(sweep_size=8, canonical=True, num_ads_atoms=6)
    temps = geometric_schedule(1.0, 20, 0.8)
    n_steps = 20 * cfg.sweep_size
    out = {}
    for name in ("au_exact", "au_kernel"):
        run = eam[name].run
        sef = run.state_energy_fn
        calls = [0]

        def counted(ss, sef=sef):
            calls[0] += 1
            return sef(ss)

        run.state_energy_fn = counted
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, rec = run.run(0, temps, cfg=cfg, n_chains=AU_CANONICAL_CHAINS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        run.state_energy_fn = sef
        state2, rec2 = run.run(0, temps, cfg=cfg, n_chains=AU_CANONICAL_CHAINS)
        same = all(torch.equal(getattr(rec, f), getattr(rec2, f)) for f in rec._fields) \
            and torch.equal(state.site_state, state2.site_state)
        best = float(rec.energy.min())
        want = {k: 0 for k in launches}
        if name == "au_kernel":
            want["eam_rho_ep"] = calls[0]
        n_prep = calls[0] - 2 - n_steps
        print(f"[au-canonical] {name} chains={AU_CANONICAL_CHAINS} sweeps=20x8 prep steps "
              f"{n_prep} n_ads={sorted(set(rec.n_ads.flatten().tolist()))} best={best:.6f} eV "
              f"(|d| {abs(best - AU_REFERENCE_MIN):.2e}, tol 5e-3) accept="
              f"{float(rec.accept_rate.mean()):.4f} bitwise repeat {same}; "
              f"{AU_CANONICAL_CHAINS * (n_steps + n_prep) / dt:.1f} evals/s (one run, the "
              f"prefill included, {dt:.3f} s) launches={json.dumps(launches)}")
        if not ((rec.n_ads == 6).all() and abs(best - AU_REFERENCE_MIN) <= 5e-3 and same
                and launches == want and n_prep >= 0):
            raise AssertionError(f"[au-canonical] {name} failed: best {best}, repeat {same}, "
                                 f"launches {launches} vs {want}")
        out[name] = launches
    return out["au_kernel"]


def cu_relax_mc_phase(dev) -> dict:
    """31. ``cu100_eam(fast=True, relax=RelaxConfig())`` at
    CU_RELAX_CHAINS chains x 1 x 4 steps (forces by autograd through the
    cheb path; row 13 never launches): a bitwise repeat, the final states of
    CU_RELAX_CPU_CHAINS chains FIRE-relaxed on the card and on the CPU plain
    path (RELAXED_E_TOL / RELAXED_POS_TOL), and the kernel potential
    refusing to relax. Returns the run's launch counts."""
    from surface_sampling_tpu_torch.core import energy as core_energy
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        MCMCRun,
        geometric_schedule,
        make_run_fn,
    )
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.parallel.chains import chain_states
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam
    from surface_sampling_tpu_torch.systems import cu100_eam

    sys_ = cu100_eam(fast=True, relax=RelaxConfig(), device=dev)
    run = sys_.run
    crun = make_run_fn(run.d, run.state_energy_fn, EngineConfig(sweep_size=4))
    temps = geometric_schedule(1.0, 1, 0.99)
    states = chain_states(run.d, CU_RELAX_CHAINS)
    first = run.state_energy_fn(states.site_state)
    states = states._replace(energy=first.surface_energy, relaxed_positions=first.positions)
    iters, fire = [], core_energy.fire_relax

    def recorded(*a, **k):
        res = fire(*a, **k)
        iters.append(res.n_steps)
        return res

    torch.cuda.synchronize()
    reset_launch_counts()
    core_energy.fire_relax = recorded
    try:
        t0 = time.perf_counter()
        out_a, rec_a = crun(states, temps, _gen(0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        core_energy.fire_relax = fire
    launches = launch_counts()
    out_b, rec_b = crun(states, temps, _gen(0))
    same = all(torch.equal(a, b) for a, b in zip(out_a, out_b)) and \
        torch.equal(rec_a.positions, rec_b.positions)
    ss = out_a.site_state[:CU_RELAX_CPU_CHAINS]
    gpu = run.state_energy_fn(ss)
    cpu = cu100_eam(fast=True, relax=RelaxConfig(), device="cpu").run.state_energy_fn(ss.cpu())
    de = float((gpu.surface_energy.cpu() - cpu.surface_energy).abs().max())
    dp = float((gpu.positions.cpu() - cpu.positions).abs().max())
    moved = float((out_a.relaxed_positions - states.relaxed_positions).abs().max())
    kernel = MCMCRun(sys_.spec, make_eam_kernel_potential(builtin_eam("Cu_u3"), sys_.static_nbr,
                                                          device=dev),
                     device=dev, relax=RelaxConfig())
    try:
        kernel.state_energy_fn(ss)
        refused = False
    except NotImplementedError:
        refused = True
    it = torch.stack(iters).float()
    print(f"[cu-relax-mc] chains={CU_RELAX_CHAINS} sweeps=1x4 "
          f"evals/s={CU_RELAX_CHAINS * 4 / dt:.1f} step_ms={1e3 * dt / 4:.3f} (one run) "
          f"fire_iters_mean={float(it.mean()):.3f} max={int(it.max())} "
          f"accept={float(rec_a.accept_rate.mean()):.4f} best={float(rec_a.energy.min()):.6f} eV "
          f"bitwise repeat {same}; {CU_RELAX_CPU_CHAINS} final states card vs cpu |dE| {de:.3e} "
          f"eV (tol {RELAXED_E_TOL}) |dx| {dp:.3e} A (tol {RELAXED_POS_TOL}); max relaxed "
          f"displacement {moved:.4f} A; kernel potential refuses to relax: {refused}; "
          f"launches={json.dumps(launches)}")
    if not (same and de <= RELAXED_E_TOL and dp <= RELAXED_POS_TOL and refused
            and not any(launches.values()) and torch.isfinite(rec_a.energy).all()):
        raise AssertionError("[cu-relax-mc] failed")
    return launches


def eam_phases(dev) -> tuple[list, dict]:
    """Every EAM phase; returns row 13 and the launch counts of its paths."""
    t0 = time.perf_counter()
    eam = eam_systems(dev)
    cu, au = eam["cu_kernel"], eam["au_kernel"]
    print(f"[eam-build] Cu(100) slots={cu.spec.n_slots} sites={cu.spec.n_sites} "
          f"M={cu.static_nbr.slot_j.shape[1]}; Au(110) slots={au.spec.n_slots} sites="
          f"{au.spec.n_sites} M={au.static_nbr.slot_j.shape[1]}; host build "
          f"{time.perf_counter() - t0:.1f}s")
    row = eam_kernel_phase(eam)
    torch.cuda.empty_cache()
    eam_anchor_phase(eam, dev)
    paths = {}
    paths["cu_mc"], rate, _ = full_mc_phase("cu-mc", eam["cu_kernel"], CU_MC_SWEEPS,
                                            {"eam_rho_ep": 1}, n_chains=CU_MC_CHAINS,
                                            sweep_size=CU_MC_SWEEP_SIZE)
    paths["cu_rigid_mc"], rate_rigid, _ = full_mc_phase(
        "cu-mc-rigid", eam["cu_rigid"], CU_MC_SWEEPS, {}, n_chains=CU_MC_CHAINS,
        sweep_size=CU_MC_SWEEP_SIZE)
    print(f"[cu-mc] kernel potential {rate:.1f} evals/s beside make_eam_rigid (bench.py's "
          f"fallback path) {rate_rigid:.1f} evals/s at {CU_MC_CHAINS} chains")
    torch.cuda.empty_cache()
    paths["au_canonical"] = au_canonical_phase(eam)
    torch.cuda.empty_cache()
    paths["cu_relax_mc"] = cu_relax_mc_phase(dev)
    return [row], paths


# ----------------------------------------------------------------------
# PaiNN force-loss training (slice 7): row 5 and the fine-tuning path
# ----------------------------------------------------------------------
# tools/bench_all.py's bench_painn_train shape: 16 frames of the SrTiO3(001)
# 2x2 slab (60 atoms, 9 image shifts, M = 64) jittered by N(0, 0.03 A), the
# flagship's 3 members; 1 untimed step, then 3 timed runs of 4 Adam steps
TRAIN_FRAMES, TRAIN_JITTER = 16, 0.03
TRAIN_STEPS, TRAIN_RUNS, TRAIN_LR = 4, 3, 1e-4
# card vs CPU of one training step: the loss to 1e-5 relative, every
# gradient leaf within 1e-3 x max|cpu| of that leaf (f32 sums over 2 x 60
# atoms and 64 edges in other orders, through two differentiations)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3


def bwd2_flops_per_edge(F: int, R: int) -> int:
    """Row 5's work per live edge and member, each term counted once (per
    channel f): the radial products, 29R (the filter and G, 3 x 2R each;
    the d_dw partials, 3 x 4R; the d_rbf product, 5R), the sum over the
    channels of the R + 4 edge cotangents (R + 4), and 126 scalar
    operations: the channel terms (w, h, q, t, a, dwpre, Z and the d_gds /
    d_gdv sums, 93), d_db (3), d_envm's summand (11), d_unit's (3) and the
    neighbour kernel's d_phi / d_vcat sums (16). The neighbour kernel's
    recomputation of the filter, G and the scalars they feed is the
    design's, not the function's, and is not counted."""
    return F * (30 * R + 130)


def train_frames(n: int = TRAIN_FRAMES):
    """``n`` frames of the SrTiO3(001) 2x2 slab, positions jittered by
    N(0, TRAIN_JITTER A) from np.random.default_rng(0)."""
    from surface_sampling_tpu_torch.structure.atoms import Structure
    from surface_sampling_tpu_torch.systems import SYSTEMS_DATA

    data = np.load(SYSTEMS_DATA / "SrTiO3_001_2x2.npz")
    rng = np.random.default_rng(0)
    return [Structure(data["numbers"],
                      data["positions"] + rng.normal(0, TRAIN_JITTER, data["positions"].shape),
                      data["cell"]) for _ in range(n)]


def train_setup(dev):
    """The flagship ensemble on ``dev``, the frames, and their labels: the
    ensemble-mean energies and forces (``get_prediction``), so each
    member's loss starts at its spread from the mean."""
    from surface_sampling_tpu_torch.models.prediction import get_prediction
    from surface_sampling_tpu_torch.models.train import pad_structures
    from surface_sampling_tpu_torch.models.weights import load_painn_ensemble
    from surface_sampling_tpu_torch.systems import MODEL_DATA

    params, cfg = load_painn_ensemble(
        [MODEL_DATA / f"srtio3_painn_{i:02d}.npz" for i in (1, 2, 3)], dev)
    frames = train_frames()
    unlabelled = pad_structures(frames, np.zeros(len(frames)),
                                [np.zeros((len(s), 3)) for s in frames], cfg.cutoff)
    pred = get_prediction(params, cfg, unlabelled, ensemble=True)
    labels = (pred["energy"].cpu().numpy().astype(np.float64),
              [f[:len(s)] for f, s in zip(pred["forces"].cpu().numpy(), frames)])
    batch = unlabelled._replace(energy=labels[0], forces=pred["forces"].cpu().numpy())
    return params, cfg, frames, labels, batch


def bwd2_phase(params, cfg, batch, dev) -> dict:
    """[bwd2] Row 5 against its plain version at the training path's
    shapes: the 16 frames' real geometry from neighbor_list, seeded random
    features and cotangents (c_envm zero on masked edges, as training makes
    it), and, as make_loss_fn launches it, one member at a time (K = 1) with
    that member's layer-2 weights, for each of the 3 members. All nine
    outputs within KERNEL_RTOL x max|plain|, with c_dw = c_db = 0 (the skip
    flag on) and nonzero; a bitwise repeat; times and the bound over live
    edges per K = 1 launch. As an extra, the 3 members stacked in one launch
    (K = 3), a shape the training path does not make."""
    from surface_sampling_tpu_torch.models.painn import message_weights, structure_edges
    from surface_sampling_tpu_torch.models.train import batch_to_device
    from surface_sampling_tpu_torch.ops import painn_kernels as pk

    b = batch_to_device(batch, dev)
    _, (rbf, envm, nbr, unit, n_pad, rev) = structure_edges(cfg, b.positions, b.numbers,
                                                             b.shifts)
    dw3, db3 = message_weights(params["message"][1], cfg, rbf.shape[-1])
    C, E, R = rbf.shape
    n_members, F = dw3.shape[0], cfg.feat_dim
    M = E // n_pad
    gen = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def operands(dw, db):
        K = dw.shape[0]
        args = (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), rbf, envm, nbr, unit, dw, db,
                rn(C, K, n_pad, F), rn(C, K, n_pad, 3 * F))
        cots = (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), rn(C, E, R),
                rn(C, E) * (envm != 0), rn(C, 3, n_pad, M))
        return args, cots

    names = ("dphi", "dvcat", "drbf", "denvm", "dunit", "ddw", "ddb", "dgds", "dgdv")
    errs = {}

    def check(tag, args, cots):
        K = args[6].shape[0]
        for case, cw in (("c_dw=0", (None, None)), ("c_dw!=0", (rn(K, R, 3 * F), rn(K, 3 * F)))):
            got = pk.painn_message_bwd2(*args, *cots, *cw, rev=rev)
            ref = pk.painn_message_bwd2_plain(*args, *cots, *cw)
            torch.cuda.synchronize()
            # the dead-slot contract: d_envm exactly 0 where envm and c_envm
            # are, compared on the other slots
            live = (args[3] != 0) | (cots[3] != 0)
            if bool((got[3][~live] != 0).any()):
                raise AssertionError(f"painn_message_bwd2 ({tag}, {case}): d_envm is not "
                                     "exactly zero on dead slots")
            for n, g, r in zip(names, got, ref):
                if n == "denvm":
                    g, r = g[live], r[live]
                err, scale = float((g - r).abs().max()), float(r.abs().max())
                errs[f"{n} {case}"] = max(err, errs.get(f"{n} {case}", 0.0))
                if not err <= KERNEL_RTOL * scale:
                    raise AssertionError(
                        f"painn_message_bwd2 {n} ({tag}, {case}): max abs error {err} "
                        f"exceeds {KERNEL_RTOL} x max|plain| = {KERNEL_RTOL * scale}")
            again = pk.painn_message_bwd2(*args, *cots, *cw, rev=rev)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"painn_message_bwd2 ({tag}, {case}): two launches differ")
            del got, ref, again

    # the main path's launches: one member (K = 1) at a time
    members = [operands(dw3[k:k + 1], db3[k:k + 1]) for k in range(n_members)]
    for k, (args, cots) in enumerate(members):
        check(f"member {k + 1}", args, cots)
    ms = _cuda_ms(lambda: [pk.painn_message_bwd2(*a, *c, rev=rev) for a, c in members],
                  reps=10) / n_members
    ms_cdw = _cuda_ms(lambda: [pk.painn_message_bwd2(*a, *c, a[6], a[7], rev=rev)
                               for a, c in members], reps=5) / n_members
    plain_ms = _cuda_ms(lambda: [pk.painn_message_bwd2_plain(*a, *c) for a, c in members],
                        reps=2, warm=1) / n_members
    # the extra: all members stacked in one launch
    args3, cots3 = operands(dw3, db3)
    check(f"K={n_members}", args3, cots3)
    ms_k3 = _cuda_ms(lambda: pk.painn_message_bwd2(*args3, *cots3, rev=rev), reps=10)
    n_live = int((envm != 0).sum())
    flops = n_live * bwd2_flops_per_edge(F, cfg.n_rbf)
    products = n_live * F * 29 * cfg.n_rbf       # the radial products of bwd2_flops_per_edge
    # one K = 1 launch: feature tables and their cotangents whole; edge
    # arrays of live edges only (rbf, c_rbf, d_rbf: R; envm, c_envm,
    # d_envm, nbr; unit, c_unit, d_unit: 3); one member's weights and
    # their cotangents; the reverse table
    feat = C * n_pad * (3 * F * 8 + F * 2)
    nbytes = 4 * (feat + n_live * (3 * R + 4 + 9) + 2 * (R * 3 * F + 3 * F)) + _nbytes(rev)
    bound_ms, bound_tc_ms, _ = bwd_bounds(products, flops - products, nbytes)
    n_slots = C * n_pad * M
    err = max(errs.values())
    print(f"[bwd2] painn_message_bwd2 max_abs_err={err:.3e} (all nine outputs, K = 1 for each "
          f"of {n_members} members and K = {n_members} stacked, c_dw zero and nonzero, each "
          f"within {KERNEL_RTOL} x max|plain|; {json.dumps(errs)}) bitwise repeat ok; per K = 1 "
          f"launch (the training path's): ms={ms:.4f} (c_dw=0, the training case) "
          f"ms_with_c_dw={ms_cdw:.4f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} (f32) "
          f"bound_tc_ms={bound_tc_ms:.4f} (3xTF32 products) d_envm exactly 0 on the "
          f"{n_slots - n_live} dead slots (envm == 0 and c_envm == 0), compared on the live "
          f"ones; frames={C} n_pad={n_pad} M={M} live_edges={n_live} of {n_slots} slots "
          f"(live share {n_live / n_slots:.4f}) flops={flops:.4e} "
          f"bytes={nbytes:.4e}; K = {n_members} in one launch (not on the training path): "
          f"ms={ms_k3:.4f}; library_ms=null (no PyTorch call computes this fused "
          f"second-order block)")
    return {"name": "painn_message_bwd2", "route": "cuda",
            "source": "surface_sampling_tpu_torch/csrc/painn_message_bwd2.cu",
            "replaces": "surface_sampling_tpu/ops/pallas_painn.py:651",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES_PER_S
            else "bytes", "library_ms": None, "ms_with_c_dw": ms_cdw,
            f"ms_k{n_members}_stacked": ms_k3, "live_edges": n_live,
            "live_share": n_live / n_slots}


def _loss_and_grads(params, cfg, batch, dev):
    """The training loss of every member of ``params`` on ``batch`` and its
    gradient over each parameter leaf, on the host."""
    from surface_sampling_tpu_torch.models.painn import tree_leaves, tree_map
    from surface_sampling_tpu_torch.models.train import TrainConfig, batch_to_device, make_loss_fn

    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    loss = make_loss_fn(cfg, TrainConfig())(p, batch_to_device(batch, dev))
    return loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss.sum(), leaves)]


def train_grad_phase(params, cfg, batch, dev) -> None:
    """[train-grad] One training step's loss and every parameter gradient
    of one member (srtio3_painn_01.npz) on 2 frames: the card against the
    CPU plain path."""
    from surface_sampling_tpu_torch.models.painn import tree_map

    one = tree_map(lambda x: x[:1], params)
    two = batch._replace(**{k: getattr(batch, k)[:2] for k in
                            ("positions", "numbers", "shifts", "energy", "forces")})
    lg, gg = _loss_and_grads(one, cfg, two, dev)
    lc, gc = _loss_and_grads(tree_map(lambda x: x.cpu(), one), cfg, two, torch.device("cpu"))
    dl = abs(float(lg[0]) - float(lc[0])) / abs(float(lc[0]))
    worst = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(gg, gc))
    print(f"[train-grad] one member, 2 frames: loss card {float(lg[0]):.8e} cpu "
          f"{float(lc[0]):.8e} rel diff {dl:.3e} (tol {TRAIN_LOSS_RTOL}); {len(gg)} gradient "
          f"leaves, worst max|card - cpu| / max|cpu| {worst:.3e} (tol {TRAIN_GRAD_RTOL})")
    if not (dl <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL):
        raise AssertionError("card and CPU training gradients differ")


def train_phase(params, cfg, batch, dev) -> dict:
    """[train] The main path: a Trainer on the 3-member ensemble, 16 frames,
    lr 1e-4 (TrainConfig defaults otherwise): 1 untimed step, then
    TRAIN_RUNS timed runs of TRAIN_STEPS Adam steps, one optimizer
    trajectory; structures/s and ms a step (best run), row 2, 4 and 5
    launches per step, the loss before each step, which must stay finite and
    fall over the timed steps.
    Returns the launch counts of the timed runs."""
    from surface_sampling_tpu_torch.models.train import TrainConfig, Trainer, batch_to_device

    trainer = Trainer(params, cfg, TrainConfig(learning_rate=TRAIN_LR), ensemble=True)
    b = batch_to_device(batch, dev)
    history = [trainer.step(b)]
    torch.cuda.synchronize()
    times = []
    reset_launch_counts()
    for _ in range(TRAIN_RUNS):
        t0 = time.perf_counter()
        history += [trainer.step(b) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / TRAIN_STEPS)
    counts = launch_counts()
    steps = TRAIN_RUNS * TRAIN_STEPS
    per_step = {k: counts[k] / steps for k in ("painn_message_fused", "painn_message_bwd",
                                               "painn_message_bwd.g_dw", "painn_message_bwd2")}
    step = min(times)
    print(f"[train] 3 members x {TRAIN_FRAMES} frames, 1 + {TRAIN_RUNS} x {TRAIN_STEPS} Adam "
          f"steps (lr {TRAIN_LR}): {TRAIN_FRAMES / step:.2f} structures/s, step "
          f"{1e3 * step:.3f} ms (best run; runs {[round(1e3 * t, 3) for t in times]} ms); "
          f"launches per step {json.dumps(per_step)} (rows 2 / 4 / 5); loss before each step "
          f"{[float(f'{h:.6e}') for h in history]}")
    # from the labels' own ensemble the first Adam step (lr per parameter in
    # the gradient's sign) overshoots; the timed steps must bring the loss
    # below both the starting loss and that overshoot
    if not all(np.isfinite(history)) or not history[-1] < min(history[0], history[1]):
        raise AssertionError(f"the training loss did not fall over the timed steps: {history}")
    if counts["painn_message_bwd2"] == 0:
        raise AssertionError("the training path did not launch painn_message_bwd2")
    return counts


def finetune_cli_phase(frames, labels, dev) -> None:
    """[finetune-cli] The port's CLI on the card (default device): a flat
    JSON dataset of the frames and their labels, --init with one member, 2
    epochs. The four output files exist, and the saved model gives the
    energies of the same training run in this process (same data, split
    and seed) within 1e-6 relative."""
    import tempfile
    from pathlib import Path

    from surface_sampling_tpu_torch.cli import finetune
    from surface_sampling_tpu_torch.models.dataset import get_train_val_test_loader
    from surface_sampling_tpu_torch.models.painn import painn_apply_structures, stack_members
    from surface_sampling_tpu_torch.models.train import TrainConfig, batch_to_device, train_painn
    from surface_sampling_tpu_torch.models.weights import (
        from_jax_params,
        load_painn_npz,
    )
    from surface_sampling_tpu_torch.systems import MODEL_DATA

    init = MODEL_DATA / "srtio3_painn_01.npz"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        recs = [{"numbers": s.numbers.tolist(), "positions": s.positions.tolist(),
                 "cell": s.cell.tolist(), "energy": float(e), "forces": f.tolist()}
                for s, e, f in zip(frames, labels[0], labels[1])]
        (tmp / "frames.json").write_text(json.dumps(recs))
        t0 = time.perf_counter()
        finetune.main(["--data", str(tmp / "frames.json"), "--init", str(init), "--out",
                       str(tmp / "out"), "--epochs", "2"])
        dt = time.perf_counter() - t0
        missing = [n for n in ("model.npz", "history.csv", "metrics.json", "settings.json")
                   if not (tmp / "out" / n).exists()]
        if missing:
            raise AssertionError(f"finetune CLI wrote no {missing}")
        metrics = json.loads((tmp / "out" / "metrics.json").read_text())
        saved, cfg = load_painn_npz(tmp / "out" / "model.npz")
        tree, _ = load_painn_npz(init)
        train, _, _ = get_train_val_test_loader(tmp / "frames.json", cfg.cutoff)
        trained, _ = train_painn(from_jax_params(tree, dev), cfg, train,
                                 TrainConfig(epochs=2))
        b = batch_to_device(train[0], dev)
        e_saved, e_here = (painn_apply_structures(stack_members([p]), cfg, b.positions,
                                                  b.numbers, b.shifts)["energy"][:, 0]
                           for p in (from_jax_params(saved, dev), trained))
        diff = float(((e_saved - e_here).abs() / e_here.abs()).max())
    print(f"[finetune-cli] --init srtio3_painn_01.npz, 2 epochs on {len(frames)} frames: "
          f"{dt:.1f}s wall, final train loss {metrics['final_train_loss']:.6e} val "
          f"{metrics['val_loss']:.6e} test {metrics['test_loss']:.6e} on {metrics['device']}; "
          f"four files written; saved model vs the same training in-process: max rel energy "
          f"diff {diff:.3e} (tol 1e-6)")
    if not diff <= 1e-6:
        raise AssertionError(f"the saved model's energies differ from the trained ones: {diff}")


def training_phases(dev) -> tuple[list, dict]:
    """Every training phase; returns row 5 and the launch counts of the
    training path."""
    t0 = time.perf_counter()
    params, cfg, frames, labels, batch = train_setup(dev)
    print(f"[train-build] {len(frames)} frames, labels from the 3-member ensemble mean "
          f"({time.perf_counter() - t0:.1f}s); label energies {labels[0][:4].tolist()} ...")
    row = bwd2_phase(params, cfg, batch, dev)
    torch.cuda.empty_cache()
    train_grad_phase(params, cfg, batch, dev)
    counts = train_phase(params, cfg, batch, dev)
    torch.cuda.empty_cache()
    finetune_cli_phase(frames, labels, dev)
    return [row], {"train": counts}


# ----------------------------------------------------------------------
# The rest of the MC engine (slice 14): distance criteria, multiple-try
# Metropolis, the delta and local-relax canonical steps, L-BFGS and
# symmetric slabs; the many-body systems GaN(0001) Tersoff, Si(111) 5x5 SW
# ----------------------------------------------------------------------
FILTER_DISTANCE = 1.5        # EngineConfig's default hard wall
MTM_K, MTM_STEPS = 8, 4      # semigrand MTM on the rigid 1x1: 128 chains x 1 x 4
# canonical MTM on Au(110) through the kernel potential (row 13), the chain
# count of [au-canonical]
MTM_CAN_K, MTM_CAN_SWEEPS = 4, 4
LBFGS_CHAINS, LBFGS_STEPS = 32, 2
# L-BFGS card vs CPU positions: its zoom line search branches on f32 value
# comparisons, so the relaxed geometry moves by several 1e-2 A under a 1e-6 A
# change of the start (`[lbfgs-relax]` prints the card's own response beside
# the card-vs-CPU difference); energies stay within RELAXED_E_TOL
LBFGS_POS_TOL = 0.1
INC_CAN_SWEEPS = 2             # delta canonical at 2x2: 128 chains x 2 x 8
INC_CAN_ADS = 8                # adsorbates a chain of its random start states
LOCAL_CAN_STEPS = 4
LOCAL_CAN_ADS = 4              # adsorbates a chain of its random start states
# GaN(0001) 3x3 x 4 layers (the tutorial slab): canonical from an even
# prefill of GAN_ADS adsorbates; Si(111) 5x5: semigrand from empty
GAN_CHAINS, GAN_FAST_CHAINS, GAN_RELAX_CHAINS, GAN_ADS = 512, 8192, 64, 6
SI_CHAINS, SI_FAST_CHAINS, SI_RELAX_CHAINS = 512, 2048, 64
MB_SWEEPS, MB_RELAX_STEPS = 2, 2
# card vs CPU of the plain many-body paths: sums of ~600 eV in another order
MB_CARD_CPU_TOL = 1e-3
GAN_TUTORIAL_E = -144.059            # the reference tutorial's LAMMPS value
SI111_PRISTINE_E = -379.42511        # tests/test_manybody_potentials.py's pin
SYM_CHAINS, SYM_CPU_CHAINS = 1024, 8


def _bitwise(a, b) -> bool:
    """Every tensor field of two (state, record) pairs equal bitwise."""
    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for v in x for t in leaves(v)] if isinstance(x, tuple) else []

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _rigid_launches(n_evals: int) -> dict:
    return {k: v * n_evals for k, v in RIGID_LAUNCHES.items()}


def _expect(tag: str, launches: dict, want: dict) -> None:
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise AssertionError(f"[{tag}] launch counts {launches}, expected {full}")


def criteria_phase(sys1, sys2, dev) -> dict:
    """36. The distance criteria: make_distance_accept's masks on random
    occupancies of the 1x1 and the 2x2, card vs CPU bitwise; metropolis_distance
    full-evaluation MC at 1x1 (N_CHAINS x 1 x SWEEP_SIZE) and delta-engine MC
    at 2x2 (N_CHAINS x 1 x SWEEP_SIZE): no recorded state violates the
    filter; launch counts. Returns the two runs' launch counts."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, make_run_fn
    from surface_sampling_tpu_torch.core.events import make_distance_accept
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_painn_from_system,
        make_incremental_run,
        make_incremental_semigrand_step,
    )
    from surface_sampling_tpu_torch.core.state import device_spec
    from surface_sampling_tpu_torch.parallel.chains import chain_states, incremental_chain_states

    rng = np.random.default_rng(14)
    masks = []
    for tag, sys_ in (("1x1", sys1), ("2x2", sys2)):
        # occupied shares spread from 1% to 25% over the chains, so that some
        # states pass the filter and some do not
        spec = sys_.spec
        occupied = rng.random((N_CHAINS, spec.n_sites)) < np.linspace(0.01, 0.25, N_CHAINS)[:, None]
        ss = torch.as_tensor(np.where(occupied, rng.integers(1, spec.n_codes, occupied.shape), 0))
        t0 = time.perf_counter()
        accept = make_distance_accept(sys_.run.d, FILTER_DISTANCE)
        build_s = time.perf_counter() - t0
        got = accept(ss.to(dev)).cpu()
        want = make_distance_accept(device_spec(spec, torch.device("cpu")), FILTER_DISTANCE)(ss)
        masks.append(f"{tag} {spec.n_sites} sites: card = cpu bitwise "
                     f"{torch.equal(got, want)}, pass share {float(want.float().mean()):.3f}, "
                     f"candidate build {build_s:.2f}s")
        if not (torch.equal(got, want) and 0 < int(want.sum()) < N_CHAINS):
            raise AssertionError(f"[criteria] {tag}: card {got.tolist()} cpu {want.tolist()}")
    print(f"[criteria] make_distance_accept (filter {FILTER_DISTANCE} A, {N_CHAINS} random "
          f"occupancies): " + "; ".join(masks))
    temps = np.array([1.0])
    out = {}

    # full evaluation at 1x1
    d, sef = sys1.run.d, sys1.run.state_energy_fn
    check = make_distance_accept(d, FILTER_DISTANCE)
    run = make_run_fn(d, sef, EngineConfig(sweep_size=SWEEP_SIZE, record_positions=False,
                                           criterion="metropolis_distance",
                                           filter_distance=FILTER_DISTANCE))
    torch.cuda.synchronize()
    reset_launch_counts()
    states = chain_states(d, N_CHAINS)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    t0 = time.perf_counter()
    fin, rec = run(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["dist_mc"] = launch_counts()
    _expect("dist-mc", out["dist_mc"], _rigid_launches(1 + SWEEP_SIZE))
    ok = bool(check(rec.site_state.reshape(-1, d.site_coords.shape[0])).all())
    print(f"[dist-mc] 1x1 metropolis_distance chains={N_CHAINS} sweeps=1x{SWEEP_SIZE} "
          f"evals/s={N_CHAINS * SWEEP_SIZE / dt:.1f} (one run) accept="
          f"{float(rec.accept_rate.mean()):.4f} n_ads mean {float(rec.n_ads.float().mean()):.2f}"
          f"; every recorded state passes the filter: {ok}; "
          f"launches={json.dumps(out['dist_mc'])}")
    if not (ok and torch.isfinite(rec.energy).all()):
        raise AssertionError("[dist-mc] a state violates the filter or an energy is not finite")

    # the delta engine at 2x2
    engine = make_incremental_painn_from_system(sys2)
    d2 = sys2.run.d
    check2 = make_distance_accept(d2, FILTER_DISTANCE)
    step = make_incremental_semigrand_step(engine, d2, criterion="metropolis_distance",
                                           filter_distance=FILTER_DISTANCE)
    irun = make_incremental_run(step, SWEEP_SIZE, engine.n_sites, engine.n_codes)
    torch.cuda.synchronize()
    reset_launch_counts()
    states = incremental_chain_states(engine, d2, N_CHAINS)
    t0 = time.perf_counter()
    fin, rec = irun(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["inc_dist"] = launch_counts()
    L = len(states.caches.s)
    want = dict(INC_INIT_LAUNCHES)
    want["painn_message_subset"] = L * SWEEP_SIZE
    want["painn_update_fused"] += L * SWEEP_SIZE
    _expect("inc-dist", out["inc_dist"], want)
    ok = bool(check2(rec.site_state.reshape(-1, engine.n_sites)).all())
    fresh = engine.energy_full(fin.site_state)[0]
    drift = float((fresh - fin.energy).abs().max())
    print(f"[inc-dist] 2x2 delta engine, metropolis_distance chains={N_CHAINS} sweeps=1x"
          f"{SWEEP_SIZE} steps/s={N_CHAINS * SWEEP_SIZE / dt:.1f} (one run) accept="
          f"{float(rec.accept_rate.mean()):.4f}; every recorded state passes the filter: {ok}; "
          f"cached vs fresh {drift:.3e} eV (tol 1e-3); launches={json.dumps(out['inc_dist'])}")
    if not (ok and drift <= 1e-3):
        raise AssertionError("[inc-dist] a state violates the filter or the caches drift")
    return out


def mtm_phase(sys1, dev) -> dict:
    """37. Multiple-try Metropolis: semigrand, K = MTM_K, on the rigid 1x1
    (N_CHAINS x 1 x MTM_STEPS; the K trials and K - 1 references of every
    chain as two batched evaluations a step, so rows 1-3 launch twice a
    step at C K and C (K-1) chains), steps/s and evaluations/s, a bitwise
    repeat; canonical, K = MTM_CAN_K, on Au(110) through the EAM kernel
    potential at AU_CANONICAL_CHAINS chains: n_ads 6 in every record, row
    13 once per state evaluation, a bitwise repeat. Returns both runs'
    launch counts."""
    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        MCMCRun,
        geometric_schedule,
        make_run_fn,
    )
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.parallel.chains import chain_states
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam
    from surface_sampling_tpu_torch.systems import au110_eam

    out = {}
    d, sef = sys1.run.d, sys1.run.state_energy_fn
    run = make_run_fn(d, sef, EngineConfig(sweep_size=MTM_STEPS, record_positions=False,
                                           mtm_trials=MTM_K))
    temps = np.array([1.0])
    torch.cuda.synchronize()
    reset_launch_counts()
    states = chain_states(d, N_CHAINS)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    res_a = run(states, temps, _gen(0))
    torch.cuda.synchronize()
    out["mtm_mc"] = launch_counts()
    _expect("mtm-mc", out["mtm_mc"], _rigid_launches(1 + 2 * MTM_STEPS))
    res_b = run(states, temps, _gen(0))
    same = _bitwise(res_a, res_b)
    dt = _best_of(lambda seed: run(states, temps, _gen(seed)))
    per_step = {k: (v - RIGID_LAUNCHES[k]) / MTM_STEPS for k, v in out["mtm_mc"].items()
                if k in RIGID_LAUNCHES}
    rec = res_a[1]
    print(f"[mtm-mc] 1x1 semigrand MTM K={MTM_K} chains={N_CHAINS} steps={MTM_STEPS} "
          f"steps/s={N_CHAINS * MTM_STEPS / dt:.1f} evals/s="
          f"{N_CHAINS * MTM_STEPS * (2 * MTM_K - 1) / dt:.1f} (2K-1 = {2 * MTM_K - 1} a chain "
          f"a step) step_ms={1e3 * dt / MTM_STEPS:.3f} accept={float(rec.accept_rate.mean()):.4f} "
          f"best={float(rec.energy.min()):.6f} eV; launches a step of rows 1-3 "
          f"{json.dumps(per_step)} (batches of {N_CHAINS * MTM_K} and "
          f"{N_CHAINS * (MTM_K - 1)} states); bitwise repeat {same}; "
          f"launches={json.dumps(out['mtm_mc'])}")
    if not (same and torch.isfinite(rec.energy).all()):
        raise AssertionError("[mtm-mc] the MTM run does not repeat bitwise")

    au = au110_eam(device=dev)
    tables = builtin_eam("Au_u3")
    nbr = build_static_neighbor_table(au.spec, tables.cutoff, relax_slack=0.05)
    krun = MCMCRun(au.spec, make_eam_kernel_potential(tables, nbr, device=dev), device=dev)
    cfg = EngineConfig(sweep_size=SWEEP_SIZE, canonical=True, num_ads_atoms=6,
                       mtm_trials=MTM_CAN_K, record_positions=False)
    temps = geometric_schedule(1.0, MTM_CAN_SWEEPS, 0.8)
    sef_k, calls = krun.state_energy_fn, [0]

    def counted(ss):
        calls[0] += 1
        return sef_k(ss)

    krun.state_energy_fn = counted
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res_a = krun.run(0, temps, cfg=cfg, n_chains=AU_CANONICAL_CHAINS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["mtm_canonical"] = launch_counts()
    krun.state_energy_fn = sef_k
    res_b = krun.run(0, temps, cfg=cfg, n_chains=AU_CANONICAL_CHAINS)
    same = _bitwise(res_a, res_b)
    rec = res_a[1]
    n_steps = MTM_CAN_SWEEPS * SWEEP_SIZE
    n_prep = calls[0] - 2 - 2 * n_steps
    best = float(rec.energy.min())
    _expect("mtm-canonical", out["mtm_canonical"], {"eam_rho_ep": calls[0]})
    print(f"[mtm-canonical] Au(110) kernel potential, canonical MTM K={MTM_CAN_K} chains="
          f"{AU_CANONICAL_CHAINS} sweeps={MTM_CAN_SWEEPS}x{SWEEP_SIZE} prep steps {n_prep} "
          f"n_ads={sorted(set(rec.n_ads.flatten().tolist()))} accept="
          f"{float(rec.accept_rate.mean()):.4f} best={best:.6f} eV (ground state "
          f"{AU_REFERENCE_MIN:.6f}); {AU_CANONICAL_CHAINS * n_steps * (2 * MTM_CAN_K - 1) / dt:.1f}"
          f" evals/s (one run, the prefill included, {dt:.3f} s); bitwise repeat {same}; "
          f"launches={json.dumps(out['mtm_canonical'])}")
    if not ((rec.n_ads == 6).all() and same and n_prep >= 0):
        raise AssertionError("[mtm-canonical] n_ads changed or the run does not repeat")
    return out


def _delta_vs_fresh(engine, ss, gen, tag: str = "inc-canonical") -> str:
    """One canonical draw from occupancies ``ss``: the one-site (site1 takes
    site2's code) and the two-site (the exchange) delta against a fresh full
    evaluation of the trial state, which must agree bitwise (max |diff| 0:
    the delta recomputes its rows through the full evaluation's functions);
    the JAX package's rule for delta vs full evaluations (1e-4 eV + 1e-5
    relative) is printed beside it."""
    from surface_sampling_tpu_torch.core.events import canonical_draws, pick_exchange
    from surface_sampling_tpu_torch.core.state import change_site, exchange_sites

    st = engine.init_state(ss)
    g_t, g1, g2, _ = canonical_draws(gen, ss.shape[0], engine.n_sites, engine.n_codes)
    s1, s2, _ = pick_exchange(ss, engine.n_codes, g_t, g1, g2)
    out = []
    for kind, trial, sites in (
            ("one-site", change_site(ss, s1, torch.gather(ss, 1, s2[:, None])[:, 0]), s1[:, None]),
            ("two-site", exchange_sites(ss, s1, s2), torch.stack([s1, s2], 1))):
        fresh = engine.energy_full(trial)[0]
        diff = (engine.delta(st.caches, trial, sites)[0] - fresh).abs()
        rule = bool((diff <= 1e-4 + 1e-5 * fresh.abs()).all())
        out.append(f"{kind} max |delta - fresh| {float(diff.max()):.3e} eV (bitwise: "
                   f"{float(diff.max()) == 0.0}; relative {float((diff / fresh.abs()).max()):.2e}, "
                   f"within the JAX rule: {rule})")
        if float(diff.max()) != 0.0:
            raise AssertionError(f"[{tag}] {kind} delta vs fresh: {float(diff.max())} eV")
    return f"|E| up to {float(fresh.abs().max()):.1f} eV: " + "; ".join(out)


def inc_canonical_phase(sys2, dev) -> dict:
    """38. Delta-engine canonical MC at 2x2, N_CHAINS x INC_CAN_SWEEPS x
    SWEEP_SIZE from random occupancies of INC_CAN_ADS adsorbates a chain:
    n_ads constant, cached energies within 1e-3 eV of a fresh full
    evaluation, a bitwise repeat; rows 7, 8 and 3 launch (the initial full
    evaluation, then per step the subset message and the update of every
    layer). Besides, one move from crowded random occupancies (a quarter of
    the sites occupied, energies up to the 1e4-eV clamp), one- and two-site
    deltas against fresh evaluations: bitwise equal (the JAX package's
    relative rule printed beside). Returns the launch counts."""
    from surface_sampling_tpu_torch.core.engine import geometric_schedule
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_canonical_step,
        make_incremental_painn_from_system,
        make_incremental_run,
    )
    from surface_sampling_tpu_torch.parallel.chains import incremental_chain_states

    engine = make_incremental_painn_from_system(sys2)
    d = sys2.run.d
    rng = np.random.default_rng(38)
    crowded = _delta_vs_fresh(engine, _states(sys2.spec, N_CHAINS, rng, dev), _gen(0))
    print(f"[inc-canonical] crowded 2x2 occupancies, one move: {crowded}")
    irun = make_incremental_run(make_incremental_canonical_step(engine), SWEEP_SIZE,
                                engine.n_sites, engine.n_codes, canonical=True)
    ss0 = np.zeros((N_CHAINS, engine.n_sites), np.int64)
    for c in range(N_CHAINS):
        ss0[c, rng.choice(engine.n_sites, INC_CAN_ADS, replace=False)] = rng.integers(
            1, engine.n_codes, INC_CAN_ADS)
    ss0 = torch.as_tensor(ss0, device=dev)
    temps = geometric_schedule(1.0, INC_CAN_SWEEPS, 0.99)
    torch.cuda.synchronize()
    reset_launch_counts()
    states = incremental_chain_states(engine, d, N_CHAINS, ss0)
    res_a = irun(states, temps, _gen(0))
    torch.cuda.synchronize()
    launches = launch_counts()
    n_mc = INC_CAN_SWEEPS * SWEEP_SIZE
    L = len(states.caches.s)
    want = dict(INC_INIT_LAUNCHES)
    want["painn_message_subset"] = L * n_mc
    want["painn_update_fused"] += L * n_mc
    _expect("inc-canonical", launches, want)
    fin, rec = res_a
    n0 = (ss0 > 0).sum(1)
    kept = bool((rec.n_ads == n0[:, None]).all())
    drift = float((engine.energy_full(fin.site_state)[0] - fin.energy).abs().max())
    same = _bitwise(res_a, irun(states, temps, _gen(0)))
    dt = _best_of(lambda seed: irun(states, temps, _gen(seed)))
    print(f"[inc-canonical] 2x2 delta-engine canonical chains={N_CHAINS} ({INC_CAN_ADS} adsorbates "
          f"a chain) sweeps={INC_CAN_SWEEPS}x{SWEEP_SIZE} steps/s={N_CHAINS * n_mc / dt:.1f} step_ms={1e3 * dt / n_mc:.3f} "
          f"accept={float(rec.accept_rate.mean()):.4f}; n_ads constant: {kept}; cached vs fresh "
          f"{drift:.3e} eV (tol 1e-3); bitwise repeat {same}; launches={json.dumps(launches)}")
    if not (kept and drift <= 1e-3 and same):
        raise AssertionError("[inc-canonical] n_ads changed, caches drift or no repeat")
    return launches


@contextlib.contextmanager
def linesearch_steps():
    """Record every L-BFGS line search's iterations per chain (only the
    chains it ran for) while the block runs."""
    from surface_sampling_tpu_torch.core import relax as core_relax

    steps, zoom = [], core_relax.zoom_linesearch

    def recorded(value_and_grad, params, updates, value, grad, running):
        res = zoom(value_and_grad, params, updates, value, grad, running)
        steps.append(res[3][running])
        return res

    core_relax.zoom_linesearch = recorded
    try:
        yield steps
    finally:
        core_relax.zoom_linesearch = zoom


def _relaxed_from(sys_, ss, noise: float):
    """The relaxation of occupancy ``ss`` from its ideal geometry with the
    free atoms moved by ``noise`` A (seeded normal draws): (positions,
    potential energy)."""
    from surface_sampling_tpu_torch.core.energy import relax_and_score, relax_settings
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_free_mask,
        realize_positions,
        realize_type_idx,
    )

    d, pot, relax = sys_.run.d, sys_.potential, sys_.run.relax
    pos0, free = realize_positions(d, ss), realize_free_mask(d, ss)
    gen = torch.Generator(device=pos0.device).manual_seed(14)
    pos0 = pos0 + noise * torch.randn(pos0.shape, generator=gen, device=pos0.device) \
        * free[..., None]
    fire_cfg, fixed = relax_settings(relax, pot)
    bound = torch.full((ss.shape[0],), 1e4, device=pos0.device)
    pos, e, _ = relax_and_score(pot, relax.method, fire_cfg, fixed, pos0, free,
                                realize_type_idx(d, ss), realize_alive(d, ss), bound)
    return pos, e


def lbfgs_phase(dev) -> dict:
    """39. The flagship 1x1 with RelaxConfig(method="lbfgs"): the relaxed
    pristine surface energy; one relaxed state card vs CPU (RELAXED_E_TOL;
    positions within LBFGS_POS_TOL, beside the card's own response to a
    1e-6 A perturbation of the start); relaxed MC, LBFGS_CHAINS x 1 x
    LBFGS_STEPS: force calls and line-search steps a move, rows 2 / 4 once
    per layer and force call, a bitwise repeat. Returns the launch counts."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import EngineConfig, make_run_fn
    from surface_sampling_tpu_torch.parallel.chains import relaxed_chain_states
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    relax = RelaxConfig(method="lbfgs")
    sys_l = srtio3_001_painn(relax=relax, device=dev)
    run, pot, S = sys_l.run, sys_l.potential, sys_l.spec.n_sites
    t0 = time.perf_counter()
    e0 = run.state_energy_fn(torch.zeros((1, S), dtype=torch.int64, device=dev))
    t_pristine = time.perf_counter() - t0
    se = float(e0.surface_energy[0])
    ss = torch.as_tensor(np.where(np.arange(S) == 3, 3, 0)[None], device=dev)
    gpu = run.state_energy_fn(ss)
    t0 = time.perf_counter()
    cpu = srtio3_001_painn(relax=relax, device="cpu").run.state_energy_fn(ss.cpu())
    t_cpu = time.perf_counter() - t0
    de = float((gpu.surface_energy.cpu() - cpu.surface_energy).abs().max())
    dp = float((gpu.positions.cpu() - cpu.positions).abs().max())
    p_a, e_a = _relaxed_from(sys_l, ss, 0.0)
    p_b, e_b = _relaxed_from(sys_l, ss, 1e-6)
    print(f"[lbfgs-relax] pristine L-BFGS-relaxed surface {se:.6f} eV potential "
          f"{float(e0.potential_energy[0]):.6f} eV ({t_pristine:.2f}s); one adsorbed state card "
          f"vs cpu |dE| {de:.3e} eV (tol {RELAXED_E_TOL}) |dx| {dp:.3e} A (tol "
          f"{LBFGS_POS_TOL}) (cpu {t_cpu:.1f}s); the card's own response to a 1e-6 A "
          f"perturbation of the start: |dE| {float((e_a - e_b).abs().max()):.3e} eV |dx| "
          f"{float((p_a - p_b).abs().max()):.3e} A")
    if not (np.isfinite(se) and not bool(e0.oob[0]) and de <= RELAXED_E_TOL
            and dp <= LBFGS_POS_TOL):
        raise AssertionError("[lbfgs-relax] pristine or card-vs-cpu check failed")

    mrun = make_run_fn(run.d, run.state_energy_fn, EngineConfig(sweep_size=LBFGS_STEPS))
    states = relaxed_chain_states(run.d, run.state_energy_fn, LBFGS_CHAINS)
    temps = np.array([1.0])
    torch.cuda.synchronize()
    reset_launch_counts()
    with counting(pot) as (calls, _), linesearch_steps() as ls:
        t0 = time.perf_counter()
        res_a = mrun(states, temps, _gen(0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        run_calls = dict(calls)
        ls_steps = torch.cat(ls).float()
    _expect_relaxed(launches, run_calls, "painn_message_fused", "painn_message_bwd",
                    _n_layers(pot))
    same = _bitwise(res_a, mrun(states, temps, _gen(0)))
    rec = res_a[1]
    print(f"[lbfgs-relax] relaxed MC chains={LBFGS_CHAINS} sweeps=1x{LBFGS_STEPS} evals/s="
          f"{LBFGS_CHAINS * LBFGS_STEPS / dt:.2f} step_ms={1e3 * dt / LBFGS_STEPS:.3f} (one run) "
          f"force calls a move {run_calls['force'] / LBFGS_STEPS:.1f} (batched over the chains), "
          f"line-search steps an L-BFGS iteration mean {float(ls_steps.mean()):.3f} max "
          f"{int(ls_steps.max())}, L-BFGS iterations a move "
          f"{ls_steps.numel() / (LBFGS_CHAINS * LBFGS_STEPS):.2f} a chain; accept="
          f"{float(rec.accept_rate.mean()):.4f} best={float(rec.energy.min()):.6f} eV; bitwise "
          f"repeat {same}; launches={json.dumps(launches)}")
    if not (same and torch.isfinite(rec.energy).all()):
        raise AssertionError("[lbfgs-relax] the relaxed run does not repeat bitwise")
    return launches


def local_relax_canonical_phase(dev) -> dict:
    """39b. The local-relax canonical step on the FIRE-relaxed 1x1, N_CHAINS
    x LOCAL_CAN_STEPS from relaxed random occupancies of LOCAL_CAN_ADS
    adsorbates (one-hop balls around both exchanged sites): n_ads constant,
    carried energies vs a fresh evaluation (under the state energy's
    out-of-bounds clamp), a bitwise repeat, moves/s. Returns the launch
    counts."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.local_relax import (
        build_ball_masks,
        make_local_relax_canonical_step,
        make_local_relax_eval,
        make_local_relax_run,
    )
    from surface_sampling_tpu_torch.core.state import (
        element_counts,
        realize_alive,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.core.relax import energy_threshold
    from surface_sampling_tpu_torch.parallel.chains import relaxed_chain_states
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    sys_r = srtio3_001_painn(relax=RelaxConfig(), device=dev)
    run, pot, spec, d = sys_r.run, sys_r.potential, sys_r.spec, sys_r.run.d
    balls = build_ball_masks(spec, sys_r.static_nbr, hops=1)
    step = make_local_relax_canonical_step(
        make_local_relax_eval(d, pot, run.surface_energy_fn, run.relax, balls))
    lrun = make_local_relax_run(step, LOCAL_CAN_STEPS, spec.n_sites, spec.n_codes,
                                canonical=True)
    rng = np.random.default_rng(39)
    ss0 = np.zeros((N_CHAINS, spec.n_sites), np.int64)
    for c in range(N_CHAINS):
        ss0[c, rng.choice(spec.n_sites, LOCAL_CAN_ADS, replace=False)] = rng.integers(
            1, spec.n_codes, LOCAL_CAN_ADS)
    ss0 = torch.as_tensor(ss0, device=dev)
    states = relaxed_chain_states(d, run.state_energy_fn, N_CHAINS, ss0)
    temps = np.array([1.0])
    torch.cuda.synchronize()
    reset_launch_counts()
    with counting(pot) as (calls, n_steps):
        t0 = time.perf_counter()
        res_a = lrun(states, temps, _gen(0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        run_calls = dict(calls)
        iters = torch.stack(n_steps).float()
    _expect_relaxed(launches, run_calls, "painn_message_fused", "painn_message_bwd",
                    _n_layers(pot))
    fin, rec = res_a
    kept = bool((rec.n_ads == (ss0 > 0).sum(1)[:, None]).all())
    ss = fin.site_state
    e_fresh = pot.energy(fin.relaxed_positions, realize_type_idx(d, ss), realize_alive(d, ss))
    # the state energy's out-of-bounds rule: a clamped chain carries the bound
    bound = energy_threshold(spec.n_slots)
    se_fresh = torch.where((e_fresh.abs() > bound) | torch.isnan(e_fresh),
                           torch.full_like(e_fresh, bound),
                           run.surface_energy_fn(e_fresh, element_counts(d, ss)))
    drift = float((se_fresh - fin.energy).abs().max())
    n_oob = int((fin.energy == bound).sum())
    same = _bitwise(res_a, lrun(states, temps, _gen(0)))
    print(f"[local-relax-canonical] 1x1 chains={N_CHAINS} ({LOCAL_CAN_ADS} adsorbates a chain, "
          f"{n_oob} at the out-of-bounds clamp) steps={LOCAL_CAN_STEPS} moves/s="
          f"{N_CHAINS * LOCAL_CAN_STEPS / dt:.2f} step_ms={1e3 * dt / LOCAL_CAN_STEPS:.3f} (one "
          f"run) fire_iters_mean={float(iters.mean()):.3f} force_calls={run_calls['force']} "
          f"accept={float(rec.accept_rate.mean()):.4f}; n_ads constant: {kept}; carried vs "
          f"fresh {drift:.3e} eV (tol 1e-3); bitwise repeat {same}; "
          f"launches={json.dumps(launches)}")
    if not (kept and drift <= 1e-3 and same):
        raise AssertionError("[local-relax-canonical] n_ads, drift or repeat failed")
    return launches


def _mb_card_vs_cpu(tag, sys_gpu, sys_cpu, ss) -> float:
    e_gpu = sys_gpu.run.state_energy_fn(ss.to(sys_gpu.run.d.device)).potential_energy.cpu()
    e_cpu = sys_cpu.run.state_energy_fn(ss.cpu()).potential_energy
    diff = float((e_gpu - e_cpu).abs().max())
    if not diff <= MB_CARD_CPU_TOL:
        raise AssertionError(f"[{tag}] card and CPU energies differ by {diff} eV")
    return diff


def _mb_run(tag, sys_, n_chains, cfg, temps, site_state=None, repeat=True):
    """A whole run through MCMCRun.run (seed 0), its rate, finite energies
    and (``repeat``) a bitwise repeat. Returns the record."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_a = sys_.run.run(0, temps, site_state=site_state, cfg=cfg, n_chains=n_chains)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec = res_a[1]
    same = _bitwise(res_a, sys_.run.run(0, temps, site_state=site_state, cfg=cfg,
                                        n_chains=n_chains)) if repeat else None
    n_mc = len(temps) * cfg.sweep_size
    print(f"[{tag}] chains={n_chains} sweeps={len(temps)}x{cfg.sweep_size} evals/s="
          f"{n_chains * n_mc / dt:.1f} step_ms={1e3 * dt / n_mc:.3f} (one run) accept="
          f"{float(rec.accept_rate.mean()):.4f} n_ads={sorted(set(rec.n_ads.flatten().tolist()))}"
          f" best={float(rec.energy.min()):.6f} eV" + (f"; bitwise repeat {same}" if repeat
                                                        else ""))
    if not (torch.isfinite(rec.energy).all() and (same or not repeat)):
        raise AssertionError(f"[{tag}] non-finite energies or no bitwise repeat")
    return rec


def gan_phase(dev) -> None:
    """40. gan0001_tersoff() (3x3, 4 layers): the tutorial slab's pristine
    energy (systems_data/GaN_0001_3x3.npz, -144.059 eV) within 1e-3 in f32;
    card vs CPU on random states; canonical MC from an even prefill at
    GAN_CHAINS (exact) and GAN_FAST_CHAINS (fast=True), n_ads constant and a
    bitwise repeat; FIRE-relaxed canonical MC at GAN_RELAX_CHAINS."""
    from pathlib import Path

    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        even_site_prefill,
        geometric_schedule,
    )
    from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for
    from surface_sampling_tpu_torch.potentials.tersoff import builtin_tersoff, make_tersoff
    from surface_sampling_tpu_torch.systems import SYSTEMS_DATA, gan0001_tersoff

    t = builtin_tersoff("GaN_nord2003")
    data = np.load(Path(SYSTEMS_DATA) / "GaN_0001_3x3.npz")
    sym_of = {31: "Ga", 7: "N"}
    ti = torch.as_tensor([[t.elements.index(sym_of[int(z)]) for z in data["numbers"]]],
                         device=dev)
    frac = np.linalg.solve(data["cell"].T, data["positions"].T).T
    shifts = torch.as_tensor(pair_shifts_for(data["cell"], frac, t.cutoff), dtype=torch.float32,
                             device=dev)
    e_slab = float(make_tersoff(t, max_neighbors=24, device=dev).energy(
        torch.as_tensor(data["positions"], dtype=torch.float32, device=dev)[None], ti,
        torch.ones_like(ti, dtype=torch.bool), shifts)[0])
    t0 = time.perf_counter()
    exact, fast = gan0001_tersoff(device=dev), gan0001_tersoff(fast=True, device=dev)
    cpu = gan0001_tersoff(device="cpu")
    build_s = time.perf_counter() - t0
    spec = exact.spec
    ss = _states(spec, 16, np.random.default_rng(40), "cpu")
    diff = _mb_card_vs_cpu("gan", exact, cpu, ss)
    d_fast = float((fast.run.state_energy_fn(ss.to(dev)).potential_energy
                    - exact.run.state_energy_fn(ss.to(dev)).potential_energy).abs().max())
    print(f"[gan] tutorial slab (GaN_0001_3x3.npz, {len(data['numbers'])} atoms) {e_slab:.6f} eV "
          f"(LAMMPS {GAN_TUTORIAL_E}, |d| {abs(e_slab - GAN_TUTORIAL_E):.2e}, tol 1e-3); "
          f"gan0001_tersoff(): slots={spec.n_slots} sites={spec.n_sites} (host build of exact, "
          f"fast and cpu {build_s:.1f}s); 16 random states card vs cpu {diff:.3e} eV (tol "
          f"{MB_CARD_CPU_TOL}); fast vs exact {d_fast:.3e} eV")
    if not (abs(e_slab - GAN_TUTORIAL_E) <= 1e-3 and d_fast <= 5e-3):
        raise AssertionError("[gan] the tutorial anchor or fast vs exact failed")
    ss0 = even_site_prefill(spec, GAN_ADS, rng=np.random.default_rng(0))
    cfg = EngineConfig(sweep_size=SWEEP_SIZE, canonical=True, num_ads_atoms=GAN_ADS,
                       record_positions=False)
    temps = geometric_schedule(0.5, MB_SWEEPS, 0.9)
    for tag, sys_, n in (("gan-mc", exact, GAN_CHAINS), ("gan-mc-fast", fast, GAN_FAST_CHAINS)):
        rec = _mb_run(tag, sys_, n, cfg, temps, ss0)
        if not (rec.n_ads == GAN_ADS).all():
            raise AssertionError(f"[{tag}] n_ads changed")
    relaxed = gan0001_tersoff(relax=RelaxConfig(), device=dev)
    rcfg = EngineConfig(sweep_size=MB_RELAX_STEPS, canonical=True, num_ads_atoms=GAN_ADS)
    rec = _mb_run("gan-relax-mc", relaxed, GAN_RELAX_CHAINS, rcfg, np.array([0.5]), ss0,
                  repeat=False)
    if not (rec.n_ads == GAN_ADS).all():
        raise AssertionError("[gan-relax-mc] n_ads changed")


def _modified_sw():
    """tests/test_manybody_potentials.py's 'modified SW': SW85 with the
    three-body term strengthened 30%."""
    from surface_sampling_tpu_torch.potentials.sw import SW_SI_1985, sw_tables

    entry = dict(SW_SI_1985["entries"][("Si", "Si", "Si")])
    entry["lam"] *= 1.3
    return sw_tables({"elements": ("Si",), "entries": {("Si", "Si", "Si"): entry}})


def si_phase(dev) -> None:
    """41. si111_sw() (5x5, 2 bilayers, 100 atoms): the pristine SW85 energy
    (-379.42511 eV) by the exact and fast paths, fast vs exact and card vs
    CPU on random states; semigrand MC at SI_CHAINS (exact) and
    SI_FAST_CHAINS (fast=True); FIRE-relaxed MC at SI_RELAX_CHAINS under
    SW85 and with relax_model= the modified SW; on the JAX test's 2x2
    single-adsorbate states the split is live and relaxing under SW85
    itself scores no higher (its variational inequality)."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import EngineConfig, geometric_schedule
    from surface_sampling_tpu_torch.systems import si111_sw

    t0 = time.perf_counter()
    exact, fast, cpu = si111_sw(device=dev), si111_sw(fast=True, device=dev), si111_sw(
        device="cpu")
    build_s = time.perf_counter() - t0
    spec = exact.spec
    zero = torch.zeros((1, spec.n_sites), dtype=torch.int64, device=dev)
    e_ex = float(exact.run.state_energy_fn(zero).potential_energy[0])
    e_fa = float(fast.run.state_energy_fn(zero).potential_energy[0])
    rng = np.random.default_rng(41)
    ss = torch.as_tensor((rng.random((16, spec.n_sites)) < 0.05).astype(np.int64))
    diff = _mb_card_vs_cpu("si", exact, cpu, ss)
    d_fast = float((fast.run.state_energy_fn(ss.to(dev)).potential_energy
                    - exact.run.state_energy_fn(ss.to(dev)).potential_energy).abs().max())
    print(f"[si] si111_sw(): slots={spec.n_slots} sites={spec.n_sites} frozen="
          f"{int(spec.frozen_pristine.sum())} (host build {build_s:.1f}s); pristine SW85 exact "
          f"{e_ex:.6f} fast {e_fa:.6f} eV (pin {SI111_PRISTINE_E}, tol 5e-3); 16 random states "
          f"card vs cpu {diff:.3e} eV (tol {MB_CARD_CPU_TOL}), fast vs exact {d_fast:.3e} eV")
    if not (abs(e_ex - SI111_PRISTINE_E) <= 5e-3 and abs(e_fa - SI111_PRISTINE_E) <= 5e-3
            and d_fast <= 5e-3):
        raise AssertionError("[si] pristine pin or fast vs exact failed")
    cfg = EngineConfig(sweep_size=SWEEP_SIZE, record_positions=False)
    temps = geometric_schedule(1.0, MB_SWEEPS, 0.9)
    _mb_run("si-mc", exact, SI_CHAINS, cfg, temps)
    _mb_run("si-mc-fast", fast, SI_FAST_CHAINS, cfg, temps)
    sys_a = si111_sw(relax=RelaxConfig(), device=dev)
    sys_b = si111_sw(relax=RelaxConfig(), relax_model=_modified_sw(), device=dev)
    rcfg = EngineConfig(sweep_size=MB_RELAX_STEPS)
    _mb_run("si-relax-mc", sys_a, SI_RELAX_CHAINS, rcfg, np.array([1.0]), repeat=False)
    _mb_run("si-relax-mc-dual", sys_b, SI_RELAX_CHAINS, rcfg, np.array([1.0]), repeat=False)
    # the JAX test's check: the 2x2, 15 FIRE steps to fmax 0.02, one adsorbate
    relax = RelaxConfig(steps=15, fmax=0.02)
    sys_a = si111_sw(size=(2, 2), relax=relax, device=dev)
    sys_b = si111_sw(size=(2, 2), relax=relax, relax_model=_modified_sw(), device=dev)
    one = torch.zeros((2, sys_a.spec.n_sites), dtype=torch.int64, device=dev)
    one[0, 0], one[1, 3] = 1, 1
    out_a, out_b = sys_a.run.state_energy_fn(one), sys_b.run.state_energy_fn(one)
    gap = float((out_b.potential_energy - out_a.potential_energy).min())
    split = float((out_a.positions - out_b.positions).abs().max())
    print(f"[si-dual] 2x2, one adsorbate at site 0 / 3 (tests/test_manybody_potentials.py's "
          f"check): SW85 energy relaxed under the modified SW minus relaxed under SW85, least "
          f"{gap:.3e} eV (>= -1e-4); max position difference {split:.4f} A (split live)")
    if not (gap >= -1e-4 and split > 1e-5):
        raise AssertionError("[si-dual] the variational inequality or the split failed")


def symmetric_phase(dev) -> None:
    """42. A symmetric slab (tests/test_extras.py's shape: Cu(100) 2x2x2, one
    top site, the bottom layer the base) under make_eam(builtin_eam(
    "Cu_u3")), rigid and FIRE-relaxed, SYM_CHAINS random occupancies: card
    vs CPU (1e-4 eV rigid; RELAXED_E_TOL / RELAXED_POS_TOL relaxed, on
    SYM_CPU_CHAINS of them), the mirror live (energies differ from the plain
    slab's)."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig, SymmetricSlabConfig
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.spec import make_spec
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam, make_eam
    from surface_sampling_tpu_torch.structure import fcc100

    tables = builtin_eam("Cu_u3")
    slab = fcc100("Cu", size=(2, 2, 2), a=3.6, vacuum=20.0).sorted_by_z()
    sites = np.array([[0.0, 0.0, slab.positions[:, 2].max() + 1.8]])
    spec = make_spec(slab, sites, ["Cu"], potential_numbers=tables.numbers, cutoff=tables.cutoff)
    sym = SymmetricSlabConfig(base_z=float(slab.positions[:4, 2].mean()), n_base=4)

    def runs(device, relax=None):
        pot = make_eam(tables, device=device)
        return (MCMCRun(spec, pot, device=device, relax=relax, symmetric=sym),
                MCMCRun(spec, pot, device=device))

    ss = torch.as_tensor(np.random.default_rng(42).integers(0, 2, (SYM_CHAINS, 1)))
    (g_sym, g_plain), (c_sym, _) = runs(dev), runs("cpu")
    t0 = time.perf_counter()
    e_g = g_sym.state_energy_fn(ss.to(dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    e_c = c_sym.state_energy_fn(ss)
    d_rigid = float((e_g.surface_energy.cpu() - e_c.surface_energy).abs().max())
    mirror = float((g_plain.state_energy_fn(ss.to(dev)).potential_energy
                    - e_g.potential_energy).abs().min())
    (gr, _), (cr, _) = runs(dev, RelaxConfig()), runs("cpu", RelaxConfig())
    t0 = time.perf_counter()
    r_g = gr.state_energy_fn(ss.to(dev))
    torch.cuda.synchronize()
    dt_r = time.perf_counter() - t0
    r_c = cr.state_energy_fn(ss[:SYM_CPU_CHAINS])
    de = float((r_g.surface_energy[:SYM_CPU_CHAINS].cpu() - r_c.surface_energy).abs().max())
    dp = float((r_g.positions[:SYM_CPU_CHAINS].cpu() - r_c.positions).abs().max())
    moved = float((r_g.positions - e_g.positions).abs().max())
    print(f"[symmetric] Cu(100) 2x2x2 + 1 site mirrored (n_base 4, {spec.n_slots} + "
          f"{spec.n_slots - 4} slots) chains={SYM_CHAINS}: rigid card vs cpu {d_rigid:.3e} eV "
          f"(tol 1e-4), {SYM_CHAINS / dt:.1f} evals/s; mirror vs plain least |dE| {mirror:.3e} eV; "
          f"FIRE-relaxed card vs cpu ({SYM_CPU_CHAINS} chains) |dE| {de:.3e} eV (tol "
          f"{RELAXED_E_TOL}) |dx| {dp:.3e} A (tol {RELAXED_POS_TOL}), max relaxed displacement "
          f"{moved:.4f} A, {SYM_CHAINS / dt_r:.1f} evals/s")
    if not (d_rigid <= 1e-4 and mirror > 1e-3 and de <= RELAXED_E_TOL
            and dp <= RELAXED_POS_TOL and moved > 1e-3):
        raise AssertionError("[symmetric] card vs cpu or the mirror failed")


def slice14_phases(dev) -> dict:
    """Phases 36-42; returns the launch counts of the paths that run
    kernels."""
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    t0 = time.perf_counter()
    sys1 = srtio3_001_painn(device=dev)
    sys2 = srtio3_001_painn(supercell=(2, 2), device=dev)
    print(f"[engine-build] 1x1 and 2x2 rigid flagship systems {time.perf_counter() - t0:.1f}s")
    paths = criteria_phase(sys1, sys2, dev)
    paths.update(mtm_phase(sys1, dev))
    torch.cuda.empty_cache()
    paths["inc_canonical"] = inc_canonical_phase(sys2, dev)
    del sys1, sys2
    torch.cuda.empty_cache()
    paths["lbfgs_relax_mc"] = lbfgs_phase(dev)
    torch.cuda.empty_cache()
    paths["local_relax_canonical"] = local_relax_canonical_phase(dev)
    torch.cuda.empty_cache()
    gan_phase(dev)
    torch.cuda.empty_cache()
    si_phase(dev)
    torch.cuda.empty_cache()
    symmetric_phase(dev)
    return paths


# ----------------------------------------------------------------------
# Phases 43-46: the frozen-far-field relaxed engine, the dynamic-geometry delta,
# parallel tempering and population annealing
# ----------------------------------------------------------------------
# campaign C (campaigns/srtio3_2x2/settings_relaxed_ff.json): the relaxed 2x2,
# 20 FIRE steps to fmax 0.01, 16 chains, one-hop balls; chains start from
# FF_ADS adsorbates on sites at least FF_SITE_GAP A apart
FF_STEPS, FF_FMAX, FF_CHAINS, FF_SWEEPS, FF_CAN_STEPS = 20, 0.01, 16, 2, 4
FF_ADS, FF_SITE_GAP = 4, 2.5
FF_FULL_BALL_POS_TOL = 2e-3          # A, tests/test_ff_relax.py's full-ball rule
INC_DYN_SWEEPS = 2
# example 06 (Au(110), semigrand) and example 10 (Cu(100)), through row 13
TEMPER_REPLICAS, TEMPER_ROUNDS, TEMPER_SWEEP = 16, 30, 8
TEMPER_T_MIN, TEMPER_T_MAX = 0.02, 2.0
INC_TEMPER_REPLICAS, INC_TEMPER_ROUNDS = 16, 6
PA_CHAINS, PA_TEMPS, PA_BURN, PA_SWEEP, PA_THRESHOLD = 2048, 16, 10, 8, 0.9
PA_T_HI, PA_T_LO = 2.0, 0.35


def _spaced_states(spec, n_chains: int, n_ads: int, rng, device, gap: float = FF_SITE_GAP):
    """(n_chains, S) occupancies of n_ads random codes on random sites at
    least ``gap`` A apart (physical start states)."""
    xyz = spec.site_coords
    ss = np.zeros((n_chains, spec.n_sites), np.int64)
    for c in range(n_chains):
        picked = []
        for site in rng.permutation(spec.n_sites):
            if all(np.linalg.norm(xyz[site] - xyz[p]) >= gap for p in picked):
                picked.append(site)
            if len(picked) == n_ads:
                break
        ss[c, picked] = rng.integers(1, spec.n_codes, len(picked))
    return torch.as_tensor(ss, device=device)


@contextlib.contextmanager
def ff_fire_iters():
    """Record the per-chain FIRE iterations of every ball descent of the
    frozen-far-field engine while the block runs."""
    from surface_sampling_tpu_torch.core import ff_relax

    iters, fire = [], ff_relax.fire_relax

    def recorded(*a, **k):
        res = fire(*a, **k)
        iters.append(res.n_steps)
        return res

    ff_relax.fire_relax = recorded
    try:
        yield iters
    finally:
        ff_relax.fire_relax = fire


def _ff_lattice_move(sys_, tables, ss, site, code):
    """One FF evaluation from the lattice geometry of ``ss`` (caches from
    the acceptance pass there): ``site`` takes ``code``. Returns the
    StateEnergy and the trial occupancy."""
    from surface_sampling_tpu_torch.core.ff_relax import make_ff_relax_eval
    from surface_sampling_tpu_torch.core.state import change_site, realize_positions

    run, d = sys_.run, sys_.run.d
    ev = make_ff_relax_eval(d, sys_.potential, run.surface_energy_fn, run.relax, tables)
    pos = realize_positions(d, ss)
    _, caches = ev.finish(pos, ss)
    trial = change_site(ss, site, code)
    return ev.evaluate1(trial, pos, caches, site)[0], trial


def ff_relax_phase(dev) -> dict:
    """43. The frozen-far-field relaxed engine at campaign C's shape: the
    relaxed 2x2 (no band), RelaxConfig(steps=FF_STEPS, fmax=FF_FMAX), the
    candidate table of cutoff 5.0 with 0.6 A of slack, one-hop balls,
    FF_CHAINS chains from FF_ADS spaced adsorbates each. The init (a full
    relaxed evaluation, rows 2 and 4, then the acceptance pass, row 2);
    one evaluation: slots outside each ball unchanged; the semigrand run,
    FF_SWEEPS x SWEEP_SIZE, untimed then timed, bitwise equal, row 2 once per
    layer and move (the descent is plain PyTorch); carried energies vs a
    fresh acceptance pass; the canonical step, FF_CAN_STEPS (n_ads
    constant). At the 1x1: one move card vs CPU (RELAXED_E_TOL /
    RELAXED_POS_TOL) and the full-ball (hops 8) move against the full
    relaxed path. Returns the launch counts of the init and of the run."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import geometric_schedule
    from surface_sampling_tpu_torch.core.ff_relax import (
        build_ff_tables,
        make_ff_canonical_step,
        make_ff_init,
        make_ff_relax_eval,
        make_ff_run,
        make_ff_semigrand_step,
    )
    from surface_sampling_tpu_torch.core.state import change_site
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    relax = RelaxConfig(steps=FF_STEPS, fmax=FF_FMAX)
    t0 = time.perf_counter()
    sys2 = srtio3_001_painn(supercell=(2, 2), relax=relax, device=dev)
    tables = build_ff_tables(sys2.spec, sys2.static_nbr, hops=1)
    build_s = time.perf_counter() - t0
    run, pot, spec, d = sys2.run, sys2.potential, sys2.spec, sys2.run.d
    if sys2.potential.band is not None:
        raise AssertionError("[ff-relax] the relaxed 2x2 is expected to run unbanded")
    L = pot.cfg.n_layers
    ev = make_ff_relax_eval(d, pot, run.surface_energy_fn, relax, tables)
    rng = np.random.default_rng(43)
    ss0 = _spaced_states(spec, FF_CHAINS, FF_ADS, rng, dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    states = make_ff_init(d, ev, run.state_energy_fn)(ss0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = launch_counts()
    if not (init_launches["painn_message_fused"] > 0 and init_launches["painn_message_bwd"] > 0):
        raise AssertionError(f"[ff-relax] init launches {init_launches}")

    site = torch.as_tensor(rng.integers(0, spec.n_sites, FF_CHAINS), device=dev)
    trial = change_site(states.site_state, site, torch.ones_like(site))
    e, _ = ev.evaluate1(trial, states.relaxed_positions, (states.cache_s, states.cache_v), site)
    NB = tables.n_ball
    inside = np.zeros((FF_CHAINS, spec.n_slots), bool)
    for c, s_ in enumerate(site.tolist()):
        inside[c, tables.rows[s_][:NB][tables.row_valid[s_][:NB]]] = True
    outside = ~torch.as_tensor(inside, device=dev)
    kept = torch.equal(e.positions[outside], states.relaxed_positions[outside])
    moved = float((e.positions - states.relaxed_positions).abs().max())

    temps = geometric_schedule(1.0, FF_SWEEPS, 0.99)
    frun = make_ff_run(make_ff_semigrand_step(ev), SWEEP_SIZE, spec.n_sites, spec.n_codes,
                       record_positions=False)
    n_mc = FF_SWEEPS * SWEEP_SIZE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with ff_fire_iters() as iters:
        res_a = frun(states, temps, _gen(0))
        torch.cuda.synchronize()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    its = torch.stack(iters).float()                                     # (moves, C)
    _expect("ff-relax", launches, {"painn_message_fused": L * n_mc})
    t0 = time.perf_counter()
    res_b = frun(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same = _bitwise(res_a, res_b)
    fin, rec = res_a
    fresh, _ = ev.finish(fin.relaxed_positions, fin.site_state)
    drift = float((fresh.surface_energy - fin.energy).abs().max())
    print(f"[ff-relax] 2x2 relaxed slots={spec.n_slots} sites={spec.n_sites} ball {NB} rows of "
          f"a {tables.n_sub}-row subproblem (ball_frac {tables.ball_frac:.3f}) build_s="
          f"{build_s:.1f} chains={FF_CHAINS} init {init_s:.2f}s launches="
          f"{json.dumps(init_launches)}; one evaluation: outside-ball slots unchanged: {kept} "
          f"(inside moved up to {moved:.4f} A)")
    print(f"[ff-relax] semigrand sweeps={FF_SWEEPS}x{SWEEP_SIZE} moves/s={FF_CHAINS * n_mc / dt:.2f} "
          f"step_ms={1e3 * dt / n_mc:.3f} (timed run after an untimed one) FIRE iterations of a "
          f"ball mean {float(its.mean()):.2f} max {int(its.max())} (the batch waits on a move's "
          f"slowest ball: mean of the per-move max {float(its.amax(dim=1).mean()):.2f}); accept="
          f"{float(rec.accept_rate.mean()):.4f} best={float(rec.energy.min()):.6f} eV; carried "
          f"vs a fresh acceptance pass max |diff| {drift:.3e} eV (tol 1e-3); bitwise repeat "
          f"{same}; peak_mem={peak_gb:.3f} GB launches={json.dumps(launches)}")
    if not (kept and moved > 0 and same and drift <= 1e-3 and torch.isfinite(rec.energy).all()):
        raise AssertionError("[ff-relax] locality, repeat or carried-energy check failed")

    crun = make_ff_run(make_ff_canonical_step(ev), FF_CAN_STEPS, spec.n_sites, spec.n_codes,
                       canonical=True, record_positions=False)
    t0 = time.perf_counter()
    cfin, crec = crun(states, np.array([1.0]), _gen(1))
    torch.cuda.synchronize()
    dt_c = time.perf_counter() - t0
    n0 = (ss0 > 0).sum(1)
    n_kept = bool((crec.n_ads == n0[:, None]).all())
    cfresh, _ = ev.finish(cfin.relaxed_positions, cfin.site_state)
    cdrift = float((cfresh.surface_energy - cfin.energy).abs().max())
    print(f"[ff-relax] canonical steps={FF_CAN_STEPS} (two ball descents a move) moves/s="
          f"{FF_CHAINS * FF_CAN_STEPS / dt_c:.2f} (one run) accept="
          f"{float(crec.accept_rate.mean()):.4f}; n_ads constant: {n_kept}; carried vs fresh "
          f"{cdrift:.3e} eV")
    if not (n_kept and cdrift <= 1e-3):
        raise AssertionError("[ff-relax] the canonical run changed n_ads or drifts")
    del sys2, ev, states, res_a, res_b
    torch.cuda.empty_cache()

    sys1 = srtio3_001_painn(relax=relax, device=dev)
    sys1c = srtio3_001_painn(relax=relax, device="cpu")
    S1 = sys1.spec.n_sites
    ss = torch.zeros((1, S1), dtype=torch.int64)
    ss[0, 3] = 3
    site, code = torch.tensor([7]), torch.tensor([1])
    t1 = build_ff_tables(sys1.spec, sys1.static_nbr, hops=1)
    eg, _ = _ff_lattice_move(sys1, t1, ss.to(dev), site.to(dev), code.to(dev))
    t0 = time.perf_counter()
    ec, _ = _ff_lattice_move(sys1c, t1, ss, site, code)
    t_cpu = time.perf_counter() - t0
    de = float((eg.surface_energy.cpu() - ec.surface_energy).abs().max())
    dx = float((eg.positions.cpu() - ec.positions).abs().max())
    t8 = build_ff_tables(sys1.spec, sys1.static_nbr, hops=8)
    pristine = torch.zeros((1, S1), dtype=torch.int64, device=dev)
    ef, trial = _ff_lattice_move(sys1, t8, pristine, site.to(dev), code.to(dev))
    full = sys1.run.state_energy_fn(trial)
    fde = float((ef.surface_energy - full.surface_energy).abs().max())
    fdx = float((ef.positions - full.positions).abs().max())
    print(f"[ff-relax] 1x1 one-hop ball {t1.n_ball} of {sys1.spec.n_slots} rows: one move card vs "
          f"cpu |dE| {de:.3e} eV (tol {RELAXED_E_TOL}) |dx| {dx:.3e} A (tol {RELAXED_POS_TOL}) "
          f"(cpu {t_cpu:.1f}s); full ball (hops 8, ball_frac {t8.ball_frac:.3f}) vs the full "
          f"relaxed path |dE| {fde:.3e} eV (tol {RELAXED_E_TOL}) |dx| {fdx:.3e} A (tol "
          f"{FF_FULL_BALL_POS_TOL})")
    if not (de <= RELAXED_E_TOL and dx <= RELAXED_POS_TOL and t8.ball_frac == 1.0
            and fde <= RELAXED_E_TOL and fdx <= FF_FULL_BALL_POS_TOL):
        raise AssertionError("[ff-relax] 1x1 card-vs-cpu or full-ball check failed")
    return {"ff_init": init_launches, "ff_relax": launches}


def inc_dynamic_phase(sys2, dev) -> dict:
    """44. The 2x2 delta engine with static_geometry="off" (edges rebuilt over
    the candidate table every step): crowded one- and two-site deltas
    bitwise a fresh evaluation; N_CHAINS x INC_DYN_SWEEPS x SWEEP_SIZE, rows
    7 / 3 for the initial evaluation and rows 8 / 3 per layer and step,
    cached energies bitwise fresh ones, a bitwise repeat; steps/s beside the
    static-geometry delta's from the same states and seeds. Returns the
    launch counts."""
    from surface_sampling_tpu_torch.core.engine import geometric_schedule
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_painn,
        make_incremental_painn_from_system,
        make_incremental_run,
        make_incremental_semigrand_step,
    )
    from surface_sampling_tpu_torch.parallel.chains import incremental_chain_states

    run, spec, d = sys2.run, sys2.spec, sys2.run.d
    engine = make_incremental_painn(spec, d, sys2.potential, sys2.static_nbr, sys2.routing_band,
                                    run.surface_energy_fn, static_geometry="off")
    crowded = _delta_vs_fresh(engine, _states(spec, N_CHAINS, np.random.default_rng(44), dev),
                              _gen(0), "inc-dynamic")
    print(f"[inc-dynamic] crowded 2x2 occupancies, one move: {crowded}")
    temps = geometric_schedule(1.0, INC_DYN_SWEEPS, 0.99)
    n_mc = INC_DYN_SWEEPS * SWEEP_SIZE
    irun = make_incremental_run(make_incremental_semigrand_step(engine), SWEEP_SIZE,
                                engine.n_sites, engine.n_codes)
    torch.cuda.synchronize()
    reset_launch_counts()
    states = incremental_chain_states(engine, d, N_CHAINS)
    res_a = irun(states, temps, _gen(0))
    torch.cuda.synchronize()
    launches = launch_counts()
    L = len(states.caches.s)
    want = dict(INC_INIT_LAUNCHES)
    want["painn_message_subset"] = L * n_mc
    want["painn_update_fused"] += L * n_mc
    _expect("inc-dynamic", launches, want)
    fin, rec = res_a
    drift = float((engine.energy_full(fin.site_state)[0] - fin.energy).abs().max())
    same = _bitwise(res_a, irun(states, temps, _gen(0)))
    dt = _best_of(lambda seed: irun(states, temps, _gen(seed)))
    static = make_incremental_painn_from_system(sys2)
    srun = make_incremental_run(make_incremental_semigrand_step(static), SWEEP_SIZE,
                                static.n_sites, static.n_codes)
    sstates = incremental_chain_states(static, d, N_CHAINS)
    s_out = srun(sstates, temps, _gen(0))[0]
    dt_s = _best_of(lambda seed: srun(sstates, temps, _gen(seed)))
    print(f"[inc-dynamic] 2x2 dynamic-geometry delta chains={N_CHAINS} sweeps={INC_DYN_SWEEPS}x"
          f"{SWEEP_SIZE} steps/s={N_CHAINS * n_mc / dt:.1f} step_ms={1e3 * dt / n_mc:.3f} vs the "
          f"static-geometry delta steps/s={N_CHAINS * n_mc / dt_s:.1f} step_ms="
          f"{1e3 * dt_s / n_mc:.3f} (best of 3 each); same site states as the static run: "
          f"{torch.equal(fin.site_state, s_out.site_state)}; accept="
          f"{float(rec.accept_rate.mean()):.4f}; cached vs fresh max |diff| {drift:.3e} eV "
          f"(bitwise: {drift == 0.0}); bitwise repeat {same}; launches={json.dumps(launches)}")
    if not (drift == 0.0 and same and torch.isfinite(rec.energy).all()):
        raise AssertionError("[inc-dynamic] caches drift or the run does not repeat")
    return launches


@contextlib.contextmanager
def swap_multisets():
    """Record, for every swap phase of a tempered run while the block runs,
    whether it kept the multiset of energies (bitwise)."""
    from surface_sampling_tpu_torch.parallel import tempering

    kept, swap = [], tempering.swap_phase

    def checked(states, *a, **k):
        out, rate = swap(states, *a, **k)
        kept.append(torch.equal(torch.sort(out.energy).values, torch.sort(states.energy).values))
        return out, rate

    tempering.swap_phase = checked
    try:
        yield kept
    finally:
        tempering.swap_phase = swap


def _eam_kernel_run(system: str, dev):
    """MCMCRun of Cu(100) or Au(110) through the EAM kernel potential (row
    13; static tables at 0.05 A of slack)."""
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam
    from surface_sampling_tpu_torch.systems import au110_eam, cu100_eam

    tables = builtin_eam("Au_u3" if system == "au" else "Cu_u3")
    spec = (au110_eam if system == "au" else cu100_eam)(device=dev).spec
    nbr = build_static_neighbor_table(spec, tables.cutoff, relax_slack=0.05)
    return MCMCRun(spec, make_eam_kernel_potential(tables, nbr, device=dev), device=dev)


def temper_phase(dev) -> dict:
    """45. Example 06's shape: semigrand Au(110) through row 13,
    TEMPER_REPLICAS replicas on the ladder TEMPER_T_MIN-TEMPER_T_MAX,
    TEMPER_ROUNDS rounds of one TEMPER_SWEEP-step sweep: swap rates in [0, 1],
    every swap phase keeping the energy multiset, row 13 once per state
    evaluation, a bitwise repeat. Returns the launch counts."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, make_run_fn
    from surface_sampling_tpu_torch.parallel import (
        chain_states,
        make_tempered_run,
        temperature_ladder,
    )

    krun = _eam_kernel_run("au", dev)
    d, sef = krun.d, krun.state_energy_fn
    run_fn = make_run_fn(d, sef, EngineConfig(sweep_size=TEMPER_SWEEP, record_positions=False))
    temps = temperature_ladder(TEMPER_T_MIN, TEMPER_T_MAX, TEMPER_REPLICAS)
    trun = make_tempered_run(run_fn, TEMPER_ROUNDS)
    st = chain_states(d, TEMPER_REPLICAS)
    torch.cuda.synchronize()
    reset_launch_counts()
    st = st._replace(energy=sef(st.site_state).surface_energy)
    with swap_multisets() as kept:
        t0 = time.perf_counter()
        res_a = trun(st, temps, _gen(0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = launch_counts()
    n_evals = 1 + TEMPER_ROUNDS * TEMPER_SWEEP
    _expect("temper", launches, {"eam_rho_ep": n_evals})
    same = _bitwise(res_a, trun(st, temps, _gen(0)))
    rec = res_a[1]
    rates = rec.swap_rate
    ok_rates = bool(((rates >= 0) & (rates <= 1)).all())
    print(f"[temper] Au(110) kernel potential, {TEMPER_REPLICAS} replicas ladder {TEMPER_T_MAX}-"
          f"{TEMPER_T_MIN}, {TEMPER_ROUNDS} rounds x {TEMPER_SWEEP} steps: "
          f"{TEMPER_REPLICAS * (n_evals - 1) / dt:.1f} evals/s (one run, {dt:.3f} s); swap rate "
          f"mean {float(rates.mean()):.4f} min {float(rates.min()):.4f} max "
          f"{float(rates.max()):.4f} (in [0, 1]: {ok_rates}); every swap phase kept the energy "
          f"multiset: {all(kept)} ({len(kept)} phases); cold replica best "
          f"{float(rec.energy[:, -1].min()):.6f} eV, global best {float(rec.energy.min()):.6f} "
          f"eV; bitwise repeat {same}; launches={json.dumps(launches)}")
    if not (ok_rates and all(kept) and len(kept) == TEMPER_ROUNDS and same
            and torch.isfinite(rec.energy).all()):
        raise AssertionError("[temper] swap rates, multisets or the repeat failed")
    return launches


def inc_temper_phase(sys2, dev) -> dict:
    """45b. The 2x2 delta engine under tempering, INC_TEMPER_REPLICAS
    replicas x INC_TEMPER_ROUNDS rounds of one SWEEP_SIZE sweep: the caches
    travel with their states (cached energies bitwise a fresh evaluation
    after the run), rows 7 / 3 for the initial evaluation, rows 8 / 3 per
    layer and step. Returns the launch counts."""
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_painn_from_system,
        make_incremental_run,
        make_incremental_semigrand_step,
    )
    from surface_sampling_tpu_torch.parallel import (
        incremental_chain_states,
        make_tempered_run,
        temperature_ladder,
    )

    engine = make_incremental_painn_from_system(sys2)
    irun = make_incremental_run(make_incremental_semigrand_step(engine), SWEEP_SIZE,
                                engine.n_sites, engine.n_codes)
    temps = temperature_ladder(TEMPER_T_MIN, TEMPER_T_MAX, INC_TEMPER_REPLICAS)
    trun = make_tempered_run(irun, INC_TEMPER_ROUNDS)
    torch.cuda.synchronize()
    reset_launch_counts()
    st = incremental_chain_states(engine, sys2.run.d, INC_TEMPER_REPLICAS)
    t0 = time.perf_counter()
    fin, rec = trun(st, temps, _gen(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    n_mc = INC_TEMPER_ROUNDS * SWEEP_SIZE
    L = len(st.caches.s)
    want = dict(INC_INIT_LAUNCHES)
    want["painn_message_subset"] = L * n_mc
    want["painn_update_fused"] += L * n_mc
    _expect("inc-temper", launches, want)
    drift = float((engine.energy_full(fin.site_state)[0] - fin.energy).abs().max())
    print(f"[inc-temper] 2x2 delta engine, {INC_TEMPER_REPLICAS} replicas x {INC_TEMPER_ROUNDS} "
          f"rounds x {SWEEP_SIZE} steps: {INC_TEMPER_REPLICAS * n_mc / dt:.1f} steps/s (one run); "
          f"swap rate mean {float(rec.swap_rate.mean()):.4f}; cached vs fresh after the run max "
          f"|diff| {drift:.3e} eV (bitwise: {drift == 0.0}); launches={json.dumps(launches)}")
    if not (drift == 0.0 and bool(((rec.swap_rate >= 0) & (rec.swap_rate <= 1)).all())
            and float(rec.swap_rate.max()) > 0):
        raise AssertionError("[inc-temper] the caches did not travel with their states")
    return launches


def pa_phase(dev) -> dict:
    """46. Example 10's shape: Cu(100) through row 13, PA_CHAINS chains,
    PA_BURN burn-in sweeps at PA_T_HI, then PA_TEMPS temperatures from PA_T_HI
    to PA_T_LO (sweeps of PA_SWEEP), resampling below ESS / C = PA_THRESHOLD:
    ESS / C, the resampled steps, sum dlogZ, row 13 once per state
    evaluation, a bitwise repeat. Returns the launch counts."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, make_run_fn
    from surface_sampling_tpu_torch.parallel import chain_states, make_population_annealing_run

    krun = _eam_kernel_run("cu", dev)
    d, sef = krun.d, krun.state_energy_fn
    run_fn = make_run_fn(d, sef, EngineConfig(sweep_size=PA_SWEEP, record_positions=False))
    temps = np.geomspace(PA_T_HI, PA_T_LO, PA_TEMPS)
    parun = make_population_annealing_run(run_fn, resample_threshold=PA_THRESHOLD)

    def once(seed):
        gen = _gen(seed)
        st = chain_states(d, PA_CHAINS)
        st = st._replace(energy=sef(st.site_state).surface_energy)
        st, _ = run_fn(st, np.full(PA_BURN, PA_T_HI), gen)
        return parun(st, temps, gen)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res_a = once(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    n_evals = 1 + (PA_BURN + PA_TEMPS) * PA_SWEEP
    _expect("pa", launches, {"eam_rho_ep": n_evals})
    same = _bitwise(res_a, once(0))
    rec = res_a[1]
    print(f"[pa] Cu(100) kernel potential, {PA_CHAINS} chains, {PA_BURN} burn-in sweeps at "
          f"{PA_T_HI}, {PA_TEMPS} temperatures {PA_T_HI} -> {PA_T_LO} x {PA_SWEEP} steps, "
          f"threshold {PA_THRESHOLD}: {PA_CHAINS * (n_evals - 1) / dt:.1f} evals/s (one run, "
          f"{dt:.3f} s, the burn-in included); min ESS/C {float(rec.ess.min()) / PA_CHAINS:.4f}; "
          f"{int(rec.resampled.sum())}/{PA_TEMPS} steps resampled; sum dlogZ "
          f"{float(rec.dlogz.sum()):.6f}; best {float(rec.energy.min()):.6f} eV (final mean "
          f"{float(rec.energy[-1].mean()):.6f}); bitwise repeat {same}; "
          f"launches={json.dumps(launches)}")
    if not (same and torch.isfinite(rec.energy).all() and torch.isfinite(rec.dlogz).all()):
        raise AssertionError("[pa] non-finite results or the run does not repeat")
    return launches


def slice15_phases(dev) -> dict:
    """Phases 43-46; returns the launch counts of their paths."""
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    paths = ff_relax_phase(dev)
    torch.cuda.empty_cache()
    sys2 = srtio3_001_painn(supercell=(2, 2), device=dev)
    paths["inc_dynamic"] = inc_dynamic_phase(sys2, dev)
    torch.cuda.empty_cache()
    paths["temper"] = temper_phase(dev)
    paths["inc_temper"] = inc_temper_phase(sys2, dev)
    del sys2
    torch.cuda.empty_cache()
    paths["pa"] = pa_phase(dev)
    return paths


# ----------------------------------------------------------------------
# Sharding on torch.distributed, the image-search edge path of PaiNN and
# CHGNet, and MACE
# ----------------------------------------------------------------------
# [shard]: one rank a card, at most 4 (NCCL refuses two ranks on one card);
# the flagship rigid 1x1 at N_CHAINS x SWEEPS x SWEEP_SIZE, Cu(100) through
# row 13 at [cu-mc]'s 16,384 chains (2 x 8 steps), one data-parallel and one
# ensemble-sharded train step on [train]'s 16 frames. Sharded results are
# bitwise the unsharded ones at world 1; beyond, the blocks' batched sums
# may round otherwise: occupancies equal, energies, losses and gradients
# within 1e-5 relative
SHARD_MAX_WORLD = 4
SHARD_CU_CHAINS = 16_384
SHARD_RTOL = 1e-5
# [image-edges]: relaxed MC at the flagship's chain count, 1 x 4 steps; the
# JAX package's rule for its two edge modes; CHGNet rigid at path A's chain
# count, relaxed at path B's with its 10 FIRE steps
MODE_TOL = 5e-3
IMAGE_CPU_STATES = 4
# [mace]: the default width (F 64, 8 RBFs, cutoff 5, 2 layers, M 64) on
# the flagship 1x1; l_max 2 and 3, each with the layer-local and the
# equivariant messages, the JAX package's two routing modes alternating
# (both compute the gather); rigid MC at N_CHAINS x SWEEPS x SWEEP_SIZE,
# relaxed at 16 chains x 1 x 4 steps of 20 FIRE steps over the relax table
MACE_CONFIGS = ((2, False, "gather"), (2, True, "dense"), (3, False, "dense"), (3, True, "gather"))
MACE_RELAX_CHAINS = 16
MACE_ROT_TOL = 1e-4
# the random model's forces are ~0.01-0.02 eV/A, under FIRE's default fmax
# of 0.01: a tighter fmax makes every relaxation run its 20 steps
MACE_FMAX = 1e-4


def _shard_compare(tag: str, ref, got, world: int) -> str:
    """Occupancies equal and energies (states and records) bitwise at world
    1, within SHARD_RTOL beyond; a description of the agreement."""
    pairs = [(ref[0].site_state, got[0].site_state, True), (ref[0].energy, got[0].energy, False),
             (ref[1].energy, got[1].energy, False), (ref[1].site_state, got[1].site_state, True)]
    worst = 0.0
    for a, b, exact in pairs:
        if exact or world == 1:
            if not torch.equal(a, b):
                raise AssertionError(f"[shard] {tag}: the sharded run differs from the unsharded "
                                     f"one at world {world}")
        else:
            worst = max(worst, float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
    if worst > SHARD_RTOL:
        raise AssertionError(f"[shard] {tag}: energies off by {worst:.3e} relative")
    return "bitwise" if world == 1 else f"occupancies equal, energies within {worst:.2e} rel"


def _timed_world(fn, reps: int = 3) -> float:
    """Least wall seconds of ``fn(seed)`` over the ranks, every rank starting
    together (barriers) and ending in a synchronize."""
    import torch.distributed as dist

    dt = float("inf")
    for rep in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn(rep + 1)
        torch.cuda.synchronize()
        dist.barrier()
        dt = min(dt, time.perf_counter() - t0)
    return dt


def _shard_rank(rank: int, workdir: str, smi: str) -> None:
    """47. One rank of the [shard] world (one card each): the sharded and
    hierarchical flagship runs, the sharded Cu(100) run, the sharded
    ensemble energy and the two sharded train steps, each against its
    unsharded counterpart; rank 0 writes its lines, rates and launch
    counts to ``workdir/shard.json``."""
    from pathlib import Path

    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        geometric_schedule,
        make_generator,
        make_run_fn,
    )
    from surface_sampling_tpu_torch.models.ensemble import ensemble_apply
    from surface_sampling_tpu_torch.models.painn import tree_leaves
    from surface_sampling_tpu_torch.models.train import TrainConfig, Trainer, batch_to_device
    from surface_sampling_tpu_torch.parallel import (
        chain_mesh,
        chain_states,
        gather_chain_states,
        make_ensemble_sharded_energy,
        make_ensemble_sharded_train_step,
        make_hierarchical_chain_run,
        make_sharded_chain_run,
        make_sharded_train_step,
        pod_mesh,
        shard_chain_states,
    )
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    mesh = chain_mesh()
    dev, world = mesh.device, mesh.axis_size("chains")
    pods = pod_mesh(1, world)
    # the 3 members split over the ranks of a mesh whose size divides 3
    ens_mesh = chain_mesh(3 if world >= 3 else 1, axis="ensemble")
    lines, rates, paths = [], {}, {}

    def runs(tag, run_fn, states, sweeps, n_chains):
        temps = geometric_schedule(1.0, sweeps, 0.99)
        ref = run_fn(states, temps, make_generator(0, dev))
        srun = make_sharded_chain_run(run_fn, mesh)
        local = shard_chain_states(states, mesh)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = srun(local, temps, make_generator(0, dev))
        torch.cuda.synchronize()
        paths[tag] = launch_counts()
        flat = _shard_compare(tag, ref, gather_chain_states(got, mesh), world)
        hrun = make_hierarchical_chain_run(run_fn, pods)
        axes = ("pod", "chains")
        hier = gather_chain_states(hrun(shard_chain_states(states, pods, axes), temps,
                                        make_generator(0, dev)), pods, axes)
        deep = _shard_compare(f"{tag} hierarchical", ref, hier, world)
        dt = _timed_world(lambda seed: srun(local, temps, make_generator(seed, dev)))
        rates[tag] = n_chains * sweeps * SWEEP_SIZE / dt
        lines.append(f"[shard] {tag}: {n_chains} chains x {sweeps}x{SWEEP_SIZE} over "
                     f"{world} rank(s): sharded vs unsharded {flat}; pod_mesh(1, {world}) "
                     f"hierarchical {deep}; {rates[tag]:.1f} evals/s ({smi})")

    sys1 = srtio3_001_painn(device=dev)
    d, sef = sys1.run.d, sys1.run.state_energy_fn
    cfg = EngineConfig(sweep_size=SWEEP_SIZE, record_positions=False)
    states = chain_states(d, N_CHAINS)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    runs("shard_mc", make_run_fn(d, sef, cfg), states, SWEEPS, N_CHAINS)

    # the sharded ensemble energy over the members, against one ensemble_apply
    pot = sys1.potential
    ss = _states(sys1.spec, 8, np.random.default_rng(3), dev)
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )

    alive = realize_alive(d, ss)
    numbers = pot.znums[realize_type_idx(d, ss)] * alive
    edges = pot.edges(realize_positions(d, ss), alive)
    want = ensemble_apply(pot.params, pot.cfg, numbers, alive, edges)["member_energy"].T
    if ens_mesh.coords is not None:
        mean, members = make_ensemble_sharded_energy(
            lambda p, n, a, e: ensemble_apply(p, pot.cfg, n, a, e)["member_energy"].T,
            ens_mesh)(pot.params, numbers, alive, edges)
        err = float(((members - want).abs() / want.abs()).max())
        lines.append(f"[shard] ensemble energy over {ens_mesh.axis_size('ensemble')} rank(s), "
                     f"3 members x 8 states: max rel diff from ensemble_apply {err:.3e} "
                     f"(tol {SHARD_RTOL})")
        if not (err <= SHARD_RTOL and torch.allclose(mean, want.mean(0), rtol=SHARD_RTOL)):
            raise AssertionError(f"[shard] ensemble energy off by {err}")
    del sys1
    torch.cuda.empty_cache()

    cu = _eam_kernel_run("cu", dev)
    cu_states = chain_states(cu.d, SHARD_CU_CHAINS)
    cu_states = cu_states._replace(energy=cu.state_energy_fn(cu_states.site_state).surface_energy)
    runs("shard_cu_mc", make_run_fn(cu.d, cu.state_energy_fn, cfg), cu_states, 2,
         SHARD_CU_CHAINS)
    del cu, cu_states
    torch.cuda.empty_cache()

    # one data-parallel and one ensemble-sharded step against Trainer.step
    params, tcfg_model, _, _, batch = train_setup(dev)
    b = batch_to_device(batch, dev)
    tcfg = TrainConfig(learning_rate=TRAIN_LR)
    ref = Trainer(params, tcfg_model, tcfg, ensemble=True)
    ref_loss = ref.step(b)
    ref_leaves = tree_leaves(ref.params())

    def agree(tag, leaves, mu, loss):
        """Bitwise the reference step at world 1. Beyond, Adam's first step
        moves each parameter by ~lr x sign(g), which turns last-bit
        differences of near-zero gradients into lr-sized ones: there the
        clipped mean gradients (Adam's first moment / (1 - b1)) and the loss
        are held to SHARD_RTOL instead."""
        def rel(xs, ys):
            return max(float(((x - y).abs() / y.abs().max().clamp(min=1e-30)).max())
                       for x, y in zip(xs, ys))

        same = all(torch.equal(a, r) for a, r in zip(leaves, ref_leaves)) and loss == ref_loss
        worst, d_params = rel(mu, ref.state.mu), rel(leaves, ref_leaves)
        d_loss = abs(loss - ref_loss) / abs(ref_loss)
        if (world == 1 and not same) or worst > SHARD_RTOL or d_loss > SHARD_RTOL:
            raise AssertionError(f"[shard] {tag} step differs from Trainer.step: gradients "
                                 f"{worst:.3e}, loss {d_loss:.3e}, bitwise {same}")
        return ("bitwise" if same else
                f"clipped mean gradients within {worst:.2e} of each leaf's max, loss within "
                f"{d_loss:.2e}, parameters after Adam's first step within {d_params:.2e}")

    dp = Trainer(params, tcfg_model, tcfg, ensemble=True)
    step = make_sharded_train_step(dp, mesh)
    torch.cuda.synchronize()
    reset_launch_counts()
    loss = float(step(b).mean())
    torch.cuda.synchronize()
    paths["shard_train"] = launch_counts()
    dp_same = agree("data-parallel", tree_leaves(dp.params()), dp.state.mu, loss)
    dt = _timed_world(lambda seed: step(b))
    rates["shard_train"] = TRAIN_FRAMES / dt
    lines.append(f"[shard] data-parallel train step, 3 members x {TRAIN_FRAMES} frames over "
                 f"{world} rank(s): vs Trainer.step {dp_same}; "
                 f"{rates['shard_train']:.2f} structures/s ({smi})")
    if ens_mesh.coords is not None:
        es = Trainer(shard_chain_states(params, ens_mesh, "ensemble"), tcfg_model, tcfg,
                     ensemble=True)
        losses = make_ensemble_sharded_train_step(es, ens_mesh, "ensemble")(b)
        es_same = agree("ensemble-sharded",
                        tree_leaves(gather_chain_states(es.params(), ens_mesh, "ensemble")),
                        gather_chain_states(es.state.mu, ens_mesh, "ensemble"),
                        float(losses.mean()))
        lines.append(f"[shard] ensemble-sharded train step over "
                     f"{ens_mesh.axis_size('ensemble')} rank(s): vs Trainer.step {es_same}")
    if rank == 0:
        (Path(workdir) / "shard.json").write_text(json.dumps(
            {"world": world, "lines": lines, "rates": rates, "paths": paths}))


def shard_phase(dev, smi: str) -> dict:
    """47. [shard]: NCCL over every card of the machine (at most
    SHARD_MAX_WORLD), one spawned rank a card meeting through a FileStore
    in a temporary directory (_shard_rank); then the fine-tuning CLI with
    --mesh 1, which makes its own world of one on this process's card.
    Returns the launch counts of the sharded paths (rank 0's)."""
    import tempfile
    from pathlib import Path

    from surface_sampling_tpu_torch.cli import finetune
    from surface_sampling_tpu_torch.parallel import spawn_ranks

    world = min(torch.cuda.device_count(), SHARD_MAX_WORLD)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_shard_rank, world, "cuda", args=(tmp, smi))
        res = json.loads((Path(tmp) / "shard.json").read_text())
        for line in res["lines"]:
            print(line)
        claim = ("" if world > 1 else
                 "; world 1: sharding correctness only, no multi-GPU rate is claimed")
        print(f"[shard] world={world} ({time.perf_counter() - t0:.1f}s with start-up){claim}")

        _, _, frames, labels, _ = train_setup(dev)
        recs = [{"numbers": s.numbers.tolist(), "positions": s.positions.tolist(),
                 "cell": s.cell.tolist(), "energy": float(e), "forces": f.tolist()}
                for s, e, f in zip(frames, labels[0], labels[1])]
        (Path(tmp) / "frames.json").write_text(json.dumps(recs))
        from surface_sampling_tpu_torch.systems import MODEL_DATA

        finetune.main(["--data", str(Path(tmp) / "frames.json"), "--init",
                       str(MODEL_DATA / "srtio3_painn_01.npz"), "--out", str(Path(tmp) / "out"),
                       "--epochs", "2", "--batch-size", "4", "--mesh", "1"])
        metrics = json.loads((Path(tmp) / "out" / "metrics.json").read_text())
        import torch.distributed as dist

        if dist.is_initialized() or not np.isfinite(metrics["final_train_loss"]):
            raise AssertionError(f"finetune --mesh 1: {metrics}, world left open: "
                                 f"{dist.is_initialized()}")
        print(f"[shard] finetune --mesh 1 (NCCL world of one, made and ended by the CLI): "
              f"final train loss {metrics['final_train_loss']:.6e} on {metrics['device']}")
    return res["paths"]


def _image_painn(sys_, relax=None):
    """The flagship ensemble of ``sys_`` with its edges found by image
    search on every call (make_painn_potential without a static table),
    wrapped in an MCMCRun with the system's surface energy."""
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
    from surface_sampling_tpu_torch.systems import SYSTEMS_DATA

    pot = sys_.potential
    stoidict = json.loads((SYSTEMS_DATA / "srtio3_offset_data.json").read_text())["stoidict"]
    image = make_painn_potential(pot.params, pot.cfg, pot.znums.tolist(), units="kcal/mol",
                                 stoidict=stoidict)
    return MCMCRun(sys_.spec, image, surface_energy_fn=sys_.run.surface_energy_fn,
                   device=pot.params["atom_embed"].device, relax=relax)


def _image_mc(tag: str, run, n_chains: int, sweeps: int, sweep_size: int, repeat: bool) -> dict:
    """An MC run of ``run`` (an MCMCRun) from empty chains: launch counts,
    finite energies, a bitwise repeat when ``repeat``, evals/s (best of the
    runs) and peak memory. Returns the launch counts of the first run."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, geometric_schedule, make_run_fn

    run_fn = make_run_fn(run.d, run.state_energy_fn,
                         EngineConfig(sweep_size=sweep_size, record_positions=repeat))
    temps = geometric_schedule(1.0, sweeps, 0.99)
    states = run.init_state(n_chains=n_chains)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out_a, rec_a = run_fn(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (torch.isfinite(rec_a.energy).all() and torch.isfinite(out_a.energy).all()):
        raise AssertionError(f"[{tag}] non-finite energies")
    same = "not checked"
    if repeat:
        t0 = time.perf_counter()
        out_b, rec_b = run_fn(states, temps, _gen(0))
        torch.cuda.synchronize()
        dt = min(dt, time.perf_counter() - t0)
        same = all(torch.equal(a, b) for a, b in zip(
            (out_a.site_state, out_a.energy, out_a.relaxed_positions, rec_a.energy,
             rec_a.positions),
            (out_b.site_state, out_b.energy, out_b.relaxed_positions, rec_b.energy,
             rec_b.positions)))
        if not same:
            raise AssertionError(f"[{tag}] the run does not repeat bitwise")
    else:
        dt = min(dt, _best_of(lambda seed: run_fn(states, temps, _gen(seed))))
    n_mc = sweeps * sweep_size
    print(f"[{tag}] chains={n_chains} sweeps={sweeps}x{sweep_size} "
          f"evals/s={n_chains * n_mc / dt:.2f} step_ms={1e3 * dt / n_mc:.3f} bitwise repeat: "
          f"{same} accept={float(rec_a.accept_rate.mean()):.4f} "
          f"best={float(rec_a.energy.min()):.6f} eV peak_mem={peak_gb:.3f} GB "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


def image_edges_phase(dev) -> dict:
    """48. [image-edges]: the PaiNN and CHGNet potentials built without a
    static table find their edges by image search on every call. PaiNN
    SrTiO3 1x1: the pristine anchor, random states against the static-table
    path (MODE_TOL) and the card against the CPU (1e-3 eV), relaxed MC
    (rows 2 and 4) bitwise on repeat; CHGNet LaMnO3: the pristine anchor,
    rigid and 10-step relaxed runs (rows 10 and 12); ensemble_forces_std
    card vs CPU. Returns the launch counts of the runs."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.models.ensemble import ensemble_forces_std
    from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential
    from surface_sampling_tpu_torch.models.painn import tree_map
    from surface_sampling_tpu_torch.ops.neighbors import pair_shifts_for
    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet, srtio3_001_painn

    paths = {}
    sys1, cpu1 = srtio3_001_painn(device=dev), srtio3_001_painn(device="cpu")
    image, image_cpu = _image_painn(sys1), _image_painn(cpu1)
    S = sys1.spec.n_sites
    e0 = image.state_energy_fn(torch.zeros((1, S), dtype=torch.int64, device=dev))
    pe, se = float(e0.potential_energy[0]), float(e0.surface_energy[0])
    ss = _states(sys1.spec, IMAGE_CPU_STATES, np.random.default_rng(1), "cpu")
    e_img = image.state_energy_fn(ss.to(dev)).surface_energy.cpu()
    e_tab = sys1.run.state_energy_fn(ss.to(dev)).surface_energy.cpu()
    e_cpu = image_cpu.state_energy_fn(ss).surface_energy
    d_tab, d_cpu = float((e_img - e_tab).abs().max()), float((e_img - e_cpu).abs().max())
    print(f"[image-edges] PaiNN 1x1 by image search: pristine potential {pe:.6f} eV surface "
          f"{se:.6f} eV; {IMAGE_CPU_STATES} random states vs the static table max "
          f"{d_tab:.3e} eV (tol {MODE_TOL}), card vs CPU max {d_cpu:.3e} eV (tol 1e-3)")
    if not (abs(pe + 467.52) < 0.05 and abs(se - 12.49) < 0.02 and d_tab <= MODE_TOL
            and d_cpu <= 1e-3):
        raise AssertionError(f"[image-edges] PaiNN off: {pe}, {se}, {d_tab}, {d_cpu}")
    del image, image_cpu
    relaxed = _image_painn(sys1, RelaxConfig())
    paths["image_relax_mc"] = _image_mc("image-relax-mc", relaxed, N_CHAINS, RELAX_SWEEPS,
                                        RELAX_SWEEP_SIZE, repeat=True)
    if not (paths["image_relax_mc"]["painn_message_fused"]
            and paths["image_relax_mc"]["painn_message_bwd"]):
        raise AssertionError("[image-relax-mc] rows 2 and 4 were not launched")
    del relaxed
    torch.cuda.empty_cache()

    # ensemble_forces_std: jittered frames of the slab, card vs CPU
    frames = train_frames(4)
    cutoff, pot = sys1.potential.cfg.cutoff, sys1.potential
    sh = [pair_shifts_for(f.cell, f.scaled_positions, cutoff) for f in frames]
    k = max(len(x) for x in sh)
    shifts = np.full((len(frames), k, 3), 1e6, np.float32)
    for i, x in enumerate(sh):
        shifts[i, :len(x)] = x
    pos = np.stack([f.positions for f in frames]).astype(np.float32)
    nums = np.stack([f.numbers for f in frames]).astype(np.int64)
    args = [torch.as_tensor(x) for x in (pos, nums, nums > 0, shifts)]
    std = ensemble_forces_std(pot.params, pot.cfg, *(a.to(dev) for a in args)).cpu()
    std_cpu = ensemble_forces_std(tree_map(lambda x: x.cpu(), pot.params), pot.cfg, *args)
    d_std = float((std - std_cpu).abs().max())
    print(f"[image-edges] ensemble_forces_std on {len(frames)} jittered frames: max "
          f"{float(std.max()):.4f} eV/A, card vs CPU max {d_std:.3e} eV/A (tol 1e-3)")
    if not d_std <= 1e-3:
        raise AssertionError(f"[image-edges] ensemble_forces_std card vs CPU {d_std}")
    del sys1, cpu1
    torch.cuda.empty_cache()

    # CHGNet on LaMnO3 by image search
    sys_a = lamno3_001_chgnet(device=dev)
    cp = sys_a.potential
    chg = make_chgnet_potential(cp.params, cp.cfg, cp.znums.tolist())
    run = MCMCRun(sys_a.spec, chg, surface_energy_fn=sys_a.run.surface_energy_fn, device=dev)
    e0 = run.state_energy_fn(torch.zeros((1, sys_a.spec.n_sites), dtype=torch.int64,
                                         device=dev))
    pe = float(e0.potential_energy[0])
    print(f"[image-edges] CHGNet LaMnO3 by image search: pristine potential {pe:.6f} eV "
          f"(-405.206 +- 1e-3)")
    if not abs(pe + 405.206) < 1e-3:
        raise AssertionError(f"[image-edges] CHGNet pristine off: {pe}")
    paths["image_chgnet_mc"] = _image_mc("image-chgnet-mc", run, CHG_CHAINS, SWEEPS, SWEEP_SIZE,
                                         repeat=False)
    relaxed = MCMCRun(sys_a.spec, chg, surface_energy_fn=sys_a.run.surface_energy_fn,
                      device=dev, relax=RelaxConfig(steps=CHG_RELAX_STEPS))
    paths["image_chgnet_relax_mc"] = _image_mc("image-chgnet-relax-mc", relaxed,
                                               CHG_RELAX_CHAINS, RELAX_SWEEPS,
                                               RELAX_SWEEP_SIZE, repeat=True)
    if not (paths["image_chgnet_mc"]["chgnet_conv"]
            and paths["image_chgnet_relax_mc"]["chgnet_conv_bwd"]):
        raise AssertionError("[image-edges] rows 10 and 12 were not launched")
    rows = ("painn_message_fused", "painn_message_bwd", "chgnet_conv", "chgnet_conv_bwd")
    print(f"[image-edges] launches of rows 2 / 4 / 10 / 12 by path: "
          f"{json.dumps({p: [c[r] for r in rows] for p, c in paths.items()})}")
    return paths


def _random_rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def mace_phase(dev) -> dict:
    """49. [mace]: init_mace at the default width, seeded, for each of
    MACE_CONFIGS on the flagship 1x1 (Sr, Ti, O): card vs CPU energies and
    forces (1e-3 eV, 1e-3 eV/A), the energy under a random rotation of
    positions and image shifts (MACE_ROT_TOL), the static table vs image
    search (MODE_TOL), rigid MC over the table, relaxed MC over the relax
    table bitwise on repeat with peak memory. Returns the launch counts of
    the rigid runs (MACE runs no kernel of the port)."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.models.mace import MACEConfig, init_mace, make_mace_potential
    from surface_sampling_tpu_torch.models.painn import tree_map
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    sys1 = srtio3_001_painn(device=dev)
    spec, d = sys1.spec, sys1.run.d
    types = sys1.potential.znums.tolist()
    relax_nbr = build_static_neighbor_table(spec, 5.0, relax_slack=0.6)
    ss = _states(spec, IMAGE_CPU_STATES, np.random.default_rng(1), dev)
    pos, ti, alive = realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss)
    rot = torch.as_tensor(_random_rotation(np.random.default_rng(7)), dtype=torch.float32,
                          device=dev)
    paths = {}
    for i, (l_max, eq, mode) in enumerate(MACE_CONFIGS):
        tag = f"mace-l{l_max}-{'eq' if eq else 'inv'}-{mode}"
        cfg = MACEConfig(l_max=l_max, equivariant_messages=eq, message_mode=mode)
        params = init_mace(torch.Generator(device=dev).manual_seed(i), cfg)
        image = make_mace_potential(params, cfg, types)
        image_cpu = make_mace_potential(tree_map(lambda x: x.cpu(), params), cfg, types)
        table = make_mace_potential(params, cfg, types, static_nbr=sys1.static_nbr)
        e, f = image.energy_and_forces(pos, ti, alive, d.shifts)
        e_c, f_c = image_cpu.energy_and_forces(pos.cpu(), ti.cpu(), alive.cpu(),
                                               d.shifts.cpu())
        d_e, d_f = float((e.cpu() - e_c).abs().max()), float((f.cpu() - f_c).abs().max())
        e_rot = image.energy(pos @ rot.T, ti, alive, d.shifts @ rot.T)
        d_rot = float((e_rot - e).abs().max())
        d_tab = float((table.energy(pos, ti, alive) - e).abs().max())
        print(f"[{tag}] F={cfg.feat_dim} R={cfg.n_rbf} cutoff={cfg.cutoff} layers="
              f"{cfg.n_layers} M={cfg.max_neighbors}: energies {e.tolist()} eV; card vs CPU "
              f"{d_e:.3e} eV / {d_f:.3e} eV/A (tol 1e-3, max|F| {float(f.abs().max()):.3f}); "
              f"random rotation {d_rot:.3e} eV (tol {MACE_ROT_TOL}); static table vs image "
              f"search {d_tab:.3e} eV (tol {MODE_TOL})")
        if not (d_e <= 1e-3 and d_f <= 1e-3 and d_rot <= MACE_ROT_TOL and d_tab <= MODE_TOL):
            raise AssertionError(f"[{tag}] off: {d_e}, {d_f}, {d_rot}, {d_tab}")
        del image, image_cpu
        paths[f"mace_mc_{i}"] = _image_mc(f"{tag}-mc", MCMCRun(spec, table, device=dev),
                                          N_CHAINS, SWEEPS, SWEEP_SIZE, repeat=False)
        torch.cuda.empty_cache()
        relax_pot = make_mace_potential(params, cfg, types, static_nbr=relax_nbr)
        _image_mc(f"{tag}-relax-mc", MCMCRun(spec, relax_pot, device=dev,
                                             relax=RelaxConfig(fmax=MACE_FMAX)),
                  MACE_RELAX_CHAINS, RELAX_SWEEPS, RELAX_SWEEP_SIZE, repeat=True)
        del table, relax_pot
        torch.cuda.empty_cache()
    return {"mace_mc": {k: sum(p[k] for p in paths.values()) for k in launch_counts()}}


def slice16_phases(dev, smi: str) -> dict:
    """Phases 47-49; returns the launch counts of their paths."""
    paths = shard_phase(dev, smi)
    torch.cuda.empty_cache()
    paths.update(image_edges_phase(dev))
    torch.cuda.empty_cache()
    paths.update(mace_phase(dev))
    return paths


# ----------------------------------------------------------------------
# CHGNet and MACE training, and the Pourbaix path (slice 17)
# ----------------------------------------------------------------------
# [chgnet-train]: the LaMnO3 checkpoint at full width on 16 frames of its
# slab jittered by N(0, 0.05 A); the frames are labelled by the checkpoint
# itself (energy, forces, magmoms of its head), and training starts from the
# checkpoint with every leaf perturbed by CHG_TRAIN_PERTURB x its own std
# (seeded), so the loss starts above zero and falls as the steps undo it
CHG_TRAIN_FRAMES, CHG_TRAIN_JITTER, CHG_TRAIN_PERTURB = 16, 0.05, 0.01
CHG_MAGMOM_WEIGHT = 0.5
# frames of the card-vs-CPU gradient checks (the CPU plain path differentiates
# the full-width models twice)
TRAIN_CPU_FRAMES = 2
# [pourbaix-mc]: campaign pourbaix_sriro's run cut from 300 sweeps to 4
POURBAIX_SWEEPS, POURBAIX_CPU_STATES = 4, 4
POURBAIX_CAMPAIGN_BEST = 194.048          # eV, the campaign's logged best (mc.log)
POURBAIX_E_TOL = 1e-3


def _perturbed(tree, seed: int, scale: float):
    """Every leaf of a parameter tree plus seeded N(0, (scale x its std)^2)
    noise (leaves of one element or zero spread unchanged)."""
    from surface_sampling_tpu_torch.models.painn import tree_map

    gen = torch.Generator(device="cpu").manual_seed(seed)

    def one(x):
        if x.numel() < 2:
            return x.clone()
        noise = torch.randn(x.shape, generator=gen).to(x.device)
        return x + scale * float(x.std()) * noise

    return tree_map(one, tree)


def _train_on(trainer, batch, tag: str, frames: int) -> tuple[list, list, dict]:
    """[train]'s timing loop for any Trainer: one untimed step, then
    TRAIN_RUNS timed runs of TRAIN_STEPS steps of one optimizer trajectory.
    Returns the losses before each step, the runs' step seconds and the
    launch counts of the timed steps; prints structures/s and peak memory."""
    history = [trainer.step(batch)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(TRAIN_RUNS):
        t0 = time.perf_counter()
        history += [trainer.step(batch) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / TRAIN_STEPS)
    counts = launch_counts()
    step = min(times)
    print(f"[{tag}] {frames} frames, 1 + {TRAIN_RUNS} x {TRAIN_STEPS} Adam steps: "
          f"{frames / step:.2f} structures/s, step {1e3 * step:.3f} ms (best run; runs "
          f"{[round(1e3 * t, 3) for t in times]} ms), peak_mem="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; loss before each step "
          f"{[float(f'{h:.6e}') for h in history]}")
    return history, times, counts


def _card_vs_cpu_step(tag: str, params, cfg, tcfg, batch, apply_fn, dev) -> None:
    """One training step's loss and every parameter gradient on the first
    TRAIN_CPU_FRAMES frames: the card against the CPU plain path, the loss
    within TRAIN_LOSS_RTOL relative, each leaf within TRAIN_GRAD_RTOL x
    max|cpu|."""
    from surface_sampling_tpu_torch.models.painn import tree_map
    from surface_sampling_tpu_torch.models.train import Trainer, batch_to_device

    few = batch._replace(**{k: None if getattr(batch, k) is None
                            else getattr(batch, k)[:TRAIN_CPU_FRAMES] for k in batch._fields})
    out = []
    for d in (dev, torch.device("cpu")):
        trainer = Trainer(tree_map(lambda x: x.to(d), params), cfg, tcfg, apply_fn=apply_fn)
        loss, grads = trainer.gradients(batch_to_device(few, d))
        out.append((float(loss[0]), [g.cpu() for g in grads]))
    (lg, gg), (lc, gc) = out
    dl = abs(lg - lc) / abs(lc)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gg, gc))
    print(f"[{tag}] {TRAIN_CPU_FRAMES} frames: loss card {lg:.8e} cpu {lc:.8e} rel diff "
          f"{dl:.3e} (tol {TRAIN_LOSS_RTOL}); {len(gg)} gradient leaves, worst max|card - cpu| / "
          f"max|cpu| {worst:.3e} (tol {TRAIN_GRAD_RTOL})")
    if not (dl <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"[{tag}] card and CPU training gradients differ")


def chgnet_train_setup(dev):
    """The LaMnO3 checkpoint on ``dev``, CHG_TRAIN_FRAMES jittered frames of
    its slab (np.random.default_rng(1)) and their labels from the
    checkpoint itself: a host PaddedBatch with magmoms."""
    from surface_sampling_tpu_torch.models.chgnet import chgnet_apply_structures
    from surface_sampling_tpu_torch.models.train import batch_to_device, pad_structures
    from surface_sampling_tpu_torch.models.weights import from_jax_params, load_chgnet_npz
    from surface_sampling_tpu_torch.structure.atoms import Structure
    from surface_sampling_tpu_torch.systems import MODEL_DATA, SYSTEMS_DATA

    tree, cfg = load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    params = from_jax_params(tree, dev)
    data = np.load(SYSTEMS_DATA / "LaMnO3_001_2x2x3.npz")
    rng = np.random.default_rng(1)
    frames = [Structure(data["numbers"], data["positions"] + rng.normal(
        0, CHG_TRAIN_JITTER, data["positions"].shape), data["cell"])
        for _ in range(CHG_TRAIN_FRAMES)]
    n = [len(f) for f in frames]
    zeros = pad_structures(frames, np.zeros(len(frames)), [np.zeros((k, 3)) for k in n],
                           cfg.atom_graph_cutoff, magmoms=[np.zeros(k) for k in n])
    b = batch_to_device(zeros, dev)
    pos = b.positions.clone().requires_grad_(True)
    out = chgnet_apply_structures(params, cfg, pos, b.numbers, b.numbers > 0, b.shifts)
    (g,) = torch.autograd.grad(out["energy"].sum(), pos)
    batch = zeros._replace(energy=out["energy"].detach().cpu().numpy().astype(np.float64),
                           forces=(-g).cpu().numpy(), magmoms=out["magmom"].detach().cpu().numpy())
    return params, cfg, frames, batch


def chgnet_bwd2_phase(params, cfg, batch, dev) -> None:
    """[chgnet-bwd2] grad-of-grad through chgnet_conv on the training
    frames' own atom graph (F = 64, M = 96, their neighbour lists and
    reverse table; seeded features, outer cotangents and weights): row 10
    forward, row 12 first order, the fixed-order double VJP, against the
    same computation with the plain versions on the card, within
    KERNEL_RTOL x max|plain| per output; bitwise on repeat; the time of
    both."""
    from surface_sampling_tpu_torch.models.train import batch_to_device
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.ops.neighbors import neighbor_list, padded_rows

    b = batch_to_device(batch, dev)
    edges = neighbor_list(b.positions, b.shifts, b.numbers > 0, cfg.atom_graph_cutoff,
                          cfg.max_neighbors)
    C, N, M = edges.mask.shape
    n_pad, F = padded_rows(N), cfg.atom_fea_dim
    pad = (0, 0, 0, n_pad - N)
    maskf = torch.nn.functional.pad(edges.mask, pad).reshape(C, -1).float().contiguous()
    nbr = torch.nn.functional.pad(edges.nbr_j, pad).reshape(C, -1).to(torch.int32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(17)
    E = n_pad * M

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    args = [rn(C, n_pad, 2 * F), rn(C, n_pad, 2 * F), rn(C, E, F), rn(C, E, F), maskf, nbr,
            rn(F, 2 * F, scale=0.1), rn(F, F, scale=0.1), rn(F, F, scale=0.1), rn(F), rn(F),
            torch.stack([1.0 + rn(F, scale=0.1), rn(F, scale=0.1)]),
            torch.stack([1.0 + rn(F, scale=0.1), rn(F, scale=0.1)])]
    diff = [0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12]
    wout, cg = rn(C, n_pad, F), [rn(*args[i].shape) for i in diff]

    def second_order(kernel: bool):
        xs = [a.clone() for a in args]
        for i in diff:
            xs[i].requires_grad_(True)
        agg = (ck.chgnet_conv(*xs, edges.rev) if kernel
               else ck.chgnet_conv_plain(*xs))
        g = torch.autograd.grad((agg * wout).sum(), [xs[i] for i in diff], create_graph=True)
        outer = sum((gi * ci).sum() for gi, ci in zip(g, cg))
        return torch.autograd.grad(outer, [xs[i] for i in diff])

    got, again, want = second_order(True), second_order(True), second_order(False)
    torch.cuda.synchronize()
    errs = {}
    for name, g, a, p in zip(ck.GRAD_NAMES, got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"[chgnet-bwd2] {name}: two grad-of-grad passes differ")
        errs[name] = (float((g - p).abs().max()), float(p.abs().max()))
        if not errs[name][0] <= KERNEL_RTOL * errs[name][1]:
            raise AssertionError(f"[chgnet-bwd2] {name}: max abs error {errs[name][0]} exceeds "
                                 f"{KERNEL_RTOL} x max|plain| {errs[name][1]}")
    ms = _cuda_ms(lambda: second_order(True), reps=3)
    plain_ms = _cuda_ms(lambda: second_order(False), reps=3, warm=1)
    print(f"[chgnet-bwd2] grad-of-grad of chgnet_conv (row 10 forward, row 12 first order, "
          f"the fixed-order double VJP) vs the plain versions on the card: frames={C} "
          f"n_pad={n_pad} M={M} F={F} live_edges={int(maskf.sum())}; worst error / max|plain| "
          f"{max(e / s for e, s in errs.values()):.3e} (tol {KERNEL_RTOL}) "
          f"{json.dumps({k: f'{e:.2e}' for k, (e, s) in errs.items()})}; bitwise repeat ok; "
          f"ms={ms:.3f} plain_ms={plain_ms:.3f} (forward, first and second order)")


def chgnet_train_phase(params, cfg, batch, dev) -> dict:
    """[chgnet-train] A Trainer on the perturbed checkpoint with the magmom
    term (CHG_MAGMOM_WEIGHT), lr TRAIN_LR: card vs CPU on two frames, then
    [train]'s timing loop on every frame. Per step one forward (row 10 once
    a layer) and two first-order passes a layer (the force pass and the
    outer backward's energy and magmom terms: row 12 with the weight
    cotangents, both); the loss falls over the timed steps. Returns the
    launch counts of the timed steps."""
    from surface_sampling_tpu_torch.models.chgnet import chgnet_apply_structures
    from surface_sampling_tpu_torch.models.train import TrainConfig, Trainer, batch_to_device

    tcfg = TrainConfig(learning_rate=TRAIN_LR, magmom_weight=CHG_MAGMOM_WEIGHT)
    start = _perturbed(params, 3, CHG_TRAIN_PERTURB)
    _card_vs_cpu_step("chgnet-train", start, cfg, tcfg, batch, chgnet_apply_structures, dev)
    trainer = Trainer(start, cfg, tcfg, apply_fn=chgnet_apply_structures)
    history, _, counts = _train_on(trainer, batch_to_device(batch, dev), "chgnet-train",
                                   CHG_TRAIN_FRAMES)
    steps = TRAIN_RUNS * TRAIN_STEPS
    L = cfg.n_conv
    _expect("chgnet-train", counts, {"chgnet_conv": L * steps, "chgnet_conv_bwd": 2 * L * steps,
                                     "chgnet_conv_bwd.weights": 2 * L * steps})
    per_step = {k: v / steps for k, v in counts.items() if v}
    print(f"[chgnet-train] launches per step {json.dumps(per_step)} (rows 10 / 12)")
    if not all(np.isfinite(history)) or not history[-1] < min(history[0], history[1]):
        raise AssertionError(f"[chgnet-train] the loss did not fall over the timed steps: "
                             f"{history}")
    return counts


def mace_train_phase(dev) -> dict:
    """[mace-train] The MACE force loss: a random MACE at the JAX default
    width (MACEConfig(): F 64, 8 RBFs, cutoff 5, 2 layers, M 64, l_max 2
    layer-local), seeded, on [train]'s frames and labels; card vs CPU on
    two frames, then [train]'s timing loop. Returns the launch counts of
    the timed steps (MACE runs no kernel of the port)."""
    from surface_sampling_tpu_torch.models.mace import MACEConfig, init_mace, mace_apply
    from surface_sampling_tpu_torch.models.train import TrainConfig, Trainer, batch_to_device

    _, _, frames, _, batch = train_setup(dev)
    cfg = MACEConfig()
    params = init_mace(torch.Generator(device=dev).manual_seed(0), cfg)
    tcfg = TrainConfig(learning_rate=1e-3)
    _card_vs_cpu_step("mace-train", params, cfg, tcfg, batch, mace_apply, dev)
    trainer = Trainer(params, cfg, tcfg, apply_fn=mace_apply)
    history, _, counts = _train_on(trainer, batch_to_device(batch, dev), "mace-train",
                                   len(frames))
    _expect("mace-train", counts, {})
    if not all(np.isfinite(history)):
        raise AssertionError(f"[mace-train] non-finite losses: {history}")
    return counts


def finetune_families_phase(chg_frames, chg_batch, dev) -> None:
    """[finetune-families] The CLI on the card for the other two families:
    --family chgnet --init lamno3_chgnet.npz --magmom-weight 0.5 on the
    [chgnet-train] frames and labels, and --family mace (a fresh default
    model, seed 0) on the same frames, 2 epochs each. Each saved model.npz
    reloads with the port's loader and gives the energies of the same
    training in this process within 1e-6 relative."""
    import tempfile
    from pathlib import Path

    from surface_sampling_tpu_torch.cli import finetune
    from surface_sampling_tpu_torch.models.dataset import get_train_val_test_loader
    from surface_sampling_tpu_torch.models.train import TrainConfig, batch_to_device, train_painn
    from surface_sampling_tpu_torch.models.weights import from_jax_params
    from surface_sampling_tpu_torch.systems import MODEL_DATA

    init = MODEL_DATA / "lamno3_chgnet.npz"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        recs = [{"numbers": s.numbers.tolist(), "positions": s.positions.tolist(),
                 "cell": s.cell.tolist(), "energy": float(e), "forces": f[:len(s)].tolist(),
                 "magmom": m[:len(s)].tolist()}
                for s, e, f, m in zip(chg_frames, chg_batch.energy, chg_batch.forces,
                                      chg_batch.magmoms)]
        (tmp / "frames.json").write_text(json.dumps(recs))
        runs = {"chgnet": (["--init", str(init), "--magmom-weight", str(CHG_MAGMOM_WEIGHT)],
                           TrainConfig(epochs=2, magmom_weight=CHG_MAGMOM_WEIGHT)),
                "mace": ([], TrainConfig(epochs=2))}
        for family, (extra, tcfg) in runs.items():
            fam = finetune.FAMILIES[family]
            out = tmp / family
            t0 = time.perf_counter()
            finetune.main(["--data", str(tmp / "frames.json"), "--family", family, "--out",
                           str(out), "--epochs", "2", *extra])
            dt = time.perf_counter() - t0
            missing = [n for n in ("model.npz", "history.csv", "metrics.json", "settings.json")
                       if not (out / n).exists()]
            if missing:
                raise AssertionError(f"[finetune-families] {family}: no {missing}")
            metrics = json.loads((out / "metrics.json").read_text())
            saved, cfg = fam.load(out / "model.npz")
            if family == "chgnet":
                start = from_jax_params(fam.load(init)[0], dev)
            else:
                start = fam.init(torch.Generator(device=dev).manual_seed(0), cfg)
            train, _, _ = get_train_val_test_loader(tmp / "frames.json", fam.cutoff(cfg))
            trained, _ = train_painn(start, cfg, train, tcfg, apply_fn=fam.apply_fn)
            b = batch_to_device(train[0], dev)
            e_saved, e_here = (fam.apply_fn(p, cfg, b.positions, b.numbers, b.numbers > 0,
                                            b.shifts)["energy"]
                               for p in (from_jax_params(saved, dev), trained))
            diff = float(((e_saved - e_here).abs() / e_here.abs()).max())
            print(f"[finetune-families] --family {family} {' '.join(extra)}, 2 epochs on "
                  f"{len(chg_frames)} frames: {dt:.1f}s wall, final train loss "
                  f"{metrics['final_train_loss']:.6e} on {metrics['device']}; four files; saved "
                  f"model vs the same training in-process: max rel energy diff {diff:.3e} "
                  f"(tol 1e-6)")
            if not diff <= 1e-6:
                raise AssertionError(f"[finetune-families] {family}: saved energies differ by "
                                     f"{diff}")


def pourbaix_setup(dev):
    """Campaign pourbaix_sriro through the library, as
    cli/sample_pourbaix_surface.py builds it: the slab from its CIF, the
    Pourbaix atoms at its (pH, phi), its sites, the surface-atom spec and
    start state, the CHGNet potential built without a table and rebuilt
    over the spec's static candidate table through its rebuild hook (the
    CLI's "fast" upgrade), the Pourbaix energy. Returns (run, site_state0,
    settings)."""
    from pathlib import Path

    from surface_sampling_tpu_torch.constants import Z_FROM_SYMBOL
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.spec import make_spec_sampling_surface_atoms
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential
    from surface_sampling_tpu_torch.models.weights import from_jax_params, load_chgnet_npz
    from surface_sampling_tpu_torch.pourbaix import (
        generate_pourbaix_atoms,
        make_pourbaix_surface_energy,
    )
    from surface_sampling_tpu_torch.structure import find_adsorption_sites
    from surface_sampling_tpu_torch.structure.io import read_cif

    root = Path(__file__).resolve().parent
    camp = root / "campaigns" / "pourbaix_sriro"
    settings = json.loads((camp / "settings.json").read_text())
    sys_s, samp, calc = (settings[k] for k in ("system_settings", "sampling_settings",
                                               "calc_settings"))
    slab = read_cif(camp / "SrIrO3_001_2x2.cif")
    atoms = generate_pourbaix_atoms(camp / calc["phase_diagram"], camp / calc["pourbaix_diagram"],
                                    calc["phi"], calc["pH"], calc["elements"])
    sites = find_adsorption_sites(slab, planar_distance=sys_s["planar_distance"],
                                  near_reduce=sys_s["near_reduce"],
                                  no_obtuse_hollow=sys_s["no_obtuse_hollow"])[
        sys_s["ads_site_type"]]
    tree, cfg = load_chgnet_npz(camp / calc["model_path"])
    numbers = [Z_FROM_SYMBOL[e] for e in calc["elements"]]
    pot = make_chgnet_potential(from_jax_params(tree, dev), cfg, numbers,
                                units=calc["model_units"])
    z = slab.positions[:, 2]
    spec, ss0 = make_spec_sampling_surface_atoms(
        slab, (z.max() - z) < sys_s["surface_atom_tol"], samp["adsorbates"],
        potential_numbers=numbers, cutoff=sys_s["cutoff"], extra_site_coords=sites,
        surface_depth=sys_s["surface_depth"], surface_name=sys_s["surface_name"])
    nbr = build_static_neighbor_table(spec, cfg.atom_graph_cutoff, relax_slack=0.1)
    pot = make_chgnet_potential(static_nbr=nbr, **pot.chgnet_args)
    se = make_pourbaix_surface_energy(spec, atoms, phi=calc["phi"], pH=calc["pH"],
                                      temp=calc["temperature"],
                                      adsorbate_corrections=calc["adsorbate_corrections"],
                                      device=dev)
    return MCMCRun(spec, pot, surface_energy_fn=se, device=dev), ss0, settings


def pourbaix_mc_phase(dev) -> dict:
    """[pourbaix-mc] Campaign pourbaix_sriro on the card at its full width
    (55 sites, 222 slots, the CHGNet checkpoint: row 10 four times an
    evaluation): the prefilled state and POURBAIX_CPU_STATES random states
    card vs the CPU port (POURBAIX_E_TOL); its run, metropolis_distance at
    its filter, its chain count and annealing schedule, cut to
    POURBAIX_SWEEPS sweeps of its sweep size, from the prefilled start
    state: launch counts, evals/s (best of 3 after one untimed run), finite
    energies, a bitwise repeat. Returns the launch counts of the untimed
    run."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, make_run_fn
    from surface_sampling_tpu_torch.utils import create_anneal_schedule

    t0 = time.perf_counter()
    run, ss0, settings = pourbaix_setup(dev)
    run_cpu, _, _ = pourbaix_setup(torch.device("cpu"))
    samp = settings["sampling_settings"]
    spec = run.spec
    rng = np.random.default_rng(4)
    ss = np.tile(ss0, (1 + POURBAIX_CPU_STATES, 1)).astype(np.int64)
    extra = rng.integers(1, spec.n_codes, ss.shape)
    ss[1:] = np.where(rng.random(ss[1:].shape) < 0.1, extra[1:], ss[1:])
    e_card = run.state_energy_fn(torch.as_tensor(ss, device=dev))
    e_cpu = run_cpu.state_energy_fn(torch.as_tensor(ss))
    d_e = float((e_card.surface_energy.cpu() - e_cpu.surface_energy).abs().max())
    e0 = float(e_card.surface_energy[0])
    print(f"[pourbaix-mc] campaign {spec.surface_name}: {spec.n_sites} sites, {spec.n_slots} "
          f"slots, vocabulary {[v.name for v in spec.vocab]}, {int((ss0 > 0).sum())} prefilled "
          f"(setup {time.perf_counter() - t0:.1f}s, two devices); prefilled state's Pourbaix "
          f"energy {e0:.6f} eV (the campaign's logged best after 300 sweeps: "
          f"{POURBAIX_CAMPAIGN_BEST} eV); the prefilled and {POURBAIX_CPU_STATES} random states "
          f"card vs CPU max {d_e:.3e} eV (tol {POURBAIX_E_TOL})")
    if not (d_e <= POURBAIX_E_TOL and torch.isfinite(e_card.surface_energy).all()):
        raise AssertionError(f"[pourbaix-mc] card and CPU Pourbaix energies differ by {d_e}")
    del run_cpu

    cfg = EngineConfig(sweep_size=samp["sweep_size"], criterion=samp["criterion"],
                       filter_distance=samp["filter_distance"])
    run_fn = make_run_fn(run.d, run.state_energy_fn, cfg)
    temps = create_anneal_schedule(samp["start_temp"], POURBAIX_SWEEPS, samp["alpha"])
    n_chains = samp["n_chains"]
    states = run.init_state(site_state=ss0, n_chains=n_chains)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out_a, rec_a = run_fn(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt_first = time.perf_counter() - t0
    launches = launch_counts()
    n_mc = POURBAIX_SWEEPS * samp["sweep_size"]
    _expect("pourbaix-mc", launches, {"chgnet_conv": 4 * n_mc})
    if not (torch.isfinite(rec_a.energy).all() and torch.isfinite(out_a.energy).all()):
        raise AssertionError("[pourbaix-mc] non-finite energies")
    t0 = time.perf_counter()
    out_b, rec_b = run_fn(states, temps, _gen(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not _bitwise((out_a, rec_a), (out_b, rec_b)):
        raise AssertionError("[pourbaix-mc] the run does not repeat bitwise")
    dt = min(dt, _best_of(lambda seed: run_fn(states, temps, _gen(seed)), reps=2))
    print(f"[pourbaix-mc] chains={n_chains} sweeps={POURBAIX_SWEEPS}x{samp['sweep_size']} "
          f"({samp['criterion']}, filter {samp['filter_distance']} A, T {temps[0]} -> "
          f"{temps[-1]:.4f}): evals/s={n_chains * n_mc / dt:.2f} step_ms={1e3 * dt / n_mc:.3f} "
          f"(untimed first run {dt_first:.1f}s) bitwise repeat ok accept="
          f"{float(rec_a.accept_rate.mean()):.4f} oob={float(rec_a.oob_rate.mean()):.4f} "
          f"best={float(rec_a.energy.min()):.6f} eV peak_mem="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB launches="
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


def slice17_phases(dev) -> dict:
    """Phases 50-54; returns the launch counts of their paths."""
    t0 = time.perf_counter()
    params, cfg, frames, batch = chgnet_train_setup(dev)
    print(f"[chgnet-train-build] {len(frames)} frames of {len(frames[0])} atoms, labels from "
          f"the checkpoint ({time.perf_counter() - t0:.1f}s); label energies "
          f"{batch.energy[:4].tolist()} ...")
    chgnet_bwd2_phase(params, cfg, batch, dev)
    torch.cuda.empty_cache()
    paths = {"chgnet_train": chgnet_train_phase(params, cfg, batch, dev)}
    torch.cuda.empty_cache()
    paths["mace_train"] = mace_train_phase(dev)
    torch.cuda.empty_cache()
    finetune_families_phase(frames, batch, dev)
    del params
    torch.cuda.empty_cache()
    paths["pourbaix_mc"] = pourbaix_mc_phase(dev)
    return paths


# ----------------------------------------------------------------------
# The sampling CLI on the card (slice 18)
# ----------------------------------------------------------------------
# the campaigns' own settings files, cut only in total_sweeps,
# checkpoint_interval and run_folder (and sweep_size for [cli-ff])
CLI_A_SWEEPS, CLI_A_PART, CLI_A_INTERVAL = 6, 4, 2
CLI_POURBAIX_SWEEPS, CLI_POURBAIX_INTERVAL = 2, 1
CLI_FF_SWEEPS, CLI_FF_SWEEP_SIZE = 1, 4
CLI_CPU_CHAINS = 2
CLI_FF_CPU_CHAINS = 1                      # the CPU descent of a 168-row ball takes seconds a chain
CLI_E_TOL, CLI_F_TOL, CLI_FF_TOL = 1e-3, 1e-3, 5e-3
POURBAIX_PREFILLED_E = 263.436584          # eV, [pourbaix-mc]'s library path (PR 17)


def _campaign_settings(camp, name: str, out, tag: str, **samp):
    """A copy ``<tag>.json`` under ``out`` of campaign ``camp``'s settings
    file ``name`` as ``load_settings`` reads it (file references absolute),
    its sampling settings updated by ``samp``. Returns the copy's path."""
    from surface_sampling_tpu_torch.cli.common import load_settings

    s = load_settings(camp / name)
    s["sampling_settings"].update(samp)
    path = out / f"{tag}.json"
    path.write_text(json.dumps(s))
    return path


def _history(folder) -> dict:
    with np.load(folder / "history.npz") as h:
        return {k: h[k] for k in h.files}


def _run_timing(folder) -> dict:
    """The PhaseTimer split of a run, from the last Timing line of its
    mc.log: {phase: seconds}."""
    import re

    line = [ln for ln in (folder / "mc.log").read_text().splitlines() if "Timing:" in ln][-1]
    return {k: float(v) for k, v in re.findall(r"(\w+): ([\d.]+)s \(", line)}


@contextlib.contextmanager
def _timed_calls(module, names):
    """Time, while the block runs, every call of the functions ``names`` of
    ``module`` (the card synchronised at each call's end); yields {name:
    seconds}, summed over the calls."""
    spent, saved = dict.fromkeys(names, 0.0), {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    for n in names:
        setattr(module, n, timed(n, saved[n]))
    try:
        yield spent
    finally:
        for n in names:
            setattr(module, n, saved[n])


def _timed_cli(main, argv) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def cli_campaign_a_phase(dev, tmp) -> tuple[dict, object, object]:
    """55. Campaign A (campaigns/srtio3_2x2: the 3-member PaiNN, 2x2 slab
    of 496 slots, 32 chains, incremental, metropolis_distance, t_min)
    through ``python -m surface_sampling_tpu_torch.cli.sample_surface`` on
    the card: CLI_A_SWEEPS sweeps in chunks of CLI_A_INTERVAL (launch counts
    of rows 3 / 6 / 7 / 8: the initial energies through the banded trunk,
    the delta engine's caches at each chunk, three subset and update
    launches a step), then CLI_A_PART sweeps resumed to CLI_A_SWEEPS
    (bitwise the uninterrupted run's tail), the checkpoint's energies
    against a fresh full evaluation, the first sweep's energies of
    CLI_CPU_CHAINS chains against the CPU port. Returns the launch counts,
    the best CIF and the settings file."""
    from pathlib import Path

    from surface_sampling_tpu_torch.cli import common
    from surface_sampling_tpu_torch.cli.common import assemble_system, load_settings, load_slab
    from surface_sampling_tpu_torch.cli.sample_surface import main
    from surface_sampling_tpu_torch.io import load_checkpoint

    camp = Path(__file__).resolve().parent / "campaigns" / "srtio3_2x2"
    cif = camp / "SrTiO3_001_2x2super.cif"
    sp_full = _campaign_settings(camp, "settings.json", tmp, "a_full",
                                 total_sweeps=CLI_A_SWEEPS, checkpoint_interval=CLI_A_INTERVAL,
                                 run_folder=str(tmp / "a_full"))
    samp = json.loads(sp_full.read_text())["sampling_settings"]
    reset_launch_counts()
    with _timed_calls(common, ("load_settings", "load_slab", "build_potential",
                               "assemble_system", "run_sampling")) as host:
        wall = _timed_cli(main, ["--settings", str(sp_full), "--slab", str(cif)])
    launches = launch_counts()
    n_steps, n_chunks = CLI_A_SWEEPS * samp["sweep_size"], CLI_A_SWEEPS // CLI_A_INTERVAL
    L = 3
    # the initial energies through the banded trunk, the delta engine's
    # caches at each chunk start, then L subset and update launches a step
    want = {k: v + n_chunks * INC_INIT_LAUNCHES.get(k, 0) for k, v in BANDED_LAUNCHES.items()}
    want["painn_message_subset"] = L * n_steps
    want["painn_update_fused"] += L * n_steps
    _expect("cli-campaign-a", launches, want)
    full = _history(tmp / "a_full")
    timing = _run_timing(tmp / "a_full")
    # the CLI wall by host call (build_potential runs inside
    # assemble_system); "rest" is argparse, the run folder and its settings
    cli_split = dict(host, rest=wall - sum(v for k, v in host.items() if k != "build_potential"))
    mc_s = timing.get("first_chunk", 0.0) + timing.get("mc_chunks", 0.0)
    if not np.isfinite(full["energy"]).all():
        raise AssertionError("[cli-campaign-a] non-finite energies")

    sp_part = _campaign_settings(camp, "settings.json", tmp, "a_part", total_sweeps=CLI_A_PART,
                                 checkpoint_interval=CLI_A_INTERVAL,
                                 run_folder=str(tmp / "a_part"))
    sp_res = _campaign_settings(camp, "settings.json", tmp, "a_resume",
                                total_sweeps=CLI_A_SWEEPS, checkpoint_interval=CLI_A_INTERVAL,
                                run_folder=str(tmp / "a_part"))
    wall_part = _timed_cli(main, ["--settings", str(sp_part), "--slab", str(cif)])
    wall_res = _timed_cli(main, ["--settings", str(sp_res), "--slab", str(cif), "--resume",
                                 str(tmp / "a_part")])
    res = _history(tmp / "a_part")
    same = (int(res["start_sweep"]) == CLI_A_PART
            and all(np.array_equal(res[k], full[k][:, CLI_A_PART:])
                    for k in ("energy", "site_state", "accept_rate")))
    if not same:
        raise AssertionError("[cli-campaign-a] the resumed run is not bitwise the tail of the "
                             "uninterrupted one")

    settings = load_settings(sp_full)
    slab = load_slab(cif)
    asys = assemble_system(settings, slab, device=dev)
    st, idx, _, extra, gen = load_checkpoint(tmp / "a_full" / "checkpoint.npz", dev)
    fresh = asys.run.state_energy_fn(st.site_state).surface_energy
    drift = float((fresh - st.energy).abs().max())
    del asys
    asys_cpu = assemble_system(load_settings(sp_full), slab, device="cpu")
    ss2 = torch.as_tensor(full["site_state"][:CLI_CPU_CHAINS, 0], dtype=torch.int64)
    e_cpu = asys_cpu.run.state_energy_fn(ss2).surface_energy.numpy()
    d_cpu = float(np.abs(e_cpu - full["energy"][:CLI_CPU_CHAINS, 0]).max())
    del asys_cpu
    artifacts = sorted(p.name for p in (tmp / "a_full").iterdir())
    best_cif = next((tmp / "a_full").glob("best_energy_*.cif"))
    n_chains = samp["n_chains"]
    print(f"[cli-campaign-a] {samp['run_folder']}: {n_chains} chains x {CLI_A_SWEEPS} sweeps x "
          f"{samp['sweep_size']} steps (incremental, {samp['criterion']}, t_min "
          f"{samp['t_min']}), chunks of {CLI_A_INTERVAL}: steps/s={n_chains * n_steps / mc_s:.1f} "
          f"(MC chunks {mc_s:.3f}s; CLI wall {wall:.2f}s) timing={json.dumps(timing)} "
          f"cli_split={json.dumps({k: round(v, 3) for k, v in cli_split.items()})} "
          f"accept={float(full['accept_rate'].mean()):.4f} n_ads={float(full['n_ads'].mean()):.3f} "
          f"best={float(full['energy'].min()):.6f} eV launches={json.dumps(launches)}")
    print(f"[cli-campaign-a] resume: {CLI_A_PART} sweeps ({wall_part:.2f}s) + --resume to "
          f"{CLI_A_SWEEPS} ({wall_res:.2f}s) bitwise the uninterrupted run's tail: {same}; "
          f"checkpoint sweep {idx} mode {str(extra['mode'])} generator on "
          f"{gen.device.type}: carried vs fresh full evaluation max |diff| {drift:.3e} eV (tol "
          f"{CLI_E_TOL}); first sweep of {CLI_CPU_CHAINS} chains card vs CPU max |diff| "
          f"{d_cpu:.3e} eV (tol {CLI_E_TOL}); artifacts {artifacts}")
    if not (drift <= CLI_E_TOL and d_cpu <= CLI_E_TOL):
        raise AssertionError(f"[cli-campaign-a] energies off: carried vs fresh {drift}, card vs "
                             f"CPU {d_cpu}")
    for name in ("stats.csv", "checkpoint.npz", "history.npz", "anneal_schedule.csv", "mc.log",
                 "settings.json"):
        if name not in artifacts:
            raise AssertionError(f"[cli-campaign-a] {name} not written")
    return launches, best_cif, sp_full


def cli_pourbaix_phase(dev, tmp) -> dict:
    """56. Campaign pourbaix_sriro (CHGNet, 222 slots, surface atoms
    sampled, 32 chains) through ``cli.sample_pourbaix_surface`` on the card,
    cut to CLI_POURBAIX_SWEEPS sweeps in chunks of CLI_POURBAIX_INTERVAL:
    row 10 four times an evaluation, a bitwise repeat of the whole run, the
    prefilled state's energy and the first sweep's energies of
    CLI_CPU_CHAINS chains card vs CPU. Returns the launch counts."""
    from pathlib import Path

    from surface_sampling_tpu_torch.cli.common import load_settings, load_slab
    from surface_sampling_tpu_torch.cli.sample_pourbaix_surface import (
        build_pourbaix_system,
        main,
    )

    camp = Path(__file__).resolve().parent / "campaigns" / "pourbaix_sriro"
    cif = camp / "SrIrO3_001_2x2.cif"
    paths = [_campaign_settings(camp, "settings.json", tmp, f"p{i}",
                                total_sweeps=CLI_POURBAIX_SWEEPS,
                                checkpoint_interval=CLI_POURBAIX_INTERVAL,
                                run_folder=str(tmp / f"p{i}")) for i in (1, 2)]
    samp = json.loads(paths[0].read_text())["sampling_settings"]
    reset_launch_counts()
    wall = _timed_cli(main, ["--settings", str(paths[0]), "--slab", str(cif)])
    launches = launch_counts()
    n_steps = CLI_POURBAIX_SWEEPS * samp["sweep_size"]
    _expect("cli-pourbaix", launches, {"chgnet_conv": 4 * (1 + n_steps)})
    wall2 = _timed_cli(main, ["--settings", str(paths[1]), "--slab", str(cif)])
    a, b = _history(tmp / "p1"), _history(tmp / "p2")
    same = all(np.array_equal(a[k], b[k]) for k in a)
    if not same:
        raise AssertionError("[cli-pourbaix] the CLI run does not repeat bitwise")
    timing = _run_timing(tmp / "p1")
    mc_s = timing.get("first_chunk", 0.0) + timing.get("mc_chunks", 0.0)
    slab = load_slab(cif)
    asys, ss0, _ = build_pourbaix_system(load_settings(paths[0]), slab, dev)
    asys_cpu, _, _ = build_pourbaix_system(load_settings(paths[0]), slab, "cpu")
    e0 = float(asys.run.state_energy_fn(torch.as_tensor(ss0[None], device=dev))
               .surface_energy[0])
    e0_cpu = float(asys_cpu.run.state_energy_fn(torch.as_tensor(ss0[None])).surface_energy[0])
    ss2 = torch.as_tensor(a["site_state"][:CLI_CPU_CHAINS, 0], dtype=torch.int64)
    e_cpu = asys_cpu.run.state_energy_fn(ss2).surface_energy.numpy()
    d_cpu = float(np.abs(e_cpu - a["energy"][:CLI_CPU_CHAINS, 0]).max())
    del asys, asys_cpu
    n_chains = samp["n_chains"]
    print(f"[cli-pourbaix] {n_chains} chains x {CLI_POURBAIX_SWEEPS} sweeps x "
          f"{samp['sweep_size']} steps ({samp['criterion']}, chunks of "
          f"{CLI_POURBAIX_INTERVAL}): evals/s={n_chains * n_steps / mc_s:.2f} (MC chunks "
          f"{mc_s:.3f}s; CLI wall {wall:.2f}s / {wall2:.2f}s) bitwise repeat {same} "
          f"timing={json.dumps(timing)}; prefilled state card {e0:.6f} eV vs CPU {e0_cpu:.6f} eV "
          f"([pourbaix-mc]'s library path, static table: {POURBAIX_PREFILLED_E}); first sweep "
          f"of {CLI_CPU_CHAINS} chains card vs CPU max |diff| {d_cpu:.3e} eV (tol {CLI_E_TOL}) "
          f"best={float(a['energy'].min()):.6f} eV launches="
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    if not (abs(e0 - e0_cpu) <= CLI_E_TOL and d_cpu <= CLI_E_TOL):
        raise AssertionError(f"[cli-pourbaix] card vs CPU off: prefilled {e0} / {e0_cpu}, "
                             f"first sweep {d_cpu}")
    return launches


def cli_predict_phase(dev, tmp, best_cif, settings_path) -> dict:
    """57. ``cli.predict`` on [cli-campaign-a]'s best CIF with the flagship
    ensemble (edges by image search), on the card and with --device cpu:
    energies within CLI_E_TOL, forces within CLI_F_TOL. Returns the card
    run's launch counts."""
    from surface_sampling_tpu_torch.cli.predict import main

    argv = ["--structures", str(best_cif), "--settings", str(settings_path)]
    reset_launch_counts()
    wall = _timed_cli(main, argv + ["--out", str(tmp / "pred_card.npz")])
    launches = launch_counts()
    wall_cpu = _timed_cli(main, argv + ["--out", str(tmp / "pred_cpu.npz"), "--device", "cpu"])
    card, cpu = np.load(tmp / "pred_card.npz"), np.load(tmp / "pred_cpu.npz")
    d_e = float(np.abs(card["energies"] - cpu["energies"]).max())
    d_f = float(np.abs(card["forces"] - cpu["forces"]).max())
    print(f"[cli-predict] {best_cif.name} ({int(card['n_atoms'][0])} atoms): card "
          f"{float(card['energies'][0]):.6f} eV std {float(card['energy_std'][0]):.6f} "
          f"({wall:.2f}s) vs CPU {float(cpu['energies'][0]):.6f} eV ({wall_cpu:.2f}s): |dE| "
          f"{d_e:.3e} eV (tol {CLI_E_TOL}), max |dF| {d_f:.3e} eV/A (tol {CLI_F_TOL}) "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}")
    if not (d_e <= CLI_E_TOL and d_f <= CLI_F_TOL):
        raise AssertionError(f"[cli-predict] card vs CPU: dE {d_e}, dF {d_f}")
    return launches


def cli_native_phase(tmp, best_cif) -> None:
    """58. ``runtime.native`` on the card machine: its g++ build loads from
    _build/, writes [cli-campaign-a]'s best structure in three frames byte
    for byte as the Python writer does, and its cell list counts what the
    numpy one counts."""
    from surface_sampling_tpu_torch.runtime import native
    from surface_sampling_tpu_torch.structure.io import read_cif

    t0 = time.perf_counter()
    lib = native.load_library()
    dt_build = time.perf_counter() - t0
    if lib is None:
        raise AssertionError("[cli-native] the surfkit library did not build or load")
    st = read_cif(best_cif)
    frames = np.stack([st.positions, st.positions + 0.125, st.positions - 1.0 / 3.0])
    native.write_xyz_frames(tmp / "n.xyz", st.numbers, frames, st.cell)
    native.write_xyz_frames_python(tmp / "p.xyz", st.numbers, frames, st.cell)
    same = (tmp / "n.xyz").read_bytes() == (tmp / "p.xyz").read_bytes()
    got = native.cell_list_neighbors(st.positions, st.cell, 5.0, 64)
    ref = native.cell_list_neighbors_numpy(st.positions, st.cell, 5.0, 64)
    counts = got[3] == ref[3] and np.array_equal(got[2], ref[2])
    print(f"[cli-native] {native.lib_path().name} built and loaded in {dt_build:.2f}s; "
          f"write_xyz_frames native == Python writer byte for byte "
          f"({(tmp / 'n.xyz').stat().st_size} bytes): {same}; cell list counts == numpy's "
          f"(max {got[3]}): {counts}")
    if not (same and counts):
        raise AssertionError("[cli-native] the native helpers disagree with the numpy ones")


def cli_ff_phase(dev, tmp) -> dict:
    """59. Campaign C's settings (settings_relaxed_ff.json: every move
    FIRE-relaxed by the frozen-far-field ball descent, 16 chains) through
    ``cli.sample_surface``, cut to CLI_FF_SWEEPS sweep of CLI_FF_SWEEP_SIZE
    steps. Campaign C accepts no move at these temperatures, so the carried
    state alone would only show the first evaluation: the phase records
    every trial the engine scores inside the CLI run (its relaxed geometry
    and the energy the acceptance test used) and holds each trial energy
    against a fresh full-cell evaluation of that geometry, and the first
    step's trials of CLI_FF_CPU_CHAINS chains against the CPU port's descent
    from the same inputs (CLI_FF_TOL); the checkpoint's energies against a
    fresh evaluation of the carried geometry too. Returns the launch
    counts."""
    from pathlib import Path

    from surface_sampling_tpu_torch.cli.common import assemble_system, load_settings, load_slab
    from surface_sampling_tpu_torch.cli.sample_surface import main
    from surface_sampling_tpu_torch.core import ff_relax
    from surface_sampling_tpu_torch.core.energy import identity_surface_energy
    from surface_sampling_tpu_torch.core.state import (
        element_counts,
        realize_alive,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.io import load_checkpoint

    camp = Path(__file__).resolve().parent / "campaigns" / "srtio3_2x2"
    cif = camp / "SrTiO3_001_2x2super.cif"
    sp = _campaign_settings(camp, "settings_relaxed_ff.json", tmp, "ff",
                            total_sweeps=CLI_FF_SWEEPS,
                            sweep_size=CLI_FF_SWEEP_SIZE, run_folder=str(tmp / "ff"))
    samp, calc = (json.loads(sp.read_text())[k] for k in ("sampling_settings", "calc_settings"))

    # record the trials of the engine run_sampling builds (semigrand: one
    # ball descent a move, evaluate.evaluate1); recording happens outside
    # the kernels' wrappers and adds no launch
    trials, built = [], {}
    make_eval = ff_relax.make_ff_relax_eval

    def recording_eval(*args, **kw):
        evaluate = make_eval(*args, **kw)
        built.update(kw)
        inner = evaluate.evaluate1

        def evaluate1(trial_ss, pos_prev, caches, site):
            st, new_caches = inner(trial_ss, pos_prev, caches, site)
            rec = {"ss": trial_ss.clone(), "pos": st.positions.clone(),
                   "se": st.surface_energy.clone(), "oob": st.oob.clone()}
            if not trials:
                k = CLI_FF_CPU_CHAINS
                rec["inputs"] = (trial_ss[:k].cpu(), pos_prev[:k].cpu(),
                                 tuple(c[:k].cpu() for c in caches), site[:k].cpu())
            trials.append(rec)
            return st, new_caches

        evaluate.evaluate1 = evaluate1
        return evaluate

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ff_relax.make_ff_relax_eval = recording_eval
    try:
        wall = _timed_cli(main, ["--settings", str(sp), "--slab", str(cif)])
    finally:
        ff_relax.make_ff_relax_eval = make_eval
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    timing = _run_timing(tmp / "ff")
    mc_s = timing.get("first_chunk", 0.0) + timing.get("mc_chunks", 0.0)
    hist = _history(tmp / "ff")
    n_moves = samp["n_chains"] * CLI_FF_SWEEPS * samp["sweep_size"]
    if len(trials) != CLI_FF_SWEEPS * samp["sweep_size"]:
        raise AssertionError(f"[cli-ff] the FF engine scored {len(trials)} steps, expected "
                             f"{CLI_FF_SWEEPS * samp['sweep_size']}")

    t_check = time.perf_counter()
    asys = assemble_system(load_settings(sp), load_slab(cif), device=dev)
    d = asys.run.d
    sfn = asys.run.surface_energy_fn or identity_surface_energy

    def fresh(ss, pos):
        with torch.no_grad():
            e_pot = asys.potential.energy(pos, realize_type_idx(d, ss), realize_alive(d, ss),
                                          d.shifts)
            return sfn(e_pot, element_counts(d, ss))

    # a trial out of bounds carries the bound, not its energy
    d_trial = max(float(torch.where(t["oob"], 0.0, fresh(t["ss"], t["pos"]) - t["se"])
                        .abs().max()) for t in trials)
    n_oob = sum(int(t["oob"].sum()) for t in trials)
    st, idx, _, _, _ = load_checkpoint(tmp / "ff" / "checkpoint.npz", dev)
    drift = float((fresh(st.site_state, st.relaxed_positions) - st.energy).abs().max())
    moved = float((trials[0]["pos"][:CLI_FF_CPU_CHAINS].cpu()
                   - trials[0]["inputs"][1]).abs().max())
    del asys

    t_cpu = time.perf_counter()
    asys_cpu = assemble_system(load_settings(sp), load_slab(cif), device="cpu")
    ev_cpu = make_eval(asys_cpu.run.d, asys_cpu.potential,
                       surface_energy_fn=asys_cpu.run.surface_energy_fn, relax=built["relax"],
                       tables=built["tables"], seat_tables=built["seat_tables"])
    st_cpu, _ = ev_cpu.evaluate1(*trials[0]["inputs"])
    d_cpu = float((st_cpu.surface_energy - trials[0]["se"][:CLI_FF_CPU_CHAINS].cpu())
                  .abs().max())
    del asys_cpu, ev_cpu
    t_end = time.perf_counter()
    print(f"[cli-ff] {samp['n_chains']} chains x {CLI_FF_SWEEPS} x {samp['sweep_size']} FF moves "
          f"(relax_steps {calc['relax_steps']}, hops {calc['relax_ball_hops']}): moves/s="
          f"{n_moves / mc_s:.2f} (MC {mc_s:.3f}s; CLI wall {wall:.2f}s) timing={json.dumps(timing)} peak_mem={peak:.3f} GB accept="
          f"{float(hist['accept_rate'].mean()):.4f}; {n_moves} trial energies ({n_oob} out of "
          f"bounds) vs a fresh full-cell evaluation of their relaxed geometry max |diff| "
          f"{d_trial:.3e} eV; first step's trials of {CLI_FF_CPU_CHAINS} chains card vs CPU "
          f"descent max |diff| {d_cpu:.3e} eV (ball moved up to {moved:.3e} A); checkpoint sweep {idx}: "
          f"carried energies vs a fresh evaluation max |diff| {drift:.3e} eV (tol {CLI_FF_TOL}); "
          f"checks {t_end - t_check:.2f}s (CPU {t_end - t_cpu:.2f}s) "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}")
    if not (d_trial <= CLI_FF_TOL and d_cpu <= CLI_FF_TOL and drift <= CLI_FF_TOL
            and moved > 0.0 and np.isfinite(hist["energy"]).all()):
        raise AssertionError(f"[cli-ff] energies off: trials vs fresh {d_trial} eV, card vs CPU "
                             f"{d_cpu} eV, carried vs fresh {drift} eV, ball moved {moved} A")
    return launches


def slice18_phases(dev) -> dict:
    """Phases 55-59 in a temporary folder; returns the launch counts of
    their paths."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cli_smoke_") as tmp_name:
        tmp = Path(tmp_name)
        paths = {}
        paths["cli_campaign_a"], best_cif, sp_a = cli_campaign_a_phase(dev, tmp)
        torch.cuda.empty_cache()
        paths["cli_pourbaix"] = cli_pourbaix_phase(dev, tmp)
        torch.cuda.empty_cache()
        paths["cli_predict"] = cli_predict_phase(dev, tmp, best_cif, sp_a)
        cli_native_phase(tmp, best_cif)
        torch.cuda.empty_cache()
        paths["cli_ff"] = cli_ff_phase(dev, tmp)
        torch.cuda.empty_cache()
    print(f"[cli-time] phases 55-59 {time.perf_counter() - t0:.1f}s")
    return paths


# ----------------------------------------------------------------------
# Post-processing on the card: clustering, uncertainty, the structure
# tools, examples 04 / 05 / 07 / 08 (slice 19)
# ----------------------------------------------------------------------
CLUSTER_EVERY = 100                        # campaign A's history, every 100th sweep
CLUSTER_MAXCLUST = 8
CLUSTER_CPU_STRUCTS = 4
EMB_RTOL = 1e-4                            # embeddings card vs CPU, x max|cpu|
UNC_COMPONENTS, UNC_CHUNK = 8, 4096
UNC_SUBSET = 20_000                        # rows of the card vs CPU EM fit
EM_LL_RTOL = 1e-4
UNC_FORCE_STATES, UNC_FORCE_CPU_STATES = 32, 1   # a state's CPU forces take seconds
PERTURB_N, PERTURB_AMPLITUDE = 4, 0.05
FORM_RELAX_STEPS = 5                       # the CPU port relaxes the CHGNet slab too
FORM_RELAX_TOL = 5e-3
EX04_SWEEPS, EX04_SWEEP_SIZE = 8, 4
EX07_SWEEPS, EX07_SWEEP_SIZE = 10, 10
EX08_ROUNDS, EX08_EPOCHS, EX08_SEED_FRAMES = 2, 40, 16


@contextlib.contextmanager
def _recording(cls, name: str, keep):
    """While the block runs, ``keep(result)`` is called on the result of every
    call of method / function ``name`` of ``cls`` (a class or a module);
    yields the list of what ``keep`` returned."""
    saved, kept = getattr(cls, name), []

    def call(*args, **kw):
        out = saved(*args, **kw)
        kept.append(keep(out))
        return out

    setattr(cls, name, call)
    try:
        yield kept
    finally:
        setattr(cls, name, saved)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def campaign_a_structures(dev, tmp):
    """Campaign A's recorded site states (history.npz: 32 chains x 1800
    sweeps on the 2x2 super-slab), every CLUSTER_EVERY-th sweep, realized
    through ``cli.common.assemble_system`` on the campaign's settings file
    and written with ``save_structures_npz`` (their atom counts differ: the
    ragged layout). Returns (the structures as read back, their site states,
    the file, the assembled system)."""
    from pathlib import Path

    from surface_sampling_tpu_torch.cli.common import assemble_system, load_settings, load_slab
    from surface_sampling_tpu_torch.core.state import realize_numbers, realize_positions
    from surface_sampling_tpu_torch.structure import Structure
    from surface_sampling_tpu_torch.structure.io import load_structures_npz, save_structures_npz

    camp = Path(__file__).resolve().parent / "campaigns" / "srtio3_2x2"
    with np.load(camp / "srtio3_2x2_campaign" / "history.npz") as h:
        ss = h["site_state"][:, ::CLUSTER_EVERY]
    ss = ss.reshape(-1, ss.shape[-1])
    asys = assemble_system(load_settings(camp / "settings.json"),
                           load_slab(camp / "SrTiO3_001_2x2super.cif"), device=dev)
    if asys.spec.n_sites != ss.shape[1]:
        raise AssertionError(f"[cluster-cli] the assembled spec has {asys.spec.n_sites} sites, "
                             f"the history {ss.shape[1]}")
    d = asys.run.d
    sst = torch.as_tensor(ss, dtype=torch.int64, device=d.device)
    numbers = realize_numbers(d, sst).cpu().numpy()
    pos = realize_positions(d, sst).cpu().numpy()
    path = tmp / "campaign_a_states.npz"
    save_structures_npz(path, [Structure(z[z > 0], p[z > 0], asys.spec.cell)
                               for z, p in zip(numbers, pos)])
    return load_structures_npz(path)[0], ss, path, asys


def cluster_cli_phase(dev, tmp) -> tuple[dict, dict]:
    """60. ``cli.clustering`` on campaign A's sampled states with the
    flagship ensemble (image search, one structure a call): --metric energy
    then --metric gmm, maxclust CLUSTER_MAXCLUST. The two runs' embeddings
    and labels bitwise equal (a repeat), one representative a cluster, the
    EM fit refit bitwise, CLUSTER_CPU_STRUCTS structures' embeddings and
    energies card vs the CPU port. Returns the first run's launch counts and
    what [uncertainty] reuses (per-atom embeddings, states, the system)."""
    from pathlib import Path

    from surface_sampling_tpu_torch.analysis import uncertainty
    from surface_sampling_tpu_torch.cli import clustering
    from surface_sampling_tpu_torch.cli.common import load_calc_settings
    from surface_sampling_tpu_torch.models import nn_calculator
    from surface_sampling_tpu_torch.models.nn_calculator import UNIT_FACTORS

    t0 = time.perf_counter()
    structures, states, path, asys = campaign_a_structures(dev, tmp)
    t_build = time.perf_counter() - t0
    camp = Path(__file__).resolve().parent / "campaigns" / "srtio3_2x2"
    sp = camp / "settings.json"
    argv = ["--structures", str(path), "--settings", str(sp), "--criterion", "maxclust",
            "--cutoff", str(CLUSTER_MAXCLUST), "--device", dev.type]
    n = len(structures)
    reset_launch_counts()
    with _recording(nn_calculator.PaiNNPotential, "outputs",
                    lambda out: out["embedding"][0].detach()) as per_atom, \
            _timed_calls(clustering, ("compute_embeddings_and_metric",)) as t_e:
        wall_e = _timed_cli(clustering.main, argv + ["--metric", "energy", "--out",
                                                     str(tmp / "clust_energy")])
    launches = launch_counts()
    with _recording(uncertainty, "fit_gmm_em", lambda out: out) as fits, \
            _timed_calls(clustering, ("compute_embeddings_and_metric",)) as t_g:
        wall_g = _timed_cli(clustering.main, argv + ["--metric", "gmm", "--out",
                                                     str(tmp / "clust_gmm")])
    de, dg = np.load(tmp / "clust_energy" / "clustering.npz"), \
        np.load(tmp / "clust_gmm" / "clustering.npz")
    same = (np.array_equal(de["embeddings"], dg["embeddings"])
            and np.array_equal(de["labels"], dg["labels"]))
    labels = de["labels"]
    one_each = all(len(d["selected"]) == len(np.unique(labels))
                   and np.array_equal(np.sort(labels[d["selected"]]), np.unique(labels))
                   for d in (de, dg))
    params, info = uncertainty.fit_gmm_em(torch.as_tensor(dg["embeddings"], device=dev),
                                          min(8, n), return_info=True)
    em_same = len(fits) == 1 and all(np.array_equal(params[k], fits[0][k]) for k in params)

    calc = load_calc_settings(sp)
    emb_cpu, e_cpu = clustering.compute_embeddings_and_metric(
        structures[:CLUSTER_CPU_STRUCTS], calc, "energy", "cpu")
    d_emb = float(np.abs(de["embeddings"][:CLUSTER_CPU_STRUCTS] - emb_cpu).max())
    scale = float(np.abs(emb_cpu).max())
    d_e = float(np.abs(de["metrics"][:CLUSTER_CPU_STRUCTS] - e_cpu).max()) \
        * UNIT_FACTORS[calc.get("model_units", "kcal/mol")]
    n_atoms = sum(len(s) for s in structures)
    print(f"[cluster-cli] campaign A history every {CLUSTER_EVERY}th sweep: {n} states "
          f"({n_atoms} atoms, sizes {min(map(len, structures))}-{max(map(len, structures))}; "
          f"assemble + realize + write "
          f"{t_build:.2f}s); embedding pass {n / t_e['compute_embeddings_and_metric']:.1f} "
          f"structures/s (energy run, {t_e['compute_embeddings_and_metric']:.2f}s of a "
          f"{wall_e:.2f}s CLI) / {n / t_g['compute_embeddings_and_metric']:.1f} (gmm run, "
          f"{wall_g:.2f}s CLI); row-2 launches {launches.get('painn_message_fused', 0)} "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}")
    print(f"[cluster-cli] {len(np.unique(labels))} clusters (sizes "
          f"{np.bincount(labels)[1:].tolist()}); selected by energy {de['selected'].tolist()}, "
          f"by gmm {dg['selected'].tolist()}; EM {info['n_iter']} iterations, final mean "
          f"log-likelihood {info['mean_log_likelihood']:.6f}; repeat bitwise (embeddings, "
          f"labels) {same}, EM refit bitwise {em_same}; one representative a cluster "
          f"{one_each}; {CLUSTER_CPU_STRUCTS} structures card vs CPU: embeddings max |diff| "
          f"{d_emb:.3e} (tol {EMB_RTOL} x {scale:.3f}), energies {d_e:.3e} eV (tol "
          f"{CLI_E_TOL})")
    if not (same and one_each and em_same and d_emb <= EMB_RTOL * scale and d_e <= CLI_E_TOL
            and np.isfinite(dg["metrics"]).all() and len(per_atom) == n):
        raise AssertionError("[cluster-cli] a check failed")
    return launches, {"per_atom": per_atom, "states": states, "asys": asys}


def uncertainty_phase(dev, reuse) -> dict:
    """61. ``fit_gmm_em`` on every per-atom embedding of [cluster-cli]'s
    states (~2e5 rows x 128, chunk UNC_CHUNK, UNC_COMPONENTS components):
    time, iterations, peak memory, a bitwise refit, the card vs the CPU
    port's fit on UNC_SUBSET rows (mean log-likelihood, EM_LL_RTOL
    relative), the system_mean NLL of every structure through
    ``GMMUncertainty.log_prob``; ``ensemble_forces_std`` on UNC_FORCE_STATES
    states (rows 2, 4) scored by ``EnsembleUncertainty``, the first
    UNC_FORCE_CPU_STATES of them card vs CPU (1e-3 eV/A). Returns the
    forces pass's launch counts."""
    from surface_sampling_tpu_torch.analysis import (
        EnsembleUncertainty,
        GMMUncertainty,
        fit_gmm_em,
        reduce_order,
    )
    from surface_sampling_tpu_torch.core.state import realize_numbers, realize_positions
    from surface_sampling_tpu_torch.models.ensemble import ensemble_forces_std
    from surface_sampling_tpu_torch.models.painn import tree_map

    X = torch.cat(reuse["per_atom"])
    counts = [len(x) for x in reuse["per_atom"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    params, info = fit_gmm_em(X, UNC_COMPONENTS, chunk=UNC_CHUNK, return_info=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9 if dev.type == "cuda" else 0.0
    t0 = time.perf_counter()
    again = fit_gmm_em(X, UNC_COMPONENTS, chunk=UNC_CHUNK)
    torch.cuda.synchronize()
    dt_again = time.perf_counter() - t0
    same = all(np.array_equal(params[k], again[k]) for k in params)
    gu = GMMUncertainty(n_components=UNC_COMPONENTS, order="system_mean", gmm_params=params)
    t0 = time.perf_counter()
    nll = -gu.log_prob(X)
    per_struct = torch.stack([reduce_order(s, "system_mean") for s in nll.split(counts)])
    torch.cuda.synchronize()
    dt_score = time.perf_counter() - t0

    rows = np.sort(np.random.default_rng(0).choice(len(X), UNC_SUBSET, replace=False))
    sub = X[torch.as_tensor(rows, device=X.device)]
    p_card = fit_gmm_em(sub, UNC_COMPONENTS, chunk=UNC_CHUNK)
    t0 = time.perf_counter()
    p_cpu = fit_gmm_em(sub.cpu(), UNC_COMPONENTS, chunk=UNC_CHUNK)
    dt_cpu = time.perf_counter() - t0
    ll = [float(GMMUncertainty(n_components=UNC_COMPONENTS, gmm_params=p).log_prob(sub.cpu())
                .mean()) for p in (p_card, p_cpu)]
    d_ll = abs(ll[0] - ll[1]) / abs(ll[1])

    asys = reuse["asys"]
    pot, d = asys.potential, asys.run.d
    ss = torch.as_tensor(reuse["states"][:UNC_FORCE_STATES], dtype=torch.int64, device=dev)
    numbers, pos = realize_numbers(d, ss), realize_positions(d, ss)
    shifts = torch.as_tensor(asys.spec.shifts, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    fstd = ensemble_forces_std(pot.params, pot.cfg, pos, numbers, numbers > 0, shifts) * pot.factor
    torch.cuda.synchronize()
    dt_f = time.perf_counter() - t0
    launches = launch_counts()
    u = EnsembleUncertainty(order="system_mean", quantity="forces")
    u_f = torch.stack([u.get_uncertainty(forces_std=fstd[i][numbers[i] > 0])
                       for i in range(len(ss))])
    k = UNC_FORCE_CPU_STATES
    fstd_cpu = ensemble_forces_std(tree_map(lambda x: x.cpu(), pot.params), pot.cfg,
                                   pos[:k].cpu(), numbers[:k].cpu(), numbers[:k].cpu() > 0,
                                   shifts.cpu()) * pot.factor
    d_f = float((fstd[:k].cpu() - fstd_cpu).abs().max())
    print(f"[uncertainty] EM on {len(X)} per-atom embeddings x {X.shape[1]} (float64 pass, chunk "
          f"{UNC_CHUNK}, {UNC_COMPONENTS} components): {dt:.3f}s, {info['n_iter']} iterations, "
          f"final mean log-likelihood {info['mean_log_likelihood']:.6f}, peak "
          f"{peak:.3f} GB above the embeddings; refit ({dt_again:.3f}s) bitwise {same}; "
          f"system_mean NLL of "
          f"{len(counts)} structures in {dt_score:.3f}s: min {float(per_struct.min()):.4f} mean "
          f"{float(per_struct.mean()):.4f} max {float(per_struct.max()):.4f}; {UNC_SUBSET} rows "
          f"card vs CPU port fit (CPU {dt_cpu:.2f}s): mean log-likelihood {ll[0]:.6f} / "
          f"{ll[1]:.6f}, rel diff {d_ll:.3e} (tol {EM_LL_RTOL})")
    print(f"[uncertainty] ensemble_forces_std of {len(ss)} states ({dt_f:.3f}s): forces "
          f"EnsembleUncertainty(system_mean) min {float(u_f.min()):.4f} max "
          f"{float(u_f.max()):.4f} eV/A; first {k} card vs CPU max |diff| {d_f:.3e} eV/A (tol "
          f"{CLI_F_TOL}) launches={json.dumps({k: v for k, v in launches.items() if v})}")
    if not (same and d_ll <= EM_LL_RTOL and d_f <= CLI_F_TOL
            and torch.isfinite(per_struct).all() and torch.isfinite(u_f).all()):
        raise AssertionError("[uncertainty] a check failed")
    return launches


def structure_tools_phase(dev, tmp) -> dict:
    """62. The structure tools: cut_surfaces on the SrTiO3 bulk,
    filter_stoichiometries and perturb_structures --settings (the flagship,
    on the card and the CPU: positions equal, energies 1e-3 eV) on campaign
    A's best CIF; create_surface_formation_entries on the Pourbaix campaign's
    slab with its CHGNet settings, plain and with --relax (FORM_RELAX_STEPS
    steps) --mp2020 --aqueous --oh-correction: energies card vs CPU 1e-3 eV
    (relaxed 5e-3), corrections equal. Returns the card runs' launch
    counts."""
    from pathlib import Path

    from surface_sampling_tpu_torch.cli import (
        create_surface_formation_entries,
        cut_surfaces,
        filter_stoichiometries,
        perturb_structures,
    )
    from surface_sampling_tpu_torch.structure import bulk, surface_from_bulk
    from surface_sampling_tpu_torch.structure.io import load_structures_npz, read_cif, write_cif

    repo = Path(__file__).resolve().parent
    camp_a = repo / "campaigns" / "srtio3_2x2"
    best = sorted((camp_a / "srtio3_2x2_campaign").glob("best_energy_*.cif"))[0]
    sto = bulk(["Sr", "Ti", "O"], "perovskite", a=3.905)
    write_cif(tmp / "sto_bulk.cif", sto)
    _timed_cli(cut_surfaces.main, ["--bulk", str(tmp / "sto_bulk.cif"), "--miller", "0", "0", "1",
                                   "--size", "2", "2", "--layers", "4", "--out",
                                   str(tmp / "slabs")])
    cut = [read_cif(p) for p in sorted((tmp / "slabs").glob("*.cif"))]
    slab, _ = surface_from_bulk(sto, (0, 0, 1), size=(2, 2), layers=4, vacuum=15.0)
    cut_ok = len(cut) == 1 and len(cut[0]) == len(slab)

    st = read_cif(best)
    n_o = st.symbols.count("O")
    kept = []
    for lo, hi in ((n_o, n_o), (0, n_o - 1)):
        _timed_cli(filter_stoichiometries.main, ["--structures", str(best), "--ranges",
                                                 json.dumps({"O": [lo, hi]}), "--out",
                                                 str(tmp / "filtered.npz")])
        kept.append(len(load_structures_npz(tmp / "filtered.npz")[0]))

    argv = ["--structures", str(best), "--settings", str(camp_a / "settings.json"),
            "--n-perturb", str(PERTURB_N), "--amplitude", str(PERTURB_AMPLITUDE)]
    reset_launch_counts()
    wall_p = _timed_cli(perturb_structures.main,
                        argv + ["--out", str(tmp / "pert_card"), "--device", dev.type])
    launches_p = launch_counts()
    _timed_cli(perturb_structures.main, argv + ["--out", str(tmp / "pert_cpu"), "--device", "cpu"])
    (pc, ec), (pp, ep) = (load_structures_npz(tmp / f"pert_{w}" / "perturbed.npz")
                          for w in ("card", "cpu"))
    pos_same = all(np.array_equal(a.positions, b.positions) for a, b in zip(pc, pp))
    d_pert = float(np.abs(ec - ep).max())

    camp_p = repo / "campaigns" / "pourbaix_sriro"
    base = ["--structures", str(camp_p / "SrIrO3_001_2x2.cif"), "--settings",
            str(camp_p / "settings.json"), "--phase-diagram",
            str(repo / "tests" / "data" / "pourbaix" / "pd_dict.json")]
    relax = ["--relax", "--relax-steps", str(FORM_RELAX_STEPS), "--mp2020", "--aqueous",
             "--oh-correction"]
    entries, launches_f, walls = {}, {}, {}
    for tag, flags in (("plain", []), ("relax", relax)):
        for where in (dev.type, "cpu"):
            out = tmp / f"entries_{tag}_{where}.json"
            reset_launch_counts()
            walls[tag, where] = _timed_cli(create_surface_formation_entries.main,
                                           base + flags + ["--out", str(out), "--device", where])
            if where == dev.type:
                for k, v in launch_counts().items():
                    launches_f[k] = launches_f.get(k, 0) + v
            entries[tag, where] = json.loads(out.read_text())[0]
    d_plain = abs(entries["plain", dev.type]["energy"] - entries["plain", "cpu"]["energy"])
    d_relax = abs(entries["relax", dev.type]["energy"] - entries["relax", "cpu"]["energy"])
    corr_same = all(entries[t, dev.type]["corrections"] == entries[t, "cpu"]["corrections"]
                    and entries[t, dev.type]["parameters"] == entries[t, "cpu"]["parameters"]
                    for t in ("plain", "relax"))
    rel = entries["relax", dev.type]
    launches = {k: launches_p.get(k, 0) + launches_f.get(k, 0)
                for k in set(launches_p) | set(launches_f)}
    print(f"[structure-tools] cut_surfaces SrTiO3 (001) 2x2x4: {len(cut)} CIF of "
          f"{len(cut[0]) if cut else 0} atoms (direct cut {len(slab)}); filter_stoichiometries "
          f"on {best.name} ({len(st)} atoms, {n_o} O): kept {kept} of [1, 0] expected; "
          f"perturb_structures x {PERTURB_N} with the flagship ({wall_p:.2f}s on the card): "
          f"positions card == CPU {pos_same}, energies max |diff| {d_pert:.3e} eV (tol "
          f"{CLI_E_TOL}), launches={json.dumps({k: v for k, v in launches_p.items() if v})}")
    print(f"[structure-tools] formation entries of SrIrO3_001_2x2 (CHGNet, "
          f"{rel['composition']}): plain card {entries['plain', dev.type]['energy']:.6f} vs CPU "
          f"{entries['plain', 'cpu']['energy']:.6f} eV (|diff| {d_plain:.3e}, tol {CLI_E_TOL}; "
          f"{walls['plain', dev.type]:.2f}s / {walls['plain', 'cpu']:.2f}s); --relax "
          f"{FORM_RELAX_STEPS} steps --mp2020 --aqueous --oh-correction card "
          f"{rel['energy']:.6f} vs CPU {entries['relax', 'cpu']['energy']:.6f} eV (|diff| "
          f"{d_relax:.3e}, tol {FORM_RELAX_TOL}; {walls['relax', dev.type]:.2f}s / "
          f"{walls['relax', 'cpu']:.2f}s), formation energy {rel['formation_energy']:.6f} eV, "
          f"corrections {[(c['label'], round(c['value'], 6)) for c in rel['corrections']]} "
          f"equal on both: {corr_same}; launches="
          f"{json.dumps({k: v for k, v in launches_f.items() if v})}")
    if not (cut_ok and kept == [1, 0] and pos_same and d_pert <= CLI_E_TOL
            and d_plain <= CLI_E_TOL and d_relax <= FORM_RELAX_TOL and corr_same):
        raise AssertionError("[structure-tools] a check failed")
    return launches


def ex04_phase(dev) -> dict:
    """63. Example 04: the flagship 1x1, rigid, 8 sweeps of 4 steps at T = 1,
    one chain; every recorded state embedded over its alive atoms (the
    general trunk over the static table), PCA + Ward maxclust 3, the
    lowest-energy member of each cluster; a bitwise repeat. Returns the
    launch counts of one run and its embedding."""
    from surface_sampling_tpu_torch.analysis import perform_clustering, select_representatives
    from surface_sampling_tpu_torch.core.engine import EngineConfig
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    sys_ = srtio3_001_painn(device=dev)
    d = sys_.run.d

    def once():
        _, rec = sys_.run.run(0, np.repeat(1.0, EX04_SWEEPS),
                              cfg=EngineConfig(sweep_size=EX04_SWEEP_SIZE,
                                               record_positions=False))
        ss = rec.site_state[0]
        alive = realize_alive(d, ss)
        with torch.no_grad():
            out = sys_.potential.outputs(realize_positions(d, ss), realize_type_idx(d, ss), alive)
        embs = torch.stack([out["embedding"][i][alive[i]].mean(dim=0) for i in range(len(ss))])
        labels = perform_clustering(embs, clustering_cutoff=3, cutoff_criterion="maxclust")
        picks = select_representatives(labels, -out["energy"], metric="energy")
        return ss, embs, out["energy"], labels, picks

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    a = once()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    b = once()
    same = all(np.array_equal(_host(x), _host(y)) for x, y in zip(a, b))
    ss, embs, energies, labels, picks = a
    print(f"[ex04] flagship 1x1 rigid, {EX04_SWEEPS} sweeps x {EX04_SWEEP_SIZE} steps at T = 1: "
          f"{len(ss)} states -> {len(np.unique(labels))} clusters, selected sweeps "
          f"{picks.tolist()} (energies {[round(float(x), 4) for x in _host(energies)[picks]]} "
          f"kcal/mol); run + "
          f"embedding {dt:.3f}s; bitwise repeat {same}; "
          f"launches={json.dumps({k: v for k, v in launches.items() if v})}")
    if not (same and len(picks) == len(np.unique(labels)) <= 3
            and torch.isfinite(embs).all()):
        raise AssertionError("[ex04] a check failed")
    return launches


def ex05_phase(tmp) -> None:
    """64. Example 05 (host only): SrTiO3 bulk, its 2x2x4 (001) slab, the
    slab's sites, the CIF, the SupercellSurfaceGenerator 2x2 slab; a repeat
    equal."""
    from surface_sampling_tpu_torch.structure import (
        SupercellSurfaceGenerator,
        bulk,
        find_adsorption_sites,
        surface_from_bulk,
    )
    from surface_sampling_tpu_torch.structure.io import write_cif

    def once(i):
        sto = bulk(["Sr", "Ti", "O"], "perovskite", a=3.905)
        slab, mask = surface_from_bulk(sto, (0, 0, 1), size=(2, 2), layers=4, vacuum=12.0)
        sites = find_adsorption_sites(slab, planar_distance=1.5)
        write_cif(tmp / f"SrTiO3_001_slab_{i}.cif", slab)
        sc = SupercellSurfaceGenerator(sto, (0, 0, 1), min_slab_layers=3).get_supercell_slab(
            2.0, 2.0, rotation=0.0)
        return slab, mask, sites, sc

    t0 = time.perf_counter()
    slab, mask, sites, sc = once(0)
    dt = time.perf_counter() - t0
    slab2, mask2, sites2, sc2 = once(1)
    same = (np.array_equal(slab.positions, slab2.positions) and np.array_equal(mask, mask2)
            and all(np.array_equal(sites[f], sites2[f]) for f in sites)
            and np.array_equal(sc.positions, sc2.positions)
            and (tmp / "SrTiO3_001_slab_0.cif").read_text()
            == (tmp / "SrTiO3_001_slab_1.cif").read_text())
    print(f"[ex05] slab {slab.formula}, {len(slab)} atoms, {int(mask.sum())} surface atoms; "
          f"sites {({f: len(sites[f]) for f in ('ontop', 'bridge', 'hollow')})}; supercell slab "
          f"{sc.formula}, {len(sc)} atoms; {dt:.3f}s on the host; repeat equal {same}")
    if not (same and len(sc) > 0 and len(slab) > 0):
        raise AssertionError("[ex05] a check failed")


def ex07_phase(dev) -> dict:
    """65. Example 07: the Sr-Ir-O Pourbaix atoms (tests/data/pourbaix) at pH
    7, 0.5 V; the toy IrO2 slab with Lennard-Jones, the grand-potential hook,
    EX07_SWEEPS sweeps of EX07_SWEEP_SIZE on the geometric ladder from 0.2;
    a prefilled state's surface energy card vs CPU (1e-3 eV); a bitwise
    repeat. Returns the launch counts (Lennard-Jones: none)."""
    from pathlib import Path

    from surface_sampling_tpu_torch.core.engine import EngineConfig, MCMCRun, geometric_schedule
    from surface_sampling_tpu_torch.core.spec import make_spec
    from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones
    from surface_sampling_tpu_torch.pourbaix import (
        generate_pourbaix_atoms,
        make_pourbaix_surface_energy,
    )
    from surface_sampling_tpu_torch.structure import Structure, find_adsorption_sites

    data = Path(__file__).resolve().parent / "tests" / "data" / "pourbaix"
    pH, phi = 7.0, 0.5
    atoms = generate_pourbaix_atoms(str(data / "pd_dict.json"), str(data / "pbx_dict.json"),
                                    phi, pH, ("Sr", "Ir", "O"))
    slab = Structure.from_symbols(
        ["Ir"] * 4 + ["O"] * 4,
        [[0, 0, 5], [2.3, 0, 5], [0, 2.3, 5], [2.3, 2.3, 5],
         [1.15, 0, 6.3], [0, 1.15, 6.3], [2.3, 1.15, 6.3], [1.15, 2.3, 6.3]],
        np.diag([4.6, 4.6, 22.0]))
    sites = find_adsorption_sites(slab, planar_distance=1.6)["all"]
    spec = make_spec(slab, sites, ["O", "H", "HO", "H2O"], potential_numbers=[77, 8, 1],
                     cutoff=4.5, surface_name="IrO2_toy")
    pot = make_lennard_jones(epsilon=2.0, sigma=1.9, cutoff=4.5)
    runs = {}
    for where in (dev, torch.device("cpu")):
        se_fn = make_pourbaix_surface_energy(spec, atoms, phi=phi, pH=pH,
                                             adsorbate_corrections={"OH": 0.23 - 0.30},
                                             device=where)
        runs[where.type] = MCMCRun(spec, pot, surface_energy_fn=se_fn, device=where)
    prefilled = np.random.default_rng(0).integers(0, spec.n_codes, (4, spec.n_sites))
    e_pre = {w: r.state_energy_fn(torch.as_tensor(prefilled, device=r.d.device))
             .surface_energy.cpu().numpy() for w, r in runs.items()}
    d_pre = float(np.abs(e_pre[dev.type] - e_pre["cpu"]).max())
    temps = geometric_schedule(0.2, EX07_SWEEPS, alpha=0.9)
    run = runs[dev.type]
    cfg = EngineConfig(sweep_size=EX07_SWEEP_SIZE)
    reset_launch_counts()
    t0 = time.perf_counter()
    _, rec = run.run(0, temps, cfg=cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    _, rec2 = run.run(0, temps, cfg=cfg)
    same = _bitwise(rec, rec2)
    e = _host(rec.energy)[0]
    print(f"[ex07] Pourbaix atoms at pH {pH}, {phi} V: "
          f"{ {k: round(float(a.atom_std_state_energy), 6) for k, a in atoms.items()} }; toy "
          f"IrO2 slab, {spec.n_sites} sites, LJ: {EX07_SWEEPS} sweeps x {EX07_SWEEP_SIZE} in "
          f"{dt:.3f}s, grand potential per sweep {[round(float(x), 3) for x in e]}, best "
          f"{e.min():.3f} eV, "
          f"occupied sites {int(_host(rec.n_ads)[0, -1])}; 4 prefilled states card vs CPU max "
          f"|diff| {d_pre:.3e} eV (tol {CLI_E_TOL}); bitwise repeat {same}")
    if not (same and d_pre <= CLI_E_TOL and np.isfinite(e).all()):
        raise AssertionError("[ex07] a check failed")
    return launches


def ex08_phase(dev) -> dict:
    """66. Example 08's active-learning loop at its widths (PaiNN F = 16, 8
    RBFs, 2 layers, 2 members; Cu(100) 3x3x2 on-top sites; 16 seed frames
    labelled by Lennard-Jones; EX08_ROUNDS rounds of EX08_EPOCHS epochs):
    each round trains, samples 8 sweeps of 6 steps, embeds every recorded
    state, clusters (maxclust 3), labels the most uncertain member of each
    cluster and grows the dataset. The loss falls in every round, the
    dataset grows by the number of clusters, a repeat is bitwise. Returns
    the launch counts of one loop."""
    from surface_sampling_tpu_torch.analysis import perform_clustering, select_representatives
    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        MCMCRun,
        geometric_schedule,
        make_generator,
    )
    from surface_sampling_tpu_torch.core.spec import make_spec
    from surface_sampling_tpu_torch.core.state import device_spec, realize_alive, realize_positions
    from surface_sampling_tpu_torch.models.ensemble import ensemble_apply
    from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
    from surface_sampling_tpu_torch.models.painn import PaiNNConfig, init_ensemble, tree_leaves
    from surface_sampling_tpu_torch.models.train import TrainConfig, pad_structures, train_painn
    from surface_sampling_tpu_torch.ops.neighbors import image_search_edges
    from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones
    from surface_sampling_tpu_torch.structure import Structure, fcc100, find_adsorption_sites

    truth = make_lennard_jones(epsilon=0.4, sigma=2.3, cutoff=5.0)
    slab = fcc100("Cu", size=(3, 3, 2), a=3.6147, vacuum=10.0)
    sites = find_adsorption_sites(slab, planar_distance=2.0)["ontop"]
    spec = make_spec(slab, sites, ["Cu"], potential_numbers=[29], cutoff=5.0)
    cfg = PaiNNConfig(feat_dim=16, n_rbf=8, cutoff=5.0, n_layers=2, readout_hidden=8,
                      max_neighbors=32)
    d = device_spec(spec, dev)
    shifts = torch.as_tensor(spec.shifts, dtype=torch.float32, device=dev)

    def realize(states):
        ss = torch.as_tensor(np.asarray(states), dtype=torch.int64, device=dev)
        pos, alive = realize_positions(d, ss), realize_alive(d, ss)
        return ss, pos, alive

    def label(states):
        _, pos, alive = realize(states)
        e, f = truth.energy_and_forces(pos, torch.zeros_like(alive, dtype=torch.int64), alive,
                                       shifts)
        structs = [Structure(np.full(int(a.sum()), 29), p[a].cpu().numpy(), spec.cell)
                   for p, a in zip(pos, alive)]
        return structs, e.cpu().tolist(), [fi[a].cpu().numpy() for fi, a in zip(f, alive)]

    def loop():
        rng = np.random.default_rng(0)
        params = init_ensemble(make_generator(0, dev), cfg, 2)
        frames, es, fs = label([rng.integers(0, 2, len(sites)) for _ in range(EX08_SEED_FRAMES)])
        rounds, t_train = [], 0.0
        for al_round in range(EX08_ROUNDS):
            batch = pad_structures(frames, es, fs, cfg.cutoff, n_max=spec.n_slots)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, hist = train_painn(params, cfg, [batch],
                                       TrainConfig(epochs=EX08_EPOCHS, learning_rate=3e-3),
                                       ensemble=True)
            torch.cuda.synchronize()
            t_train += time.perf_counter() - t0
            pot = make_painn_potential(params, cfg, [29], units="eV", ensemble=True)
            run = MCMCRun(spec, pot, device=dev)
            _, rec = run.run(al_round + 1, geometric_schedule(1.0, 8, 0.97),
                             cfg=EngineConfig(sweep_size=6, record_positions=False))
            ss, pos, alive = realize(_host(rec.site_state[0]))
            edges = image_search_edges(pos, alive, shifts, cfg.cutoff, cfg.max_neighbors)
            with torch.no_grad():
                out = ensemble_apply(params, cfg, torch.where(alive, 29, 0), alive, edges)
            embs = torch.stack([out["embedding"][i][alive[i]].mean(dim=0)
                                for i in range(len(ss))])
            labels = perform_clustering(embs, clustering_cutoff=3, cutoff_criterion="maxclust")
            picks = select_representatives(labels, out["energy_std"], metric="force_std")
            new, new_e, new_f = label(_host(ss)[picks])
            n_before = len(frames)
            frames, es, fs = frames + new, es + new_e, fs + new_f
            rounds.append({"loss": [hist[0], hist[-1]], "clusters": len(np.unique(labels)),
                           "distinct_states": len(np.unique(_host(ss), axis=0)),
                           "grown": len(frames) - n_before, "picks": picks.tolist(),
                           "std": [round(float(x), 4) for x in _host(out["energy_std"])[picks]]})
        return params, rounds, t_train, len(frames)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    params, rounds, t_train, n_frames = loop()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    params2, rounds2, _, _ = loop()
    same = rounds == rounds2 and all(torch.equal(a, b) for a, b in
                                     zip(tree_leaves(params), tree_leaves(params2)))
    frames_trained = EX08_EPOCHS * sum(EX08_SEED_FRAMES + sum(r["grown"] for r in rounds[:i])
                                       for i in range(EX08_ROUNDS))
    print(f"[ex08] {EX08_ROUNDS} rounds x {EX08_EPOCHS} epochs, {EX08_SEED_FRAMES} seed frames "
          f"-> {n_frames}: {frames_trained / t_train:.1f} structures/s of training "
          f"({t_train:.2f}s of the loop's {dt:.2f}s); rounds "
          f"{json.dumps(rounds)}; "
          f"bitwise repeat {same}; launches={json.dumps({k: v for k, v in launches.items() if v})}")
    if not (same and all(r["loss"][1] < r["loss"][0] and r["grown"] == r["clusters"]
                         for r in rounds)):
        raise AssertionError("[ex08] a check failed")
    return launches


def slice19_phases(dev) -> dict:
    """Phases 60-66 in a temporary folder; returns the launch counts of
    their paths."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="post_smoke_") as tmp_name:
        tmp = Path(tmp_name)
        paths = {}
        paths["cluster_cli"], reuse = cluster_cli_phase(dev, tmp)
        torch.cuda.empty_cache()
        paths["uncertainty"] = uncertainty_phase(dev, reuse)
        del reuse
        torch.cuda.empty_cache()
        paths["structure_tools"] = structure_tools_phase(dev, tmp)
        torch.cuda.empty_cache()
        paths["ex04"] = ex04_phase(dev)
        ex05_phase(tmp)
        paths["ex07"] = ex07_phase(dev)
        paths["ex08"] = ex08_phase(dev)
        torch.cuda.empty_cache()
    print(f"[post-time] phases 60-66 {time.perf_counter() - t0:.1f}s")
    return paths


def entry_registers(log: str) -> dict:
    """ptxas -v's report per entry function: {short name: [registers, spill
    store bytes, spill load bytes]}, the name the mangled one's kernel
    identifier with its int and bool template arguments (``<128,true>``)."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?", m.group(1))
            if k:
                targs = [("false", "true")[int(v)] if t == "b" else v
                         for t, v in re.findall(r"L([ib])(\d+)E", k.group(2) or "")]
                name = k.group(1) + (f"<{','.join(targs)}>" if targs else "")
            else:
                name = m.group(1)
            out[name] = [None, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.cuda_build import build_kernels
    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet, srtio3_001_painn

    t_start = time.perf_counter()
    # 1. device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    logs = build_kernels()
    ptxas = {k: " | ".join(ln.strip() for ln in v.splitlines()
                           if "registers" in ln or "spill" in ln or "Compiling entry" in ln)
             for k, v in logs.items()}
    print(f"[build] {time.perf_counter() - t0:.1f}s {json.dumps(ptxas)}")
    conv_regs = {e: r for name in ("chgnet_conv", "chgnet_conv_banded", "chgnet_conv_bwd")
                 for e, r in entry_registers(logs.get(name, "")).items()}
    print(f"[build] rows 10-12 registers / spill stores / spill loads (bytes) by entry: "
          f"{json.dumps(conv_regs)}")
    if any(r[1] or r[2] for r in conv_regs.values()):
        raise AssertionError(f"rows 10-12 spill registers: {conv_regs}")

    # 3. kernels
    dev = torch.device("cuda")
    sys_gpu = srtio3_001_painn(device=dev)
    rows = []
    contracts = {pk.painn_message_l1: layer1_unbanded_contract,
                 pk.painn_message_fused: message_fused_contract,
                 pk.painn_update_fused: update_contract}
    for kname, fn, replaces, args, per_chain, flops, nbytes in kernel_cases(sys_gpu, dev):
        m = _measure(kname, fn, pk.PLAIN[fn], args, per_chain, flops, nbytes=nbytes)
        rows.append(_row(kname, replaces, m))
        _print_measure("kernel", kname, m, contracts[fn](args, m))

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
    launches, _, _ = full_mc_phase("mc", sys_gpu, SWEEPS, RIGID_LAUNCHES)

    bwd_row = backward_phase(dev)
    rows.append(bwd_row)
    forces_phase(sys_gpu, sys_cpu, dev)
    sys_relax = srtio3_001_painn(relax=RelaxConfig(), device=dev)
    relaxed_anchor_phase(sys_relax, dev)
    relax_launches = relaxed_mc_phase("relax-mc", sys_relax, N_CHAINS, "painn_message_fused",
                                      "painn_message_bwd")
    del sys_cpu
    torch.cuda.empty_cache()

    sys_sc = srtio3_001_painn(supercell=(2, 2), device=dev)
    sc_rows = sc_kernels_phase(sys_sc, dev)
    rows += sc_rows
    torch.cuda.empty_cache()
    sc_anchor_phase(sys_sc, sys_gpu, dev)
    sc_launches, _, _ = full_mc_phase("sc-mc", sys_sc, SC_SWEEPS, BANDED_LAUNCHES)
    inc_launches = inc_mc_phase(sys_sc, dev)
    del sys_sc
    torch.cuda.empty_cache()
    inc_4x4_phase(dev)
    torch.cuda.empty_cache()

    sys33 = srtio3_001_painn(supercell=(3, 3), relax=RelaxConfig(), device=dev)
    rows.append(bwd_banded_phase(sys33, dev))
    torch.cuda.empty_cache()
    sc_relax_phase(sys33, dev)
    sc_relax_launches = relaxed_mc_phase("sc-relax-mc", sys33, SC_RELAX_CHAINS,
                                         "painn_message_fused_banded", "painn_message_bwd_banded")
    local_launches = {"local_relax_1x1": local_relax_phase("local-relax-1x1", sys_relax,
                                                           N_CHAINS, dev),
                      "local_relax_3x3": local_relax_phase("local-relax-3x3", sys33,
                                                           SC_RELAX_CHAINS, dev)}

    del sys33, sys_relax, sys_gpu
    torch.cuda.empty_cache()

    # CHGNet on LaMnO3(001): paths A (rigid 1x1), B (relaxed 1x1), C (rigid 3x3)
    t0 = time.perf_counter()
    sys_a = lamno3_001_chgnet(device=dev)
    sys_b = lamno3_001_chgnet(relax=RelaxConfig(steps=CHG_RELAX_STEPS), device=dev)
    sys_c = lamno3_001_chgnet(supercell=(3, 3), device=dev)
    print(f"[chgnet-build] 1x1 slots={sys_a.spec.n_slots} 3x3 slots={sys_c.spec.n_slots} "
          f"host build of the three systems {time.perf_counter() - t0:.1f}s")
    rows += chgnet_kernels_phase(sys_a, sys_b, sys_c)
    torch.cuda.empty_cache()
    chgnet_anchor_phase(sys_a, dev)
    chg_launches, _, _ = full_mc_phase("chgnet-mc", sys_a, SWEEPS, {"chgnet_conv": 4},
                                       n_chains=CHG_CHAINS)
    torch.cuda.empty_cache()
    forces_phase(sys_a, lamno3_001_chgnet(device="cpu"), dev, tag="chgnet-forces")
    chg_relax_launches = chgnet_relax_phase(sys_b, dev)
    torch.cuda.empty_cache()
    chg_3x3_launches = chgnet_3x3_phase(sys_c, dev)
    del sys_a, sys_b, sys_c
    torch.cuda.empty_cache()

    # EAM: Cu(100) semigrand and Au(110) canonical, row 13
    eam_rows, eam_paths = eam_phases(dev)
    rows += eam_rows
    torch.cuda.empty_cache()

    # PaiNN force-loss training and fine-tuning, row 5
    train_rows, train_paths = training_phases(dev)
    rows += train_rows
    torch.cuda.empty_cache()

    # the rest of the MC engine and the many-body systems
    engine_paths = slice14_phases(dev)
    torch.cuda.empty_cache()

    # the frozen-far-field engine, the dynamic delta, tempering and PA
    engine_paths.update(slice15_phases(dev))
    torch.cuda.empty_cache()

    # sharding, the image-search edge path, MACE
    engine_paths.update(slice16_phases(dev, smi))
    torch.cuda.empty_cache()

    # CHGNet and MACE training, the Pourbaix campaign
    engine_paths.update(slice17_phases(dev))
    torch.cuda.empty_cache()

    # the sampling CLI on the campaigns' settings files
    engine_paths.update(slice18_phases(dev))
    torch.cuda.empty_cache()

    # clustering, uncertainty, the structure tools, examples 04 / 05 / 07 / 08
    engine_paths.update(slice19_phases(dev))

    main_path = {"painn_message_bwd": "relaxed_mc", "painn_message_l1_banded": "sc_mc",
                 "painn_message_fused_banded": "sc_mc", "painn_message_subset": "inc_mc",
                 "painn_message_bwd_banded": "sc_relax_mc", "chgnet_conv": "chgnet_mc",
                 "chgnet_conv_banded": "chgnet_3x3_mc", "chgnet_conv_bwd": "chgnet_relax_mc",
                 "eam_rho_ep": "cu_mc", "painn_message_bwd2": "train"}
    for row in rows:
        by_path = {"rigid_mc": launches[row["name"]],
                   "relaxed_mc": relax_launches[row["name"]],
                   "sc_mc": sc_launches[row["name"]], "inc_mc": inc_launches[row["name"]],
                   "sc_relax_mc": sc_relax_launches[row["name"]],
                   **{k: v[row["name"]] for k, v in local_launches.items()},
                   "chgnet_mc": chg_launches[row["name"]],
                   "chgnet_relax_mc": chg_relax_launches[row["name"]],
                   "chgnet_3x3_mc": chg_3x3_launches[row["name"]],
                   **{k: v[row["name"]] for k, v in eam_paths.items()},
                   **{k: v[row["name"]] for k, v in train_paths.items()},
                   **{k: v[row["name"]] for k, v in engine_paths.items()}}
        row["launches"] = by_path[main_path.get(row["name"], "rigid_mc")]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on its path: {by_path}")
        row["launches_by_path"] = by_path
    print(f"[time] {time.perf_counter() - t_start:.1f}s for every phase, the build included")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
