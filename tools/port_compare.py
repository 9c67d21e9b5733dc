#!/usr/bin/env python3
"""Two checkouts of the port on one NVIDIA GPU, in turns: kernel times,
end-to-end rates and whether their outputs agree bit for bit.

    python3 tools/port_compare.py run TREE LABEL
    python3 tools/port_compare.py bits LABEL_A LABEL_B [LABEL ...]

``run`` imports TREE's own ``chip_smoke.py``, ``tools/port_profile.py`` and
port package (TREE first on ``sys.path``; TREE builds its kernels into its
own ``_build/``) and measures there, at chip_smoke.py's shapes:

  kernel ms (CUDA events, 20 launches): rows 1-3 at the 1x1 rigid path
    (128 chains), row 3 at the 2x2 supercell's (128 chains, sc_update_args),
    row 2 at a training step's shape (16 frames of n_pad 64,
    one member, seeded), rows 10 / 11 / 12 at CHGNet paths A / C / B, row 13
    at Cu(100) (16,384 chains) and Au(110) (1,024);
  end to end: chip_smoke.py's ``[mc]``, ``[cu-mc]`` and ``[relax-mc]``
    phases (their own evals/s lines), and one traced force call of the
    relaxed 1x1 path (port_profile.py's ``force_call`` window: wall, device
    ms, and the device ms of the general message kernels);
  row 6 at the 2x2 supercell (128 chains, chip_smoke.py's [sc-kernel]
    inputs), then chip_smoke.py's ``[sc-mc]`` and ``[inc-4x4]`` phases;
    row 5 at a training step's shape (16 frames, one member, chip_smoke.py's
    [bwd2] inputs; c_dw absent and given), then its ``[train]`` phase.

It prints ``[result] {LABEL: {...}}`` and saves the kernels' outputs under
``surface_sampling_tpu_torch/_build/compare/LABEL.pt`` of the working
directory. ``bits`` compares those files: LABEL_A against each later label,
bitwise and by max abs difference. Parent against change, in one call:

    git archive HEAD | tar -x -C _archive/parent     # a directory .gitignore lists
    for r in "_archive/parent parent1" ". change1" ". change2" "_archive/parent parent2"; do
        python3 tools/port_compare.py run $r
    done
    python3 tools/port_compare.py bits parent1 change1 change2 parent2

The TREE may be older than this script: it needs only the chip_smoke.py
functions named above (and train_setup); the inputs of rows 3 and 6 at the
2x2 and of row 5 are made here (sc_update_args, sc_layer1_args,
train_bwd2_args, which port_profile.py's --variants uses too).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

OUT = Path("surface_sampling_tpu_torch/_build/compare").resolve()


def sc_layer1_args(sys_sc, dev, n_chains: int) -> tuple:
    """Row 6's inputs as chip_smoke.py's [sc-kernel] makes them: the 2x2
    supercell's banded static geometry of n_chains seeded occupancies (75%
    of the sites empty), its species rows and layer-1 weights."""
    import numpy as np
    import torch
    from surface_sampling_tpu_torch.core.state import realize_alive, realize_numbers
    from surface_sampling_tpu_torch.models.painn import species_rows, with_halo
    from surface_sampling_tpu_torch.ops.static_edges import static_edge_geometry

    pot, d, spec = sys_sc.potential, sys_sc.run.d, sys_sc.spec
    band = pot.static_edge_pack.band
    rng = np.random.default_rng(4)
    ss = rng.integers(0, spec.n_codes, (n_chains, spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
    (rbf, envm, nbr, unit, n_pad), _ = static_edge_geometry(pot.static_edge_pack,
                                                            realize_alive(d, ss))
    species = species_rows(pot.rw, pot.cfg, realize_numbers(d, ss), n_pad)
    return (with_halo(species[:, band.perm], band.halo, 1), pot.rw["philt"], rbf, envm, nbr,
            unit, pot.rw["dw2"], pot.rw["db2"], band)


def sc_update_args(sys_sc, dev, n_chains: int) -> tuple:
    """Row 3's inputs at the 2x2 supercell's shape (the [sc] trunk's update):
    the alive rows of n_chains seeded occupancies (75% of the sites empty,
    as sc_layer1_args draws them) padded to n_pad, layer 1's update weights
    and seeded random features."""
    import numpy as np
    import torch
    from surface_sampling_tpu_torch.core.state import realize_alive

    pot, d, spec = sys_sc.potential, sys_sc.run.d, sys_sc.spec
    band = pot.static_edge_pack.band
    rng = np.random.default_rng(4)
    ss = rng.integers(0, spec.n_codes, (n_chains, spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
    alive = realize_alive(d, ss).float()
    alive = torch.nn.functional.pad(alive, (0, band.n_pad - alive.shape[1]))[:, band.perm]
    K, F = pot.params["atom_embed"].shape[0], pot.cfg.feat_dim
    up = pot.params["update"][0]
    g = torch.Generator(device=dev).manual_seed(4)
    return (torch.randn((n_chains, K, band.n_pad, F), generator=g, device=dev),
            torch.randn((n_chains, K, band.n_pad, 3 * F), generator=g, device=dev),
            up["u_mat"]["w"], up["v_mat"]["w"], up["s_dense0"]["w"], up["s_dense0"]["b"],
            up["s_dense1"]["w"], up["s_dense1"]["b"], alive.contiguous())


def train_bwd2_args(dev) -> tuple:
    """Row 5's inputs at the training path's shape, as chip_smoke.py's
    [bwd2] makes them for one member (K = 1): the 16 frames' geometry,
    seeded features and cotangents (c_envm zero on masked edges); returns
    (args, cotangents, reverse table)."""
    import torch

    import chip_smoke as cs
    from surface_sampling_tpu_torch.models.painn import message_weights, structure_edges
    from surface_sampling_tpu_torch.models.train import batch_to_device

    params, cfg, _, _, batch = cs.train_setup(dev)
    b = batch_to_device(batch, dev)
    _, (rbf, envm, nbr, unit, n_pad, rev) = structure_edges(cfg, b.positions, b.numbers,
                                                             b.shifts)
    dw, db = message_weights(params["message"][1], cfg, rbf.shape[-1])
    C, E, R = rbf.shape
    F, M = cfg.feat_dim, E // n_pad
    g = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    args = (rn(C, 1, n_pad, 3 * F), rn(C, 1, n_pad, 3 * F), rbf, envm, nbr, unit,
            dw[:1].contiguous(), db[:1].contiguous(), rn(C, 1, n_pad, F), rn(C, 1, n_pad, 3 * F))
    cots = (rn(C, 1, n_pad, 3 * F), rn(C, 1, n_pad, 3 * F), rn(C, E, R),
            rn(C, E) * (envm != 0), rn(C, 3, n_pad, M))
    return args, cots, rev


def run(tree: str, label: str) -> int:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path[:0] = [tree, os.path.join(tree, "tools")]

    import numpy as np
    import torch

    import chip_smoke as cs
    import port_profile as pp
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import MCMCRun
    from surface_sampling_tpu_torch.core.state import (
        realize_alive,
        realize_positions,
        realize_type_idx,
    )
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.ops import eam_kernels as ek
    from surface_sampling_tpu_torch.ops import painn_kernels as pk
    from surface_sampling_tpu_torch.ops.cuda_build import build_kernels
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam
    from surface_sampling_tpu_torch.systems import (
        ExampleSystem,
        au110_eam,
        cu100_eam,
        lamno3_001_chgnet,
        srtio3_001_painn,
    )

    t0 = time.perf_counter()
    build_kernels()
    print(f"[{label}] tree {tree} build {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    res, out = {}, {}

    def ms(fn):
        return cs._cuda_ms(fn, reps=20)

    sys_gpu = srtio3_001_painn(device=dev)
    rows = {"painn_message_l1": "row1", "painn_message_fused": "row2",
            "painn_update_fused": "row3"}
    for name, fn, _, args, *_ in cs.kernel_cases(sys_gpu, dev):
        res[name] = ms(lambda: fn(*args))
        out[rows[name]] = [t.cpu() for t in fn(*args)]
    g = torch.Generator(device=dev).manual_seed(3)
    C, K, n_pad, M, R, F = 16, 1, 64, 64, 24, 128

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    train = (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), rn(C, n_pad * M, R),
             (torch.rand((C, n_pad * M), generator=g, device=dev) < 0.6).float(),
             torch.randint(0, n_pad, (C, n_pad * M), generator=g, device=dev,
                           dtype=torch.int32),
             rn(C, 3, n_pad, M), rn(K, R, 3 * F), rn(K, 3 * F))
    res["row2_train_shape"] = ms(lambda: pk.painn_message_fused(*train))

    sys_a = lamno3_001_chgnet(device=dev)
    sys_b = lamno3_001_chgnet(relax=RelaxConfig(steps=cs.CHG_RELAX_STEPS), device=dev)
    sys_c = lamno3_001_chgnet(supercell=(3, 3), device=dev)
    a, _, _ = cs.chgnet_conv_case(sys_a, cs.CHG_CHAINS, seed=10)
    b, rev, _ = cs.chgnet_conv_case(sys_b, cs.CHG_RELAX_CHAINS, seed=12, relaxed=True)
    c, _, _ = cs.chgnet_conv_case(sys_c, cs.CHG_3X3_CHAINS, seed=11)
    band = sys_c.potential.band
    gagg = torch.randn(b[0].shape[:2] + (ck.KERNEL_F,), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(12))
    res["row10_A"] = ms(lambda: ck.chgnet_conv(*a))
    res["row11_C"] = ms(lambda: ck.chgnet_conv_banded(*c, band))
    res["row12_B"] = ms(lambda: ck.chgnet_conv_bwd(*b, gagg, rev=rev))
    out["row10"] = ck.chgnet_conv(*a).cpu()
    out["row11"] = ck.chgnet_conv_banded(*c, band).cpu()
    out["row12"] = [t.cpu() for t in ck.chgnet_conv_bwd(*b, gagg, rev=rev, want_weights=True)]
    del a, b, c, gagg, rev, sys_a, sys_b, sys_c
    torch.cuda.empty_cache()

    cu = cu100_eam(fast=True, device=dev)
    cu_pot = ek.make_eam_kernel_potential(builtin_eam("Cu_u3"), cu.static_nbr, device=dev)
    au = au110_eam(device=dev)
    au_pot = ek.make_eam_kernel_potential(builtin_eam("Au_u3"), build_static_neighbor_table(
        au.spec, builtin_eam("Au_u3").cutoff, relax_slack=0.05), device=dev)
    for name, system, pot, n, seed in (("row13_Cu", cu, cu_pot, cs.CU_MC_CHAINS, 32),
                                       ("row13_Au", au, au_pot, cs.EAM_AU_CHAINS, 31)):
        ss = cs._eam_states(system.spec.n_sites, n, seed, dev)
        d = system.run.d
        args = (realize_positions(d, ss).contiguous(), realize_alive(d, ss).float(), pot.pairs,
                pot.cheb)
        res[name] = ms(lambda: ek.eam_rho_ep(*args))
        out[name] = [t.cpu() for t in ek.eam_rho_ep(*args)]

    _, res["mc_evals_s"], _ = cs.full_mc_phase("mc", sys_gpu, cs.SWEEPS, cs.RIGID_LAUNCHES)
    cu_sys = ExampleSystem(cu.spec, cu_pot, MCMCRun(cu.spec, cu_pot, device=dev), cu.static_nbr)
    _, res["cu_mc_evals_s"], _ = cs.full_mc_phase(
        "cu-mc", cu_sys, cs.CU_MC_SWEEPS, {"eam_rho_ep": 1}, n_chains=cs.CU_MC_CHAINS,
        sweep_size=cs.CU_MC_SWEEP_SIZE)
    del sys_gpu, cu_sys
    torch.cuda.empty_cache()
    sys_relax = srtio3_001_painn(relax=RelaxConfig(), device=dev)
    cs.relaxed_mc_phase("relax-mc", sys_relax, cs.N_CHAINS, "painn_message_fused",
                        "painn_message_bwd")
    spec, d = sys_relax.spec, sys_relax.run.d
    rng = np.random.default_rng(0)
    ss = rng.integers(0, spec.n_codes, (cs.N_CHAINS, spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=dev)
    w = pp._window("force_call", pp.force_call(sys_relax.potential, realize_positions(d, ss),
                                                realize_type_idx(d, ss), realize_alive(d, ss)))
    res["force_call_wall_ms"], res["force_call_device_ms"] = w["wall_ms"], w["device_ms"]
    res["force_call_message_ms"] = sum(k["ms"] for k in w["kernels"]
                                       if "message_kernel" in k["name"])
    del sys_relax, w
    torch.cuda.empty_cache()

    # row 6 and the supercell's rigid paths
    sys_sc = srtio3_001_painn(supercell=(2, 2), device=dev)
    l1 = sc_layer1_args(sys_sc, dev, cs.N_CHAINS)
    res["row6_2x2"] = ms(lambda: pk.painn_message_l1_banded(*l1))
    out["row6"] = [t.cpu() for t in pk.painn_message_l1_banded(*l1)]
    upd = sc_update_args(sys_sc, dev, cs.N_CHAINS)
    res["row3_2x2"] = ms(lambda: pk.painn_update_fused(*upd))
    out["row3_2x2"] = [t.cpu() for t in pk.painn_update_fused(*upd)]
    del l1, upd
    _, res["sc_mc_evals_s"], _ = cs.full_mc_phase("sc-mc", sys_sc, cs.SC_SWEEPS,
                                                  cs.BANDED_LAUNCHES)
    del sys_sc
    torch.cuda.empty_cache()
    cs.inc_4x4_phase(dev)
    torch.cuda.empty_cache()

    # row 5 and the training path
    args5, cots5, rev5 = train_bwd2_args(dev)
    res["row5_train"] = ms(lambda: pk.painn_message_bwd2(*args5, *cots5, rev=rev5))
    res["row5_train_c_dw"] = ms(lambda: pk.painn_message_bwd2(*args5, *cots5, args5[6],
                                                              args5[7], rev=rev5))
    out["row5"] = [t.cpu() for t in pk.painn_message_bwd2(*args5, *cots5, rev=rev5)]
    del args5, cots5, rev5
    params, cfg, _, _, batch = cs.train_setup(dev)
    cs.train_phase(params, cfg, batch, dev)

    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(out, OUT / f"{label}.pt")
    print(f"[result] {json.dumps({label: res})}", flush=True)
    return 0


def bits(labels: list) -> int:
    import torch

    outs = {k: torch.load(OUT / f"{k}.pt") for k in labels}
    ref = outs[labels[0]]
    for key in ref:
        for other in labels[1:]:
            a = ref[key] if isinstance(ref[key], list) else [ref[key]]
            b = outs[other][key] if isinstance(outs[other][key], list) else [outs[other][key]]
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
            scale = max(float(x.abs().max()) for x in a)
            print(f"[bits] {key}: {labels[0]} vs {other}: bitwise equal {same}; max abs diff "
                  f"{diff:.3e} (max|{labels[0]}| {scale:.3e})")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"] and len(sys.argv) == 4:
        sys.exit(run(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["bits"] and len(sys.argv) >= 4:
        sys.exit(bits(sys.argv[2:]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
