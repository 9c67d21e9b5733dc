"""The multiple-try and distance-criterion steps on the card against the
same steps on the CPU plain path, fed the same draws; the delta engine
bitwise a fresh evaluation on the card, and bitwise repeats of the
frozen-far-field and tempered runs.

Marked ``cuda``: each test takes the ``cuda_device`` fixture, which skips
with a reason when no CUDA device is visible. Run them on an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_cuda_engine.py

The card runs the PaiNN kernels (rows 1-3) where the CPU runs their plain
versions; the steps must take the same decisions and reach the same
occupancies, energies within 1e-3 eV (the port's card-vs-CPU limit).
"""

import numpy as np
import pytest
import torch

from surface_sampling_tpu_torch.core.engine import make_generator
from surface_sampling_tpu_torch.core.events import (
    canonical_draws,
    make_canonical_step,
    make_canonical_step_mtm,
    make_distance_accept,
    make_semigrand_step,
    make_semigrand_step_mtm,
    mtm_draws,
    semigrand_draws,
)
from surface_sampling_tpu_torch.parallel.chains import chain_states
from surface_sampling_tpu_torch.systems import srtio3_001_painn

pytestmark = pytest.mark.cuda
E_TOL = 1e-3
N_CHAINS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    from surface_sampling_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _pair(dev):
    """The flagship 1x1 on the card and on the CPU, and physical start
    states: three adsorbates a chain on sites at least 2.5 A apart (crowded
    random occupancies score 1e3-eV overlaps, where card and CPU sums differ
    by more than the limit)."""
    gpu, cpu = srtio3_001_painn(device=dev), srtio3_001_painn(device="cpu")
    rng = np.random.default_rng(0)
    S, xyz = cpu.spec.n_sites, cpu.spec.site_coords
    ss = np.zeros((N_CHAINS, S), np.int64)
    for c in range(N_CHAINS):
        picked = []
        for s in rng.permutation(S):
            if all(np.linalg.norm(xyz[s] - xyz[p]) >= 2.5 for p in picked):
                picked.append(s)
            if len(picked) == 3:
                break
        ss[c, picked] = rng.integers(1, cpu.spec.n_codes, len(picked))
    states = []
    for sys_ in (gpu, cpu):
        st = chain_states(sys_.run.d, N_CHAINS, ss)
        states.append(st._replace(energy=sys_.run.state_energy_fn(st.site_state).surface_energy))
    return gpu, cpu, states


def _to(draws, dev):
    if isinstance(draws, torch.Tensor):
        return draws.to(dev)
    return tuple(_to(x, dev) for x in draws)


def _replay(dev, make, draw_fn, n_steps=3, temp=1.0):
    gpu, cpu, (sg, sc) = _pair(dev)
    steps = [make(sys_) for sys_ in (gpu, cpu)]
    gen = make_generator(0, "cpu")
    d = cpu.run.d
    accepted = []
    for _ in range(n_steps):
        dr = draw_fn(gen, N_CHAINS, d.site_coords.shape[0], d.n_codes)
        sg, ig = steps[0](sg, temp, *_to(dr, dev))
        sc, ic = steps[1](sc, temp, *dr)
        assert torch.equal(ig.accepted.cpu(), ic.accepted)
        assert torch.equal(sg.site_state.cpu(), sc.site_state)
        assert float((sg.energy.cpu() - sc.energy).abs().max()) <= E_TOL
        accepted.append(ic.accepted)
    return torch.stack(accepted), sc, cpu


@pytest.mark.parametrize("canonical", [False, True])
def test_mtm_step_card_matches_cpu(cuda_device, canonical):
    """K = 4 trials: the card's batched evaluations (rows 1-3 at 4 and 3
    chains' worth of states a chain) give the CPU's decisions."""
    make = make_canonical_step_mtm if canonical else make_semigrand_step_mtm
    acc, _, _ = _replay(cuda_device, lambda s: make(s.run.d, s.run.state_energy_fn, 4),
                        mtm_draws(4, canonical=canonical))
    assert acc.any()


@pytest.mark.parametrize("canonical", [False, True])
def test_metropolis_distance_step_card_matches_cpu(cuda_device, canonical):
    """The distance filter's hard wall on the card and on the CPU: the same
    decisions, and no accepted state closer than the filter."""
    make = make_canonical_step if canonical else make_semigrand_step
    acc, states, cpu = _replay(
        cuda_device, lambda s: make(s.run.d, s.run.state_energy_fn,
                                    criterion="metropolis_distance", filter_distance=1.5),
        canonical_draws if canonical else semigrand_draws)
    ok = make_distance_accept(cpu.run.d, 1.5)(states.site_state)
    assert ok[acc.any(0)].all()


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)] if isinstance(x, tuple) else []


def _bitwise(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("static_geometry", ["auto", "off"])
def test_delta_equals_fresh_bitwise_on_card(cuda_device, static_geometry):
    """The 2x2 delta engine, static and dynamic geometry, on crowded random
    occupancies (a quarter of the sites occupied; energies up to the 1e4-eV
    clamp) at 16 chains: the one- and two-site deltas of one canonical draw
    equal a fresh energy_full of the trial state bit for bit, energies and
    every cache."""
    from surface_sampling_tpu_torch.core.events import pick_exchange
    from surface_sampling_tpu_torch.core.incremental import make_incremental_painn
    from surface_sampling_tpu_torch.core.state import change_site, exchange_sites

    sys2 = srtio3_001_painn(supercell=(2, 2), device=cuda_device)
    eng = make_incremental_painn(sys2.spec, sys2.run.d, sys2.potential, sys2.static_nbr,
                                 sys2.routing_band, sys2.run.surface_energy_fn,
                                 static_geometry=static_geometry)
    rng = np.random.default_rng(38)
    ss = rng.integers(0, eng.n_codes, (N_CHAINS, eng.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.75, 0, ss), device=cuda_device)
    st = eng.init_state(ss)
    g_t, g1, g2, _ = canonical_draws(make_generator(0, cuda_device), N_CHAINS, eng.n_sites,
                                     eng.n_codes)
    s1, s2, _ = pick_exchange(ss, eng.n_codes, g_t, g1, g2)
    for trial, sites in ((change_site(ss, s1, torch.gather(ss, 1, s2[:, None])[:, 0]),
                          s1[:, None]),
                         (exchange_sites(ss, s1, s2), torch.stack([s1, s2], 1))):
        fresh, fc, _ = eng.energy_full(trial)
        se, c, _ = eng.delta(st.caches, trial, sites)
        assert float(fresh.abs().max()) > 1e3          # crowded: large last-layer features
        assert torch.equal(se, fresh)
        assert _bitwise(c, fc)


def test_ff_run_repeats_bitwise_on_card(cuda_device):
    """The frozen-far-field semigrand run on the relaxed 1x1 (one-hop balls,
    6 FIRE steps, 4 chains x 2 steps) twice from one seed: bitwise the same
    states, caches and records (the descent's gathers sum their cotangents
    in a fixed order)."""
    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.ff_relax import (
        build_ff_tables,
        make_ff_init,
        make_ff_relax_eval,
        make_ff_run,
        make_ff_semigrand_step,
    )

    relax = RelaxConfig(steps=6)
    sys1 = srtio3_001_painn(relax=relax, device=cuda_device)
    run, spec = sys1.run, sys1.spec
    ev = make_ff_relax_eval(run.d, sys1.potential, run.surface_energy_fn, relax,
                            build_ff_tables(spec, sys1.static_nbr, 1))
    ss = torch.zeros((4, spec.n_sites), dtype=torch.int64, device=cuda_device)
    ss[:, 3] = torch.arange(1, 5, device=cuda_device) % spec.n_codes
    st = make_ff_init(run.d, ev, run.state_energy_fn)(ss)
    frun = make_ff_run(make_ff_semigrand_step(ev), 2, spec.n_sites, spec.n_codes)
    a = frun(st, np.array([1.0]), make_generator(5, cuda_device))
    b = frun(st, np.array([1.0]), make_generator(5, cuda_device))
    assert _bitwise(a, b)
    assert (a[0].relaxed_positions != st.relaxed_positions).any() or not a[1].accept_rate.any()


def test_tempered_run_repeats_bitwise_on_card(cuda_device):
    """Tempering over Au(110) through the EAM kernel (row 13), 8 replicas x
    4 rounds of a 4-step sweep, twice from one seed: bitwise the same states
    and records; swap rates in [0, 1]."""
    from surface_sampling_tpu_torch.core.engine import EngineConfig, MCMCRun, make_run_fn
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.parallel import make_tempered_run, temperature_ladder
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam
    from surface_sampling_tpu_torch.systems import au110_eam

    tables = builtin_eam("Au_u3")
    spec = au110_eam(device=cuda_device).spec
    nbr = build_static_neighbor_table(spec, tables.cutoff, relax_slack=0.05)
    krun = MCMCRun(spec, make_eam_kernel_potential(tables, nbr, device=cuda_device),
                   device=cuda_device)
    run_fn = make_run_fn(krun.d, krun.state_energy_fn,
                         EngineConfig(sweep_size=4, record_positions=False))
    st = chain_states(krun.d, 8)
    st = st._replace(energy=krun.state_energy_fn(st.site_state).surface_energy)
    trun = make_tempered_run(run_fn, n_rounds=4)
    temps = temperature_ladder(0.02, 2.0, 8)
    a = trun(st, temps, make_generator(3, cuda_device))
    b = trun(st, temps, make_generator(3, cuda_device))
    assert _bitwise(a, b)
    assert ((a[1].swap_rate >= 0) & (a[1].swap_rate <= 1)).all()


def test_mace_forces_repeat_bitwise_on_card(cuda_device):
    """MACE at the default width (l_max 2, equivariant messages) on four
    random 40-atom frames: two force evaluations give the same bits (the
    neighbour gather's backward is a fixed-order sum, not atomics)."""
    from surface_sampling_tpu_torch.models.mace import MACEConfig, init_mace, mace_apply

    cfg = MACEConfig(equivariant_messages=True)
    params = init_mace(torch.Generator(device=cuda_device).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(0, 9.0, (4, 40, 3)), dtype=torch.float32,
                          device=cuda_device)
    nums = torch.as_tensor(rng.integers(1, 30, (4, 40)), device=cuda_device)
    alive = torch.ones((4, 40), dtype=torch.bool, device=cuda_device)
    shifts = torch.as_tensor(np.diag([9.0, 9.0, 0.0])[[2, 0, 1]], dtype=torch.float32,
                             device=cuda_device)

    def forces():
        p = pos.clone().requires_grad_(True)
        e = mace_apply(params, cfg, p, nums, alive, shifts)["energy"]
        return torch.autograd.grad(e.sum(), p)[0]

    f1, f2 = forces(), forces()
    assert torch.equal(f1, f2) and float(f1.abs().max()) > 0


def test_image_search_relaxed_run_repeats_bitwise_on_card(cuda_device):
    """The flagship ensemble with its edges found by image search
    (make_painn_potential without a static table): a FIRE-relaxed
    semigrand run of 8 chains x 2 steps, twice from one seed, bitwise the
    same."""
    import json

    from surface_sampling_tpu_torch.core.energy import RelaxConfig
    from surface_sampling_tpu_torch.core.engine import EngineConfig, MCMCRun
    from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
    from surface_sampling_tpu_torch.systems import SYSTEMS_DATA

    sys1 = srtio3_001_painn(relax=RelaxConfig(steps=5), device=cuda_device)
    pot = sys1.potential
    stoidict = json.loads((SYSTEMS_DATA / "srtio3_offset_data.json").read_text())["stoidict"]
    image = make_painn_potential(pot.params, pot.cfg, pot.znums.tolist(), units="kcal/mol",
                                 stoidict=stoidict)
    run = MCMCRun(sys1.spec, image, surface_energy_fn=sys1.run.surface_energy_fn,
                  device=cuda_device, relax=RelaxConfig(steps=5))
    cfg = EngineConfig(sweep_size=2, record_positions=True)
    a = run.run(make_generator(4, cuda_device), np.array([1.0]), cfg=cfg, n_chains=8)
    b = run.run(make_generator(4, cuda_device), np.array([1.0]), cfg=cfg, n_chains=8)
    assert _bitwise(a, b)
    assert torch.isfinite(a[1].energy).all()


def test_world_one_nccl_sharded_run_equals_unsharded(cuda_device, tmp_path):
    """A world of one rank over NCCL: the sharded Cu(100) run (chain_mesh,
    shard, run, gather) equals the unsharded run with the same generator,
    bitwise."""
    from torch_sharding_ranks import run_nccl_world_one

    from surface_sampling_tpu_torch.parallel import spawn_ranks

    spawn_ranks(run_nccl_world_one, 1, "cuda", args=(str(tmp_path),))
    assert (tmp_path / "nccl_world_one.ok").read_text() == "bitwise"


def _conv_second_order(ops, args, rev, wout, cg, diff):
    """grad-of-grad of ``ops(*args)`` summed against ``wout``, contracted
    with the outer cotangents ``cg`` (the force loss's structure): the
    second-order cotangent of every input in ``diff``."""
    args = [a.clone() for a in args]
    for i in diff:
        args[i].requires_grad_(True)
    agg = ops(*args, rev)
    g = torch.autograd.grad((agg * wout).sum(), [args[i] for i in diff], create_graph=True)
    outer = sum((gi * ci).sum() for gi, ci in zip(g, cg))
    return torch.autograd.grad(outer, [args[i] for i in diff])


def test_chgnet_conv_second_order_card_matches_plain(cuda_device):
    """grad-of-grad through chgnet_conv at the checkpoint's shape (F = 64,
    M = 96, 4 chains of 64 centres, a fifth of the slots masked): row 10
    forward, row 12 first order, the fixed-order double VJP, against the
    same computation with the plain versions on the card, within 1e-4 x
    max|plain| per output; and the kernel path bitwise on repeat."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.ops.neighbors import reverse_table

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    C, n_pad, F, M = 4, 64, 64, 96
    E = n_pad * M

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda_device) * scale

    maskf = (torch.rand((C, E), generator=gen, device=cuda_device) > 0.2).float()
    nbr = torch.randint(0, n_pad, (C, E), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    args = [rn(C, n_pad, 2 * F), rn(C, n_pad, 2 * F), rn(C, E, F), rn(C, E, F), maskf, nbr,
            rn(F, 2 * F, scale=0.1), rn(F, F, scale=0.1), rn(F, F, scale=0.1), rn(F), rn(F),
            torch.stack([1.0 + rn(F, scale=0.1), rn(F, scale=0.1)]),
            torch.stack([1.0 + rn(F, scale=0.1), rn(F, scale=0.1)])]
    diff = [0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12]
    wout, cg = rn(C, n_pad, F), [rn(*args[i].shape) for i in diff]
    rev = reverse_table(nbr, maskf != 0, n_pad)
    ck.reset_launch_counts()
    got = _conv_second_order(ck.chgnet_conv, args, rev, wout, cg, diff)
    counts = ck.launch_counts()
    assert counts["chgnet_conv"] == 1 and counts["chgnet_conv_bwd"] == 1
    again = _conv_second_order(ck.chgnet_conv, args, rev, wout, cg, diff)
    want = _conv_second_order(lambda *a: ck.chgnet_conv_plain(*a[:-1]), args, None, wout, cg,
                              diff)
    for name, g, a, w in zip(ck.GRAD_NAMES, got, again, want):
        assert torch.equal(g, a), name
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_chgnet_train_step_card_matches_cpu(cuda_device):
    """One CHGNet training step (the LaMnO3 checkpoint at full width, two
    jittered frames of its slab, the magmom term on) on the card against
    the CPU plain path: the loss within 1e-5 relative, every gradient leaf
    within 1e-3 x max|cpu|; rows 10 and 12 launched on the card."""
    from surface_sampling_tpu_torch.models.chgnet import chgnet_apply_structures
    from surface_sampling_tpu_torch.models.train import (
        TrainConfig,
        Trainer,
        batch_to_device,
        pad_structures,
    )
    from surface_sampling_tpu_torch.models.weights import from_jax_params, load_chgnet_npz
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.structure.atoms import Structure
    from surface_sampling_tpu_torch.systems import MODEL_DATA, SYSTEMS_DATA

    tree, cfg = load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    data = np.load(SYSTEMS_DATA / "LaMnO3_001_2x2x3.npz")
    rng = np.random.default_rng(0)
    frames = [Structure(data["numbers"], data["positions"] + rng.normal(0, 0.05, (60, 3)),
                        data["cell"]) for _ in range(2)]
    batch = pad_structures(frames, rng.normal(size=2) - 400.0,
                           [rng.normal(size=(60, 3)) for _ in frames], cfg.atom_graph_cutoff,
                           magmoms=[rng.normal(size=60) for _ in frames])
    tcfg = TrainConfig(magmom_weight=0.5)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        trainer = Trainer(from_jax_params(tree, dev), cfg, tcfg,
                          apply_fn=chgnet_apply_structures)
        ck.reset_launch_counts()
        loss, grads = trainer.gradients(batch_to_device(batch, dev))
        out.append((float(loss[0]), [g.cpu() for g in grads], ck.launch_counts()))
    (lg, gg, counts), (lc, gc, _) = out
    assert counts["chgnet_conv"] >= cfg.n_conv and counts["chgnet_conv_bwd"] >= 2 * cfg.n_conv
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-3 * max(float(b.abs().max()), 1e-12)


def test_cli_resume_bitwise_on_card(cuda_device, tmp_path):
    """The sampling CLI on the card (Cu(100) EAM, the cu_setup shape of
    tests/test_cli.py, chunked): 2 sweeps resumed in place to 6 are bitwise
    the uninterrupted 6-sweep run, and the checkpoint holds a CUDA
    generator, which the CPU refuses."""
    import json

    from surface_sampling_tpu_torch.cli.sample_surface import main
    from surface_sampling_tpu_torch.io import load_checkpoint
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam, save_tables_npz
    from surface_sampling_tpu_torch.structure.io import write_cif
    from surface_sampling_tpu_torch.structure.slabs import fcc100

    write_cif(tmp_path / "slab.cif", fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0))
    save_tables_npz(tmp_path / "cu.npz", builtin_eam("Cu_u3"))

    def run(total, folder, resume=None):
        s = {"system_settings": {"surface_name": "Cu_100", "planar_distance": 1.5},
             "sampling_settings": {"total_sweeps": total, "sweep_size": 4, "start_temp": 1.0,
                                   "adsorbates": ["Cu"], "n_chains": 64,
                                   "checkpoint_interval": 2,
                                   "run_folder": str(tmp_path / folder)},
             "calc_settings": {"calc_name": "eam", "potential_file": str(tmp_path / "cu.npz")}}
        sp = tmp_path / f"{folder}_{total}.json"
        sp.write_text(json.dumps(s))
        argv = ["--settings", str(sp), "--slab", str(tmp_path / "slab.cif")]
        main(argv + (["--resume", str(tmp_path / resume)] if resume else []))
        with np.load(tmp_path / folder / "history.npz") as h:
            return {k: h[k] for k in h.files}

    full = run(6, "full")
    run(2, "part")
    res = run(6, "part", resume="part")
    for k in ("energy", "site_state", "accept_rate"):
        np.testing.assert_array_equal(res[k], full[k][:, 2:])
    _, idx, _, _, gen = load_checkpoint(tmp_path / "part" / "checkpoint.npz", "cuda")
    assert idx == 6 and gen.device.type == "cuda"
    with pytest.raises(ValueError, match="--device cuda"):
        load_checkpoint(tmp_path / "part" / "checkpoint.npz", "cpu")
