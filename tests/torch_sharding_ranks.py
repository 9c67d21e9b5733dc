"""The rank side of ``tests/test_torch_sharding.py``: the checks each rank
of a gloo world on the CPU runs, with no JAX import (the ranks are fresh
processes; the JAX references arrive by file).

``run_checks(rank, workdir)`` reads ``workdir/refs.npz`` (the inputs and
the JAX package's results), runs the port's meshes, sharded chain runs,
sharded ensemble energy and sharded train steps, and gathers to rank 0,
which writes ``workdir/world{W}.npz`` for the parent to compare.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from surface_sampling_tpu_torch.core.engine import (
    EngineConfig,
    geometric_schedule,
    make_generator,
    make_run_fn,
    prepare_canonical_fn,
)
from surface_sampling_tpu_torch.models.chgnet import (
    CHGNetConfig,
    chgnet_apply_structures,
    init_chgnet,
)
from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    painn_apply_structures,
    tree_leaves,
)
from surface_sampling_tpu_torch.models.train import (
    PaddedBatch,
    TrainConfig,
    Trainer,
    batch_to_device,
    pad_structures,
    train_painn,
)
from surface_sampling_tpu_torch.models.weights import _flatten, _unflatten, from_jax_params
from surface_sampling_tpu_torch.parallel import (
    chain_block,
    chain_ensemble_mesh,
    chain_mesh,
    gather_chain_states,
    make_ensemble_sharded_energy,
    make_ensemble_sharded_train_step,
    make_hierarchical_chain_run,
    make_sharded_chain_run,
    make_sharded_train_step,
    pod_mesh,
    shard_chain_states,
    train_sharded,
)
from surface_sampling_tpu_torch.structure.atoms import Structure
from surface_sampling_tpu_torch.systems import cu100_eam

CPU = torch.device("cpu")
PAINN = dict(feat_dim=16, n_rbf=6, cutoff=6.0, n_layers=2, max_neighbors=5)
LOOP_PAINN = dict(PAINN, n_layers=1)     # the epoch loops: one layer keeps JAX's compile short
ENSEMBLE_PAINN = dict(feat_dim=8, n_rbf=6, cutoff=4.0, n_layers=1, readout_hidden=8,
                      max_neighbors=4)
N_CHAINS = 16
CHGNET = CHGNetConfig(atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=7,
                      num_angular=7, n_conv=2, max_neighbors=48, max_bond_neighbors=8,
                      mlp_hidden_dims=(16, 16, 16))


def _tree(refs, prefix):
    return from_jax_params(_unflatten({k[len(prefix):]: v for k, v in refs.items()
                                       if k.startswith(prefix)}), CPU)


def _batch(refs, name):
    return PaddedBatch(*(refs[f"{name}.{f}"] for f in ("positions", "numbers", "shifts",
                                                       "energy", "forces")))


def _errors(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _mesh_checks(world: int) -> dict:
    """Shapes, names and errors of the three builders (every rank builds
    the same meshes in the same order: their groups are collective)."""
    out = {}
    m = chain_mesh(device=CPU)
    out["chain"] = [m.axis_names, m.shape, m.ranks.tolist()]
    p = pod_mesh(2, device=CPU)
    out["pod"] = [p.axis_names, p.shape, p.ranks.tolist(), p.axis_index(("pod", "chains"))]
    e = chain_ensemble_mesh(world // 2, 2, device=CPU)
    out["ensemble"] = [e.axis_names, e.shape, e.axis_index("chains"), e.axis_index("ensemble")]
    out["errors"] = [_errors(lambda: pod_mesh(3, device=CPU)),
                     _errors(lambda: pod_mesh(2, world, device=CPU)),
                     _errors(lambda: chain_ensemble_mesh(world, 2, device=CPU)),
                     _errors(lambda: chain_mesh(world + 1, device=CPU)),
                     _errors(lambda: m.axis_index("ensemble"))]
    return out


def _chain_runs(out: dict) -> None:
    """The sharded Cu(100) run (16 chains) and the hierarchical one on a
    pod mesh, gathered, beside the unsharded run with the same generator;
    the canonical prepare of a block."""
    sys_ = cu100_eam(device=CPU)
    cfg = EngineConfig(sweep_size=4, record_positions=False)
    run_fn = make_run_fn(sys_.run.d, sys_.run.state_energy_fn, cfg)
    states = sys_.run.init_state(n_chains=N_CHAINS)
    temps = geometric_schedule(1.0, 2, 0.9)
    ref_state, ref_rec = run_fn(states, temps, make_generator(1, CPU))
    out["unsharded.site_state"] = ref_state.site_state.numpy()
    out["unsharded.energy"] = ref_rec.energy.numpy()

    mesh = chain_mesh(device=CPU)
    srun = make_sharded_chain_run(run_fn, mesh)
    got = gather_chain_states(srun(shard_chain_states(states, mesh), temps,
                                   make_generator(1, CPU)), mesh)
    out["sharded.site_state"] = got[0].site_state.numpy()
    out["sharded.energy"] = got[1].energy.numpy()

    pods = pod_mesh(2, device=CPU)
    axes = ("pod", "chains")
    hrun = make_hierarchical_chain_run(run_fn, pods)
    got = gather_chain_states(hrun(shard_chain_states(states, pods, axes), temps,
                                   make_generator(1, CPU)), pods, axes)
    out["hier.site_state"] = got[0].site_state.numpy()
    out["hier.energy"] = got[1].energy.numpy()

    # per-chain temperatures: each block takes its rows
    ladder = torch.linspace(0.5, 2.0, N_CHAINS)[:, None].expand(N_CHAINS, 2).contiguous()
    prun = make_sharded_chain_run(run_fn, mesh, share_temps=False)
    got = gather_chain_states(prun(shard_chain_states(states, mesh),
                                   shard_chain_states(ladder, mesh), make_generator(2, CPU)),
                              mesh)
    ref = run_fn(states, ladder, make_generator(2, CPU))
    out["ladder.equal"] = np.asarray(torch.equal(got[0].site_state, ref[0].site_state))

    # canonical prepare: the block steps until every chain of the batch is
    # full (one all-reduce a step); the generators stay in step
    prep = prepare_canonical_fn(sys_.run.d, sys_.run.state_energy_fn, 3, cfg)
    gen_ref, gen_blk = make_generator(3, CPU), make_generator(3, CPU)
    ref = prep(states, 1.0, gen_ref)
    block = chain_block(mesh, "chains", N_CHAINS // mesh.axis_size("chains"))
    got = prep(shard_chain_states(states, mesh), 1.0, gen_blk, chain_block=block,
               group=mesh.group("chains")[0])
    out["prep.site_state"] = gather_chain_states(got, mesh).site_state.numpy()
    out["prep.ref"] = ref.site_state.numpy()
    out["prep.next_draw"] = np.asarray([float(torch.rand((), generator=gen_ref)),
                                        float(torch.rand((), generator=gen_blk))])


def _ensemble_energy(refs, out: dict) -> None:
    cfg = PaiNNConfig(**ENSEMBLE_PAINN)
    params = _tree(refs, "ens_energy_params.")
    mesh = chain_mesh(axis="ensemble", device=CPU)

    def member_energy(p, positions, numbers, shifts):
        return painn_apply_structures(p, cfg, positions, numbers, shifts)["energy"].T

    fn = make_ensemble_sharded_energy(member_energy, mesh)
    mean, members = fn(params, torch.as_tensor(refs["ens_energy.positions"])[None],
                       torch.as_tensor(refs["ens_energy.numbers"], dtype=torch.int64)[None],
                       torch.zeros((1, 1, 3)))
    out["ens_energy.members"] = members[:, 0].numpy()
    out["ens_energy.mean"] = mean.numpy()


def _leaves_flat(tree) -> torch.Tensor:
    return torch.cat([x.detach().reshape(-1) for x in tree_leaves(tree)])


def _training(refs, out: dict, world: int) -> None:
    cfg = PaiNNConfig(**PAINN)
    mesh = chain_mesh(device=CPU)

    # data parallel: one step on the 8-frame batch
    trainer = Trainer(_tree(refs, "dp_params."), cfg, TrainConfig())
    step = make_sharded_train_step(trainer, mesh)
    loss = step(batch_to_device(_batch(refs, "batch8"), CPU))
    out["dp.loss"] = loss.numpy()
    for k, v in _flatten(trainer.params()).items():
        out[f"dp.params.{k}"] = v
    # every rank holds the same parameters after the update
    flat = _leaves_flat(trainer.params())
    everyone = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(everyone, flat)
    out["dp.replicas_equal"] = np.asarray(all(torch.equal(flat, x) for x in everyone))

    # ensemble parallel: 8 members, each rank trains its block
    stacked = _tree(refs, "ens_params.")
    trainer = Trainer(shard_chain_states(stacked, mesh), cfg, TrainConfig(), ensemble=True)
    step = make_ensemble_sharded_train_step(trainer, mesh)
    losses = step(batch_to_device(_batch(refs, "batch4"), CPU))
    out["ens.losses"] = losses.numpy()
    for k, v in _flatten(gather_chain_states(trainer.params(), mesh)).items():
        out[f"ens.params.{k}"] = v

    # the epoch loop, data- and member-parallel, and its two errors
    cfg = PaiNNConfig(**LOOP_PAINN)
    tcfg = TrainConfig(epochs=2, learning_rate=3e-3)
    _, hist = train_sharded(_tree(refs, "loop_params."), cfg, [_batch(refs, "batch8")], tcfg,
                            mesh)
    out["loop.history"] = np.asarray(hist)
    _, hist = train_sharded(_tree(refs, "loop_ens_params."), cfg, [_batch(refs, "batch4")], tcfg,
                            mesh, ensemble=True)
    out["loop_ens.history"] = np.asarray(hist)
    ragged = _batch(refs, "batch8")
    ragged = PaddedBatch(*(None if x is None else x[:6 if world == 4 else 5] for x in ragged))
    out["errors.ragged"] = np.asarray(_errors(lambda: train_sharded(
        _tree(refs, "loop_params."), cfg, [ragged], tcfg, mesh)))
    odd = {k: v[:world - 1] for k, v in refs.items() if k.startswith("loop_ens_params.")}
    out["errors.members"] = np.asarray(_errors(lambda: train_sharded(
        _tree(odd, "loop_ens_params."), cfg, [_batch(refs, "batch4")], tcfg, mesh,
        ensemble=True)))


def run_checks(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    world = dist.get_world_size()
    with np.load(Path(workdir) / "refs.npz") as f:
        refs = {k: f[k] for k in f.files}
    out: dict = {}
    meshes = _mesh_checks(world)
    _chain_runs(out)
    _ensemble_energy(refs, out)
    _training(refs, out, world)
    if rank == 0:
        np.savez(Path(workdir) / f"world{world}.npz", **out)
        (Path(workdir) / f"world{world}_meshes.json").write_text(json.dumps(meshes))


def chgnet_batch(n_frames: int = 4) -> PaddedBatch:
    """Random MnO frames (5 or 6 atoms in a 7 A cube) with random energy,
    force and magmom labels from ``np.random.default_rng(9)``."""
    rng = np.random.default_rng(9)
    structures, energies, forces, magmoms = [], [], [], []
    for b in range(n_frames):
        n = 5 + b % 2
        structures.append(Structure(np.asarray(([25, 8] * n)[:n]), rng.uniform(0, 7.0, (n, 3)),
                                    np.eye(3) * 7.0))
        energies.append(float(rng.normal()))
        forces.append(rng.normal(size=(n, 3)))
        magmoms.append(rng.normal(size=n))
    return pad_structures(structures, energies, forces, CHGNET.atom_graph_cutoff,
                          magmoms=magmoms)


def run_chgnet_training(rank: int, workdir: str) -> None:
    """Two epochs of a tiny CHGNet with the magmom term on 4 frames, by
    ``train_sharded(apply_fn=chgnet_apply_structures)`` (data-parallel over
    the world) and by the unsharded ``train_painn``; rank 0 writes both
    histories and both trained trees to ``workdir/chgnet_world{W}.npz``."""
    torch.set_num_threads(1)
    tcfg = TrainConfig(epochs=2, learning_rate=3e-3, magmom_weight=0.5)
    batch = chgnet_batch()

    def fresh():
        return init_chgnet(torch.Generator().manual_seed(0), CHGNET)

    p_sh, h_sh = train_sharded(fresh(), CHGNET, [batch], tcfg, chain_mesh(device=CPU),
                               apply_fn=chgnet_apply_structures)
    p_un, h_un = train_painn(fresh(), CHGNET, [batch], tcfg, apply_fn=chgnet_apply_structures)
    if rank == 0:
        out = {"sharded.history": np.asarray(h_sh), "unsharded.history": np.asarray(h_un)}
        out.update({f"sharded.params.{k}": v for k, v in _flatten(p_sh).items()})
        out.update({f"unsharded.params.{k}": v for k, v in _flatten(p_un).items()})
        np.savez(Path(workdir) / f"chgnet_world{dist.get_world_size()}.npz", **out)


def run_nccl_world_one(rank: int, workdir: str) -> None:
    """On the card, in a world of one NCCL rank: the sharded Cu(100) run of
    64 chains against the unsharded run with the same generator; writes
    ``workdir/nccl_world_one.ok`` ("bitwise") when they agree bit for bit."""
    mesh = chain_mesh()
    sys_ = cu100_eam(device=mesh.device)
    run_fn = make_run_fn(sys_.run.d, sys_.run.state_energy_fn,
                         EngineConfig(sweep_size=4, record_positions=False))
    states = sys_.run.init_state(n_chains=64)
    temps = geometric_schedule(1.0, 2, 0.9)
    ref = run_fn(states, temps, make_generator(1, mesh.device))
    got = gather_chain_states(make_sharded_chain_run(run_fn, mesh)(
        shard_chain_states(states, mesh), temps, make_generator(1, mesh.device)), mesh)
    same = all(torch.equal(a, b) for a, b in zip(
        (ref[0].site_state, ref[0].energy, ref[1].energy),
        (got[0].site_state, got[0].energy, got[1].energy)))
    (Path(workdir) / "nccl_world_one.ok").write_text("bitwise" if same else "differs")
