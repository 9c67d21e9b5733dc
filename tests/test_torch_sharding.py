"""Sharding on torch.distributed (``parallel/mesh.py``, ``parallel/chains.py``,
``parallel/training.py``, ``cli/finetune.py --mesh``) against the port's
unsharded runs and the JAX package's sharded steps, on the CPU.

Two gloo worlds, of 4 and of 2 ranks, are spawned on this host (their
ranks meet through a ``FileStore`` under ``tmp_path``); each rank runs the
checks of ``tests/torch_sharding_ranks.py``, which import no JAX, and rank
0 writes the gathered results. The JAX references are computed here, in
the parent, on the 8 virtual devices of ``tests/conftest.py``, and passed
to the ranks by file. Tolerances:

* a sharded chain run against the unsharded run with the same generator,
  chain for chain: occupancies equal, energies rtol 1e-5 (the JAX test's);
* the data-parallel and ensemble-sharded train steps against JAX's
  ``make_sharded_train_step`` / ``make_ensemble_sharded_train_step`` with
  ``optax.chain(clip_by_global_norm, adam)``: loss and every parameter leaf
  rtol 1e-5 / atol 1e-6 (``tests/test_parallel.py``'s);
* ``train_sharded``'s loss history against JAX's over 2 epochs: rtol 1e-4;
* the sharded ensemble energy against JAX's: rtol 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh
from torch_sharding_ranks import (
    ENSEMBLE_PAINN,
    LOOP_PAINN,
    PAINN,
    run_checks,
    run_chgnet_training,
)

from surface_sampling_tpu.models.painn import PaiNNConfig as JPaiNNConfig
from surface_sampling_tpu.models.painn import init_painn as j_init_painn
from surface_sampling_tpu.models.painn import painn_apply as j_painn_apply
from surface_sampling_tpu.models.train import TrainConfig as JTrainConfig
from surface_sampling_tpu.models.train import init_ensemble as j_init_ensemble
from surface_sampling_tpu.models.train import make_loss_fn as j_make_loss_fn
from surface_sampling_tpu.models.train import pad_structures as j_pad_structures
from surface_sampling_tpu.parallel import chain_mesh as j_chain_mesh
from surface_sampling_tpu.parallel import make_ensemble_sharded_train_step as j_ens_step
from surface_sampling_tpu.parallel import make_sharded_train_step as j_dp_step
from surface_sampling_tpu.parallel import train_sharded as j_train_sharded
from surface_sampling_tpu.parallel.chains import make_ensemble_sharded_energy as j_ens_energy
from surface_sampling_tpu.potentials import make_lennard_jones as j_make_lennard_jones
from surface_sampling_tpu.structure.atoms import Structure as JStructure
from surface_sampling_tpu_torch.cli import finetune
from surface_sampling_tpu_torch.models.weights import _flatten, load_painn_npz
from surface_sampling_tpu_torch.parallel import spawn_ranks

WORLDS = (4, 2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _lj_batch(B, n=6):
    """B frames of a tiny LJ gas with self-consistent labels
    (``tests/test_parallel.py``'s ``_tiny_lj_batch``), as numpy arrays."""
    pot = j_make_lennard_jones(epsilon=0.4, sigma=2.0, cutoff=6.0)
    rng = np.random.default_rng(3)
    structures, energies, forces = [], [], []
    for _ in range(B):
        pos = rng.uniform(0, 6.0, (n, 3))
        for _ in range(40):
            d = pos[:, None] - pos[None, :]
            r = np.linalg.norm(d, axis=-1) + np.eye(n) * 10
            if r.min() > 1.8:
                break
            i, j = np.unravel_index(np.argmin(r), r.shape)
            pos[i] += 0.3 * (pos[i] - pos[j]) / max(r[i, j], 0.5)
        structures.append(JStructure.from_symbols(["Ar"] * n, pos, np.eye(3) * 100.0))
        e, f = pot.energy_and_forces(jnp.asarray(pos, jnp.float32), jnp.zeros(n, jnp.int32),
                                     jnp.ones(n, bool), jnp.zeros((1, 3)))
        energies.append(float(e))
        forces.append(np.asarray(f))
    b = j_pad_structures(structures, energies, forces, cutoff=6.0)
    return {f: np.asarray(getattr(b, f), np.float32 if f != "numbers" else np.int32)
            for f in ("positions", "numbers", "shifts", "energy", "forces")}


def _jbatch(b):
    from surface_sampling_tpu.models.train import PaddedBatch

    return PaddedBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def _np_tree(tree, prefix):
    return {prefix + k: v for k, v in _flatten(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Inputs and the JAX package's sharded results, written for the
    ranks."""
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    work = tmp_path_factory.mktemp("sharding")
    out = {}
    cfg = JPaiNNConfig(**PAINN)
    b8, b4 = _lj_batch(8), _lj_batch(4)
    for name, b in (("batch8", b8), ("batch4", b4)):
        out.update({f"{name}.{k}": v for k, v in b.items()})
    tcfg = JTrainConfig()
    loss_fn = j_make_loss_fn(cfg, tcfg)
    opt = optax.chain(optax.clip_by_global_norm(tcfg.grad_clip), optax.adam(tcfg.learning_rate))
    mesh = j_chain_mesh(8)

    params = j_init_painn(jax.random.PRNGKey(0), cfg)
    out.update(_np_tree(params, "dp_params."))
    p, _, loss = j_dp_step(loss_fn, opt, mesh)(params, opt.init(params), _jbatch(b8))
    out.update(_np_tree(p, "jax.dp.params."))
    out["jax.dp.loss"] = np.asarray(loss)

    ens = j_init_ensemble(jax.random.PRNGKey(1), cfg, 8)
    out.update(_np_tree(ens, "ens_params."))
    p, _, losses = j_ens_step(loss_fn, opt, mesh)(ens, jax.vmap(opt.init)(ens), _jbatch(b4))
    out.update(_np_tree(p, "jax.ens.params."))
    out["jax.ens.losses"] = np.asarray(losses)

    cfg = JPaiNNConfig(**LOOP_PAINN)
    loop = j_init_painn(jax.random.PRNGKey(2), cfg)
    loop_ens = j_init_ensemble(jax.random.PRNGKey(3), cfg, 8)
    out.update(_np_tree(loop, "loop_params."))
    out.update(_np_tree(loop_ens, "loop_ens_params."))
    lcfg = JTrainConfig(epochs=2, learning_rate=3e-3)
    out["jax.loop.history"] = np.asarray(j_train_sharded(loop, cfg, [_jbatch(b8)], lcfg,
                                                         mesh=mesh)[1])
    out["jax.loop_ens.history"] = np.asarray(j_train_sharded(loop_ens, cfg, [_jbatch(b4)], lcfg,
                                                             mesh=mesh, ensemble=True)[1])

    ecfg = JPaiNNConfig(**ENSEMBLE_PAINN)
    eparams = j_init_ensemble(jax.random.PRNGKey(0), ecfg, 8)
    out.update(_np_tree(eparams, "ens_energy_params."))
    pos = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (5, 3))) * 3.0
    numbers = np.asarray([8, 8, 22, 38, 8], np.int32)
    out["ens_energy.positions"], out["ens_energy.numbers"] = pos.astype(np.float32), numbers

    def member_energy(p, positions, numbers, alive, shifts):
        return j_painn_apply(p, ecfg, positions, numbers, alive, shifts)["energy"]

    mean, members = j_ens_energy(member_energy, Mesh(np.array(jax.devices()[:8]), ("ensemble",)))(
        eparams, jnp.asarray(pos, jnp.float32), jnp.asarray(numbers), jnp.ones(5, bool),
        jnp.zeros((1, 3)))
    out["jax.ens_energy.members"], out["jax.ens_energy.mean"] = np.asarray(members), float(mean)
    np.savez(work / "refs.npz", **out)
    return work, out


@pytest.fixture(scope="module")
def worlds(refs):
    """Spawn the two gloo worlds; each rank runs ``run_checks``."""
    work, _ = refs
    got = {}
    for world in WORLDS:
        spawn_ranks(run_checks, world, "cpu", args=(str(work),))
        with np.load(work / f"world{world}.npz") as f:
            got[world] = {k: f[k] for k in f.files}
        got[world]["meshes"] = json.loads((work / f"world{world}_meshes.json").read_text())
    return got


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes_names_and_errors(worlds, world):
    m = worlds[world]["meshes"]
    assert m["chain"] == [["chains"], {"chains": world}, list(range(world))]
    assert m["pod"][:3] == [["pod", "chains"], {"pod": 2, "chains": world // 2},
                            np.arange(world).reshape(2, world // 2).tolist()]
    assert m["pod"][3] == 0                      # rank 0's place, pod-major
    assert m["ensemble"] == [["chains", "ensemble"], {"chains": world // 2, "ensemble": 2}, 0, 0]
    assert m["errors"] == [f"{world} ranks do not split into 3 pods",
                           f"need {2 * world} ranks, have {world}",
                           f"need {2 * world} ranks, have {world}",
                           f"need {world + 1} ranks, have {world}",
                           "axis 'ensemble' is not a name of the mesh ('chains',) or all of "
                           "them in order"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_chain_runs_match_the_unsharded_run(worlds, world):
    """Sharded (chain_mesh) and hierarchical (pod_mesh) Cu(100) runs of 16
    chains, gathered, against the unsharded run with the same generator;
    per-chain temperatures; the canonical prepare of a block keeps the
    generator in step with the unsharded prepare."""
    w = worlds[world]
    for tag in ("sharded", "hier"):
        np.testing.assert_array_equal(w[f"{tag}.site_state"], w["unsharded.site_state"])
        np.testing.assert_allclose(w[f"{tag}.energy"], w["unsharded.energy"], rtol=1e-5)
    assert np.isfinite(w["unsharded.energy"]).all()
    assert not (w["unsharded.site_state"] == w["unsharded.site_state"][0]).all()
    assert bool(w["ladder.equal"])
    np.testing.assert_array_equal(w["prep.site_state"], w["prep.ref"])
    assert ((w["prep.ref"] > 0).sum(axis=1) >= 3).all()
    assert w["prep.next_draw"][0] == w["prep.next_draw"][1]


@pytest.mark.parametrize("world", WORLDS)
def test_ensemble_sharded_energy_matches_jax(refs, worlds, world):
    _, r = refs
    w = worlds[world]
    np.testing.assert_allclose(w["ens_energy.members"], r["jax.ens_energy.members"], rtol=1e-5)
    np.testing.assert_allclose(w["ens_energy.mean"][0], r["jax.ens_energy.mean"], rtol=1e-5)


def _assert_params(w, r, port_prefix, jax_prefix):
    keys = sorted(k[len(jax_prefix):] for k in r if k.startswith(jax_prefix))
    assert keys and keys == sorted(k[len(port_prefix):] for k in w if k.startswith(port_prefix))
    for k in keys:
        np.testing.assert_allclose(w[port_prefix + k], r[jax_prefix + k], err_msg=k, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_train_step_matches_jax(refs, worlds, world):
    """One data-parallel step: the averaged loss and every parameter after
    the clipped Adam update, the same on every rank."""
    _, r = refs
    w = worlds[world]
    np.testing.assert_allclose(w["dp.loss"][0], r["jax.dp.loss"], **TOL)
    _assert_params(w, r, "dp.params.", "jax.dp.params.")
    assert bool(w["dp.replicas_equal"])


@pytest.mark.parametrize("world", WORLDS)
def test_ensemble_sharded_train_step_matches_jax(refs, worlds, world):
    _, r = refs
    w = worlds[world]
    np.testing.assert_allclose(w["ens.losses"], r["jax.ens.losses"], **TOL)
    _assert_params(w, r, "ens.params.", "jax.ens.params.")


@pytest.mark.parametrize("world", WORLDS)
def test_train_sharded_matches_jax(refs, worlds, world):
    """Two epochs of the epoch loop, data- and member-parallel, against
    JAX's; its two divisibility errors."""
    _, r = refs
    w = worlds[world]
    np.testing.assert_allclose(w["loop.history"], r["jax.loop.history"], rtol=1e-4)
    np.testing.assert_allclose(w["loop_ens.history"], r["jax.loop_ens.history"], rtol=1e-4)
    assert f"divisible by the {world}-device 'chains' mesh axis" in str(w["errors.ragged"])
    assert f"member count ({world - 1}) divisible by the {world}-device" in str(
        w["errors.members"])


def test_train_sharded_chgnet_matches_unsharded(tmp_path):
    """A gloo world of 2: two epochs of a tiny CHGNet with the magmom term,
    data-parallel through train_sharded(apply_fn=chgnet_apply_structures),
    against the unsharded train_painn on the same 4 frames: loss history
    rtol 1e-4 (the per-rank block means average to the batch mean in
    another f32 order, which Adam's steps carry), every trained leaf within
    1e-3 x its max, as the JAX package's sharded steps are held to its
    unsharded ones."""
    spawn_ranks(run_chgnet_training, 2, "cpu", args=(str(tmp_path),))
    with np.load(tmp_path / "chgnet_world2.npz") as f:
        w = {k: f[k] for k in f.files}
    np.testing.assert_allclose(w["sharded.history"], w["unsharded.history"], rtol=1e-4)
    assert w["sharded.history"][-1] < w["sharded.history"][0]
    keys = [k[len("unsharded.params."):] for k in w if k.startswith("unsharded.params.")]
    assert keys
    for k in keys:
        want = w[f"unsharded.params.{k}"]
        np.testing.assert_allclose(w[f"sharded.params.{k}"], want, rtol=0,
                                   atol=1e-3 * max(float(np.abs(want).max()), 1e-6), err_msg=k)


def test_finetune_mesh_one_on_cpu(tmp_path, capsys):
    """finetune --mesh 1 --device cpu makes a world of one, trains through
    the data-parallel step, writes its files and ends the world."""
    import torch.distributed as dist

    b = _lj_batch(6)
    frames = [{"numbers": b["numbers"][i].tolist(), "positions": b["positions"][i].tolist(),
               "cell": (np.eye(3) * 100.0).tolist(), "energy": float(b["energy"][i]),
               "forces": b["forces"][i].tolist()} for i in range(6)]
    (tmp_path / "data.json").write_text(json.dumps(frames))
    (tmp_path / "cfg.json").write_text(json.dumps({**PAINN, "readout_hidden": 8}))
    out = tmp_path / "run"
    finetune.main(["--data", str(tmp_path / "data.json"), "--config", str(tmp_path / "cfg.json"),
                   "--out", str(out), "--epochs", "2", "--batch-size", "4", "--train-ratio",
                   "1.0", "--val-ratio", "0.0", "--mesh", "1", "--device", "cpu"])
    assert not dist.is_initialized()
    metrics = json.loads((out / "metrics.json").read_text())
    assert np.isfinite(metrics["final_train_loss"]) and metrics["epochs"] == 2
    tree, cfg = load_painn_npz(out / "model.npz")
    assert cfg.feat_dim == PAINN["feat_dim"] and tree["atom_embed"].shape == (100, 16)
    assert "Trained painn for 2 epochs" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="drop --ensemble or --mesh"):
        finetune.main(["--data", str(tmp_path / "data.json"), "--out", str(tmp_path / "x"),
                       "--mesh", "1", "--ensemble", "2", "--device", "cpu"])


def test_train_sharded_refuses_other_families():
    """A CHGNet or MACE configuration trains through its family's apply_fn:
    without one (the PaiNN path) sharded training refuses it before it
    touches the mesh."""
    from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig
    from surface_sampling_tpu_torch.models.mace import MACEConfig
    from surface_sampling_tpu_torch.models.train import TrainConfig
    from surface_sampling_tpu_torch.parallel import train_sharded

    for cfg in (CHGNetConfig(), MACEConfig()):
        with pytest.raises(ValueError, match="apply_fn=None is PaiNN"):
            train_sharded({}, cfg, [], TrainConfig(), mesh=None)
