"""Training data, checkpoints and the fine-tuning CLI of the port (slice 7)
against the JAX package on the CPU.

The loaders read JSON-list, MPtrj and npz datasets written here and must
give the JAX package's structures, labels and train / val / test splits
for the same seed, padded into equal arrays. Checkpoints round-trip in
both directions with equal parameters and energies (energies within 1e-5
relative: the two packages' f32 forwards sum in other orders).
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.models import painn as jpainn
from surface_sampling_tpu.models import train as jtrain
from surface_sampling_tpu.models.convert_nff import load_params_npz, save_params_npz
from surface_sampling_tpu.models.dataset import (
    get_train_val_test_loader as j_loader,
)
from surface_sampling_tpu.models.dataset import (
    load_labelled_structures as j_load,
)
from surface_sampling_tpu.models.dataset import (
    make_clustering_dataset as j_clustering,
)
from surface_sampling_tpu.structure.atoms import Structure as JStructure
from surface_sampling_tpu_torch.cli import finetune
from surface_sampling_tpu_torch.models import dataset as tds
from surface_sampling_tpu_torch.models import train as ttrain
from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    painn_apply_structures,
    stack_members,
)
from surface_sampling_tpu_torch.models.weights import (
    from_jax_params,
    load_painn_npz,
    save_painn_npz,
)
from surface_sampling_tpu_torch.structure.atoms import Structure

SYMBOLS = ["O", "Ti", "Sr", "O"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(n_frames=7, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_frames):
        n = 4 + i % 3
        box = np.diag(rng.uniform(5.0, 7.0, 3))
        recs.append({"symbols": [SYMBOLS[a % 4] for a in range(n)],
                     "positions": (rng.uniform(0, 1, (n, 3)) @ box).tolist(),
                     "cell": box.tolist(), "energy": float(rng.normal()),
                     "forces": rng.normal(size=(n, 3)).tolist()})
    return recs


def _write_datasets(tmp_path):
    recs = _records()
    flat = tmp_path / "flat.json"
    flat.write_text(json.dumps(recs))
    with_numbers = [dict(r, numbers=[{"O": 8, "Ti": 22, "Sr": 38}[s] for s in r["symbols"]])
                    for r in recs[:3]]
    for r in with_numbers:
        del r["symbols"]
    (tmp_path / "numbers.json").write_text(json.dumps(with_numbers))
    mptrj = {}
    for i, r in enumerate(recs):
        cell = np.asarray(r["cell"])
        frac = np.linalg.solve(cell.T, np.asarray(r["positions"]).T).T
        frame = {"structure": {"lattice": {"matrix": r["cell"]},
                               "sites": [{"species": [{"element": s}], "abc": f.tolist()}
                                         for s, f in zip(r["symbols"], frac)]},
                 "energy_per_atom": r["energy"] / len(r["symbols"]), "force": r["forces"]}
        if i % 2:
            frame["magmom"] = [0.1 * a for a in range(len(r["symbols"]))]
        mptrj.setdefault(f"mp-{i // 3}", {})[f"{i}"] = frame
    shards = tmp_path / "shards"
    shards.mkdir()
    (shards / "a.json").write_text(json.dumps({k: v for k, v in mptrj.items() if k == "mp-0"}))
    (shards / "b.json").write_text(json.dumps({k: v for k, v in mptrj.items() if k != "mp-0"}))
    same = [r for r in recs if len(r["symbols"]) == 4]
    npz = tmp_path / "frames.npz"
    np.savez(npz, numbers=np.asarray([[{"O": 8, "Ti": 22, "Sr": 38}[s] for s in r["symbols"]]
                                      for r in same]),
             positions=np.asarray([r["positions"] for r in same]),
             cells=np.asarray([r["cell"] for r in same]),
             energies=np.asarray([r["energy"] for r in same]),
             forces=np.asarray([r["forces"] for r in same]))
    return {"flat": flat, "numbers": tmp_path / "numbers.json", "mptrj": shards, "npz": npz}


@pytest.mark.parametrize("kind", ["flat", "numbers", "mptrj", "npz"])
def test_loaders_and_splits_match_jax(tmp_path, kind):
    path = _write_datasets(tmp_path)[kind]
    t = tds.load_labelled_structures(path, with_magmoms=True)
    j = j_load(path, with_magmoms=True)
    assert len(t[0]) == len(j[0]) > 0
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(a.numbers, b.numbers)
        np.testing.assert_allclose(a.positions, b.positions, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(a.cell, b.cell)
    np.testing.assert_array_equal(t[1], j[1])
    for a, b in zip(t[2], j[2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t[3], j[3]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    got = tds.get_train_val_test_loader(path, 4.0, batch_size=2, seed=3)
    want = j_loader(path, 4.0, batch_size=2, seed=3)
    for tb, jb in zip(got, want):
        assert len(tb) == len(jb)
        for x, y in zip(tb, jb):
            for a, b in zip(x, y):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_pad_structures_and_scoring_batches_match_jax():
    recs = _records(5, seed=1)
    ts = [Structure.from_symbols(r["symbols"], r["positions"], r["cell"]) for r in recs]
    js = [JStructure.from_symbols(r["symbols"], r["positions"], r["cell"]) for r in recs]
    np.testing.assert_allclose(ts[0].scaled_positions, js[0].scaled_positions, atol=1e-14)
    e = [r["energy"] for r in recs]
    f = [np.asarray(r["forces"]) for r in recs]
    mags = [None, np.ones(len(recs[1]["symbols"])), None, None, None]
    for kw in ({}, {"n_max": 9, "k_max": 40, "magmoms": mags}):
        a = ttrain.pad_structures(ts, e, f, 4.5, **kw)
        b = jtrain.pad_structures(js, e, f, 4.5, **kw)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    centers = [[0, 1], [2], [0], [1, 3], [0, 2]]
    tb, tm = tds.make_clustering_dataset(ts, centers, 4.5)
    jb, jm = j_clustering(js, centers, 4.5)
    np.testing.assert_array_equal(tm, jm)
    for x, y in zip(tb, jb):
        if x is not None:
            np.testing.assert_array_equal(x, y)


def _energies_port(tree, cfg, batch):
    params = stack_members([from_jax_params(tree, "cpu")])
    b = ttrain.batch_to_device(batch, "cpu")
    return painn_apply_structures(params, cfg, b.positions, b.numbers, b.shifts)["energy"][:, 0]


def _energies_jax(params, cfg, batch):
    return np.asarray([float(jpainn.painn_apply(
        params, cfg, jnp.asarray(batch.positions[i], jnp.float32), jnp.asarray(batch.numbers[i]),
        jnp.asarray(batch.numbers[i] > 0), jnp.asarray(batch.shifts[i], jnp.float32))["energy"])
        for i in range(len(batch.energy))])


def test_checkpoints_round_trip_both_ways(tmp_path):
    """A checkpoint the JAX package writes (its config carries the TPU-only
    message_mode and pallas_routing) loads in the port, and one the port
    writes loads in the JAX package: equal parameters, equal energies."""
    jcfg = jpainn.PaiNNConfig(feat_dim=8, n_rbf=4, n_layers=1, readout_hidden=4)
    jparams = jpainn.init_painn(jax.random.PRNGKey(0), jcfg)
    save_params_npz(tmp_path / "jax.npz", jparams, jcfg)
    tree, cfg = load_painn_npz(tmp_path / "jax.npz")
    assert cfg == PaiNNConfig(feat_dim=8, n_rbf=4, n_layers=1, readout_hidden=4)
    recs = _records(3, seed=2)
    batch = ttrain.pad_structures(
        [Structure.from_symbols(r["symbols"], r["positions"], r["cell"]) for r in recs],
        [0.0] * 3, [np.zeros((len(r["symbols"]), 3)) for r in recs], cfg.cutoff)
    e_jax = _energies_jax(jparams, jcfg, batch)
    np.testing.assert_allclose(_energies_port(tree, cfg, batch).numpy(), e_jax, rtol=1e-5)

    stacked = stack_members([from_jax_params(tree, "cpu")] * 2)
    save_painn_npz(tmp_path / "port.npz", stacked, cfg, member=1)
    back, back_cfg = load_params_npz(tmp_path / "port.npz")
    assert back_cfg == jpainn.PaiNNConfig(feat_dim=8, n_rbf=4, n_layers=1, readout_hidden=4)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(_energies_jax(back, back_cfg, batch), e_jax)


def test_finetune_cli_on_cpu(tmp_path, capsys):
    """The CLI on the CPU: two epochs from a fresh 2-member ensemble and
    from a checkpoint; the four output files, a model that loads back, and
    a fresh CHGNet or MACE ensemble (the PaiNN path only, as in the JAX
    CLI), and --mesh 2 without a world of two ranks, exit with a message."""
    data = _write_datasets(tmp_path)["flat"]
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"feat_dim": 8, "n_rbf": 4, "n_layers": 1, "readout_hidden": 4, "cutoff": 4.0,
         "message_mode": "pallas"}))
    out = tmp_path / "ens"
    finetune.main(["--data", str(data), "--config", str(tmp_path / "cfg.json"), "--out",
                   str(out), "--epochs", "2", "--batch-size", "3", "--ensemble", "2",
                   "--device", "cpu"])
    for name in ("model_01.npz", "model_02.npz", "history.csv", "metrics.json",
                 "settings.json"):
        assert (out / name).exists(), name
    rows = list(csv.reader((out / "history.csv").open()))
    assert rows[0] == ["epoch", "train_loss"] and len(rows) == 3
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["epochs"] == 2 and np.isfinite(metrics["final_train_loss"])
    assert json.loads((out / "settings.json").read_text())["ensemble"] == 2

    out1 = tmp_path / "one"
    finetune.main(["--data", str(data), "--init", str(out / "model_02.npz"), "--out",
                   str(out1), "--epochs", "2", "--lr", "1e-3", "--device", "cpu"])
    tree, cfg = load_painn_npz(out1 / "model.npz")
    assert cfg.feat_dim == 8 and set(tree) == {"atom_embed", "message", "update", "readout"}
    assert "Output folder" in capsys.readouterr().out
    for extra, match in ((["--family", "chgnet", "--ensemble", "2"], "PaiNN-ensemble path"),
                         (["--family", "mace", "--ensemble", "2"], "PaiNN-ensemble path"),
                         (["--mesh", "2"], "torchrun --nproc-per-node 2")):
        with pytest.raises(SystemExit, match=match):
            finetune.main(["--data", str(data), "--out", str(tmp_path / "x"), "--device",
                           "cpu", *extra])
