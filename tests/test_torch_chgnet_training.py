"""CHGNet and MACE force-loss training of the port (``models/train.py``,
``ops/chgnet_kernels.py``'s twice-differentiable atom conv,
``models.chgnet.chgnet_apply_structures``, ``models.weights.save_chgnet_npz``,
``cli/finetune.py --family``) against the JAX package on the CPU.

Inputs are made from a seed with numpy; JAX parameters are carried across
(``from_jax_params``) and every JAX reference runs under one jit. The JAX
side runs CHGNet in its "gather" conv mode (XLA, f32). Tolerances:

* grad-of-grad of the atom conv against the second order of JAX's
  ``_conv_ref``: 1e-4, the JAX test's own for the f32 routing
  (``tests/test_chgnet.py``'s second-order test);
* the loss: 1e-5 relative; every gradient leaf within 1e-3 x max|JAX| of
  that leaf (f32 sums in other orders through two differentiations);
* loss histories of a few Adam epochs: 1e-4 relative (per-step
  differences compound), as ``tests/test_torch_training.py`` holds PaiNN's.
"""

import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chgnet_kernels import F, _inputs, _jax_args, _live_halves, _torch_args

from surface_sampling_tpu.models import chgnet as jchgnet
from surface_sampling_tpu.models import mace as jmace
from surface_sampling_tpu.models import train as jtrain
from surface_sampling_tpu.models.convert_chgnet import load_chgnet_npz as j_load_chgnet_npz
from surface_sampling_tpu.models.convert_chgnet import save_chgnet_npz as j_save_chgnet_npz
from surface_sampling_tpu.ops import pallas_chgnet as pc
from surface_sampling_tpu.structure.atoms import Structure as JStructure
from surface_sampling_tpu_torch.cli import finetune
from surface_sampling_tpu_torch.models import train as ttrain
from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig, chgnet_apply_structures
from surface_sampling_tpu_torch.models.mace import (
    MACEConfig,
    init_mace,
    load_mace_npz,
    mace_apply,
)
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, stack_members, tree_leaves
from surface_sampling_tpu_torch.models.painn import tree_map
from surface_sampling_tpu_torch.models.weights import _flatten, from_jax_params, load_chgnet_npz
from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
from surface_sampling_tpu_torch.ops.neighbors import reverse_table
from surface_sampling_tpu_torch.structure.atoms import Structure

CONV_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL, GRAD_RTOL, HIST_RTOL = 1e-5, 1e-3, 1e-4
BOX = 8.0
J_CHGNET = jchgnet.CHGNetConfig(atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16,
                                num_radial=7, num_angular=7, n_conv=2, max_neighbors=64,
                                max_bond_neighbors=8, mlp_hidden_dims=(16, 16, 16),
                                conv_mode="gather")
J_MACE = jmace.MACEConfig(feat_dim=12, n_rbf=5, cutoff=5.0, n_layers=2, max_neighbors=32,
                          readout_hidden=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _carry(jparams) -> dict:
    return from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")


def _frames(seed, n_atoms, magmom_frames=()):
    """Random periodic frames in an 8 A cube with random labels, as (port,
    JAX) structures, energies, forces and magmoms (None on frames not in
    ``magmom_frames``)."""
    rng = np.random.default_rng(seed)
    t, j, e, f, m = [], [], [], [], []
    for b, n in enumerate(n_atoms):
        pos = rng.uniform(0, BOX, (n, 3))
        numbers = np.asarray(([25, 8, 57, 8] * n)[:n], np.int32)
        t.append(Structure(numbers, pos, np.eye(3) * BOX))
        j.append(JStructure(numbers, pos, np.eye(3) * BOX))
        e.append(float(rng.normal()))
        f.append(rng.normal(size=(n, 3)))
        m.append(rng.normal(size=n) if b in magmom_frames else None)
    return t, j, e, f, m


def _jbatch(b):
    return jtrain.PaddedBatch(*(
        None if x is None else jnp.asarray(x, jnp.float32) if np.asarray(x).dtype.kind == "f"
        else jnp.asarray(x) for x in b))


def _port_loss_and_grads(params, cfg, tcfg, batch, apply_fn):
    """The port's loss of one model on a host batch and the gradient of
    every leaf (dotted keys, member axis dropped)."""
    stacked = stack_members([params])
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(stacked)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), stacked)
    loss = ttrain.make_loss_fn(cfg, tcfg, apply_fn)(p, ttrain.batch_to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    it = iter(grads)
    flat = _flatten(tree_map(lambda x: next(it), stacked))
    return float(loss[0].detach()), {k: None if v.ndim == 0 else v[0] for k, v in flat.items()}


def _assert_loss_and_grads(loss, grads, jloss, jgrads):
    """The loss within LOSS_RTOL; every leaf within GRAD_RTOL x max|JAX|
    (a leaf the port's graph does not reach must be 0 in JAX)."""
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jflat = _flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for k, want in jflat.items():
        scale = float(np.abs(want).max())
        if grads[k] is None:
            assert scale == 0.0, k
            continue
        np.testing.assert_allclose(grads[k], want, rtol=0, atol=GRAD_RTOL * scale, err_msg=k)


def test_conv_second_order_matches_jax():
    """grad-of-grad through chgnet_conv (an outer reverse pass over the
    inner VJP, the force loss's structure) against the second order of
    JAX's ``_conv_ref`` (the analog of ``tests/test_chgnet.py``'s
    second-order test at f32 routing), for every float input; the same
    with the neighbour gather routed through the edges' reverse table (the
    card's fixed-order path), and a third order raises."""
    rng = np.random.default_rng(21)
    n_pad = 16
    x = _inputs(rng, 1, n_pad)
    wout = rng.normal(size=(1, n_pad, F)).astype(np.float32)
    diff = [0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12]
    args0 = _torch_args(x)
    cg = [rng.normal(size=args0[i].shape).astype(np.float32) for i in diff]
    rev = reverse_table(args0[5], args0[4] != 0, n_pad)

    def port_second_order(rev_):
        args = [a.clone() for a in args0]
        for i in diff:
            args[i].requires_grad_(True)
        agg = ck.chgnet_conv(*args, rev_)
        g = torch.autograd.grad((agg * torch.as_tensor(wout)).sum(), [args[i] for i in diff],
                                create_graph=True)
        outer = sum((gi * torch.as_tensor(ci)).sum() for gi, ci in zip(g, cg))
        g2 = torch.autograd.grad(outer, [args[i] for i in diff], create_graph=True)
        return g2, args

    ja = _jax_args(x, 0)
    # the JAX weights are zero-extended: carry the outer cotangents into
    # that layout, then cut the second order back to the live halves
    jcg = _live_to_jax(cg)

    def outer(*a):
        def inner(*b):
            agg = pc._conv_ref(b[0], b[1], b[2], b[3], ja[4], ja[5], *b[4:])
            return jnp.sum(agg * wout[0])

        g = jax.grad(inner, argnums=tuple(range(len(a))))(*a)
        return sum(jnp.sum(gi * ci) for gi, ci in zip(g, jcg))

    want = _live_halves(jax.jit(jax.grad(outer, argnums=tuple(range(11))))(
        *(ja[i] for i in diff)))
    for rev_ in (None, rev):
        got, args = port_second_order(rev_)
        for k, name in enumerate(ck.GRAD_NAMES):
            np.testing.assert_allclose(got[k].detach().numpy().reshape(want[k].shape), want[k],
                                       err_msg=f"{name} rev={rev_ is not None}", **CONV_TOL)
    with pytest.raises(RuntimeError, match="differentiable twice"):
        torch.autograd.grad(got[0].sum(), args[0])


def _live_to_jax(cg):
    """Outer cotangents of the port's live-half weights in the JAX layout:
    (2F, F) second-layer weights zero-extended, (1, F) biases."""
    z = np.zeros((F, F), np.float32)
    out = [jnp.asarray(c[0]) for c in cg[:4]]
    out += [jnp.asarray(cg[4]), jnp.asarray(np.concatenate([cg[5], z])),
            jnp.asarray(np.concatenate([z, cg[6]])), jnp.asarray(cg[7][None]),
            jnp.asarray(cg[8][None]), jnp.asarray(cg[9]), jnp.asarray(cg[10])]
    return out


@pytest.fixture(scope="module")
def chgnet_case():
    """Three frames (5, 6, 4 atoms; frame 1 without magmom labels), their
    batches, the JAX parameters and the JAX loss with the magmom term and
    its gradient, on the labelled batch and on the batch with every magmom
    mask at 0 (the loss without the term), from one jit."""
    t, j, e, f, m = _frames(0, [5, 6, 4], magmom_frames=(0, 2))
    cut = J_CHGNET.atom_graph_cutoff
    tb = ttrain.pad_structures(t, e, f, cut, magmoms=m)
    jb = jtrain.pad_structures(j, e, f, cut, magmoms=m)
    assert tb.magmom_mask.tolist() == [1.0, 0.0, 1.0]
    jparams = jchgnet.init_chgnet(jax.random.PRNGKey(0), J_CHGNET)
    jloss = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(
        J_CHGNET, jtrain.TrainConfig(magmom_weight=0.5), apply_fn=jchgnet.chgnet_apply)))
    unlabelled = jb._replace(magmom_mask=np.zeros(3))
    return dict(tb=tb, jb=jb, jparams=jparams, params=_carry(jparams),
                with_mag=jloss(jparams, _jbatch(jb)), without=jloss(jparams, _jbatch(unlabelled)))


@pytest.mark.parametrize("magmom_weight", [0.0, 0.5])
def test_chgnet_loss_and_gradients_match_jax(chgnet_case, magmom_weight):
    """The CHGNet loss (energy + force, and with magmom_weight 0.5 the
    magmom term over the labelled frames) and every parameter gradient
    against JAX's make_loss_fn(apply_fn=chgnet_apply)."""
    cfg = _port_cfg(CHGNetConfig, J_CHGNET)
    loss, grads = _port_loss_and_grads(chgnet_case["params"], cfg,
                                       ttrain.TrainConfig(magmom_weight=magmom_weight),
                                       chgnet_case["tb"], chgnet_apply_structures)
    jloss, jgrads = chgnet_case["with_mag" if magmom_weight else "without"]
    _assert_loss_and_grads(loss, grads, jloss, jgrads)
    if magmom_weight:
        assert loss > float(chgnet_case["without"][0])


def test_mace_loss_and_gradients_match_jax():
    """The MACE force loss through mace_apply and every parameter gradient
    against JAX's make_loss_fn(apply_fn=mace_apply)."""
    t, j, e, f, _ = _frames(1, [6, 5])
    tb = ttrain.pad_structures(t, e, f, J_MACE.cutoff)
    jb = jtrain.pad_structures(j, e, f, J_MACE.cutoff)
    jparams = jmace.init_mace(jax.random.PRNGKey(2), J_MACE)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(
        J_MACE, jtrain.TrainConfig(), apply_fn=jmace.mace_apply)))(jparams, _jbatch(jb))
    loss, grads = _port_loss_and_grads(_carry(jparams), _port_cfg(MACEConfig, J_MACE),
                                       ttrain.TrainConfig(), tb, mace_apply)
    _assert_loss_and_grads(loss, grads, jloss, jgrads)


@pytest.mark.parametrize("family", ["chgnet", "mace"])
def test_train_painn_matches_jax(family):
    """Three epochs of two batches from the same parameters with
    train_painn(apply_fn=...) in both packages: the per-epoch losses agree
    and fall."""
    t, j, e, f, _ = _frames(3, [5, 4, 6, 5])
    if family == "chgnet":
        jcfg, cfg, apply_fn, japply = (J_CHGNET, _port_cfg(CHGNetConfig, J_CHGNET),
                                       chgnet_apply_structures, jchgnet.chgnet_apply)
        jparams = jchgnet.init_chgnet(jax.random.PRNGKey(4), jcfg)
        cut = jcfg.atom_graph_cutoff
    else:
        jcfg, cfg, apply_fn, japply = (J_MACE, _port_cfg(MACEConfig, J_MACE), mace_apply,
                                       jmace.mace_apply)
        jparams = jmace.init_mace(jax.random.PRNGKey(4), jcfg)
        cut = jcfg.cutoff
    tb = [ttrain.pad_structures(t[i:i + 2], e[i:i + 2], f[i:i + 2], cut) for i in (0, 2)]
    jb = [jtrain.pad_structures(j[i:i + 2], e[i:i + 2], f[i:i + 2], cut) for i in (0, 2)]
    kw = dict(epochs=3, learning_rate=3e-3)
    _, jhist = jtrain.train_painn(jparams, jcfg, jb, jtrain.TrainConfig(**kw), apply_fn=japply)
    _, hist = ttrain.train_painn(_carry(jparams), cfg, tb, ttrain.TrainConfig(**kw),
                                 apply_fn=apply_fn)
    np.testing.assert_allclose(hist, jhist, rtol=HIST_RTOL)
    assert hist[-1] < hist[0]


def _mptrj_shards(tmp_path):
    """Two MPtrj JSON shards of 4-atom MnO frames in a 6 A cell with magmom
    labels, one frame unlabelled (``tests/test_training.py``'s MPtrj case)."""
    cell = np.eye(3) * 6.0

    def frame(seed):
        r = np.random.default_rng(seed)
        pos = r.random((4, 3)) * 4.0 + 1.0
        return {"structure": {"lattice": {"matrix": cell.tolist()},
                              "sites": [{"species": [{"element": el}], "abc": (p / 6.0).tolist()}
                                        for el, p in zip(["Mn", "O", "Mn", "O"], pos)]},
                "energy_per_atom": float(-5.0 + 0.1 * r.standard_normal()),
                "force": (0.1 * r.standard_normal((4, 3))).tolist(),
                "magmom": [3.5, 0.1, 3.4, 0.05]}

    for shard in range(2):
        frames = {f"{i}": frame(10 * shard + i) for i in range(3)}
        if shard == 1:
            del frames["2"]["magmom"]
        (tmp_path / f"shard{shard}.json").write_text(json.dumps({f"mp-{shard}": frames}))
    return tmp_path


def test_mptrj_magmom_path_and_refusals(tmp_path):
    """MPtrj shards with one unlabelled frame load into batches whose
    magmom mask is 0 on that frame; the magmom term engages on a labelled
    batch and a few epochs of train_painn lower the loss. Refusals, as in
    the JAX package: a magmom weight with a family that has no magmom head
    (PaiNN when the loss is built, MACE at its first call), a magmom weight
    with no labelled batch, and another family's config without its
    apply_fn."""
    from surface_sampling_tpu_torch.models.chgnet import init_chgnet
    from surface_sampling_tpu_torch.models.dataset import get_train_val_test_loader

    cfg = CHGNetConfig(atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=7,
                       num_angular=7, n_conv=1, max_neighbors=24, max_bond_neighbors=8,
                       mlp_hidden_dims=(16, 16, 16))
    train, val, test = get_train_val_test_loader(_mptrj_shards(tmp_path), cfg.atom_graph_cutoff,
                                                 batch_size=3, train_ratio=0.67, val_ratio=0.16)
    masks = np.concatenate([b.magmom_mask for b in train + val + test])
    assert set(masks.tolist()) == {0.0, 1.0} and masks.sum() == len(masks) - 1
    assert train[0].magmoms.shape == train[0].numbers.shape
    params = init_chgnet(torch.Generator().manual_seed(0), cfg)
    labelled = next(b for b in train if b.magmom_mask.all())
    dev = ttrain.batch_to_device(labelled, "cpu")
    lm, l0 = (float(ttrain.make_loss_fn(cfg, ttrain.TrainConfig(magmom_weight=w),
                                        chgnet_apply_structures)(stack_members([params]), dev,
                                                                 create_graph=False)[0].detach())
              for w in (0.5, 0.0))
    assert np.isfinite(lm) and lm > l0
    tcfg = ttrain.TrainConfig(magmom_weight=0.5, epochs=3, learning_rate=3e-3)
    _, hist = ttrain.train_painn(params, cfg, train, tcfg, apply_fn=chgnet_apply_structures)
    assert np.isfinite(hist).all() and hist[-1] < hist[0]

    with pytest.raises(ValueError, match="no 'magmom' output"):
        ttrain.make_loss_fn(PaiNNConfig(), tcfg)
    mcfg = MACEConfig(feat_dim=8, n_rbf=4, n_layers=1, max_neighbors=8, readout_hidden=4)
    loss_fn = ttrain.make_loss_fn(mcfg, tcfg, mace_apply)
    with pytest.raises(ValueError, match="no 'magmom' output"):
        loss_fn(stack_members([init_mace(torch.Generator().manual_seed(0), mcfg)]), dev)
    unlabelled = [b._replace(magmoms=None, magmom_mask=None) for b in train]
    with pytest.raises(ValueError, match="no batch carries magmom labels"):
        ttrain.train_painn(params, cfg, unlabelled, tcfg, apply_fn=chgnet_apply_structures)
    with pytest.raises(ValueError, match="apply_fn=None is PaiNN"):
        ttrain.Trainer(params, cfg)


def _write_frames(path, t, e, f, m):
    recs = [{"numbers": s.numbers.tolist(), "positions": s.positions.tolist(),
             "cell": s.cell.tolist(), "energy": en, "forces": fo.tolist(),
             **({"magmom": mm.tolist()} if mm is not None else {})}
            for s, en, fo, mm in zip(t, e, f, m)]
    path.write_text(json.dumps(recs))
    return path


def test_finetune_cli_families(tmp_path, capsys):
    """``--family chgnet`` (from a checkpoint the JAX package wrote, with a
    magmom weight) and ``--family mace`` (fresh, from a config) end to end
    on the CPU: the four files, a model.npz that the JAX package's loader
    reads back equal to the port's own loader, the saved model's energies
    equal to the same training in this process, and JAX's refusals."""
    from surface_sampling_tpu_torch.models.dataset import get_train_val_test_loader

    t, j, e, f, m = _frames(5, [5, 6, 4, 5, 6], magmom_frames=(0, 1, 2, 3, 4))
    data = _write_frames(tmp_path / "frames.json", t, e, f, m)
    jparams = jchgnet.init_chgnet(jax.random.PRNGKey(6), J_CHGNET)
    j_save_chgnet_npz(tmp_path / "init.npz", jparams, J_CHGNET)
    (tmp_path / "mace.json").write_text(json.dumps(
        {**dataclasses.asdict(J_MACE), "max_neighbors": 32}))
    runs = {"chgnet": ["--init", str(tmp_path / "init.npz"), "--magmom-weight", "0.5"],
            "mace": ["--config", str(tmp_path / "mace.json")]}
    for family, extra in runs.items():
        out = tmp_path / family
        finetune.main(["--data", str(data), "--family", family, "--out", str(out), "--epochs",
                       "2", "--batch-size", "2", "--device", "cpu", *extra])
        for name in ("model.npz", "history.csv", "metrics.json", "settings.json"):
            assert (out / name).exists(), (family, name)
        assert len(list(csv.reader((out / "history.csv").open()))) == 3
        assert f"Trained {family} for 2 epochs" in capsys.readouterr().out
        if family == "chgnet":
            tree, cfg = load_chgnet_npz(out / "model.npz")
            jtree, jcfg = j_load_chgnet_npz(out / "model.npz")
            assert _port_cfg(CHGNetConfig, jcfg) == cfg
            init_tree, _ = load_chgnet_npz(tmp_path / "init.npz")
            init, apply_fn = from_jax_params(init_tree, "cpu"), chgnet_apply_structures
            tcfg = ttrain.TrainConfig(magmom_weight=0.5, epochs=2)
        else:
            tree, cfg = load_mace_npz(out / "model.npz")
            jtree, jcfg = jmace.load_mace_npz(out / "model.npz")
            assert _port_cfg(MACEConfig, jcfg) == cfg
            # the CLI's fresh model: init_mace from a generator seeded with --seed
            init, apply_fn = init_mace(torch.Generator().manual_seed(0), cfg), mace_apply
            tcfg = ttrain.TrainConfig(epochs=2)
        jflat = _flatten(jax.tree.map(np.asarray, jtree))
        for k, v in _flatten(tree).items():
            np.testing.assert_array_equal(v, jflat[k], err_msg=k)
        train, _, _ = get_train_val_test_loader(data, finetune.FAMILIES[family].cutoff(cfg),
                                                batch_size=2)
        trained, _ = ttrain.train_painn(init, cfg, train, tcfg, apply_fn=apply_fn)
        b = ttrain.batch_to_device(train[0], "cpu")
        e_saved, e_here = (apply_fn(p, cfg, b.positions, b.numbers, b.numbers > 0,
                                    b.shifts)["energy"]
                           for p in (from_jax_params(tree, "cpu"), trained))
        torch.testing.assert_close(e_saved, e_here, rtol=1e-6, atol=0)

    for extra, match in ((["--family", "mace", "--ensemble", "2"], "PaiNN-ensemble path"),
                         (["--family", "chgnet", "--init", str(tmp_path / "init.npz"),
                           "--ensemble", "2"], "cannot combine with --init")):
        with pytest.raises(SystemExit, match=match):
            finetune.main(["--data", str(data), "--out", str(tmp_path / "x"), "--device",
                           "cpu", *extra])
    nolabels = _write_frames(tmp_path / "nolabels.json", t, e, f, [None] * len(t))
    with pytest.raises(ValueError, match="no batch carries magmom labels"):
        finetune.main(["--data", str(nolabels), "--family", "chgnet", "--init",
                       str(tmp_path / "init.npz"), "--magmom-weight", "0.5", "--out",
                       str(tmp_path / "y"), "--device", "cpu"])
