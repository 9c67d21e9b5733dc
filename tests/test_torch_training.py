"""PaiNN force-loss training and prediction of the port (slice 7) against the
JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both packages; JAX
parameters are carried across (``from_jax_params``). The loss comparisons
run the JAX loss in "pallas" mode with f32 routing (its second order through
the bwd2 Pallas kernel in interpret mode) at the tiny size, and in "gather"
mode (XLA) at the flagship's width. Tolerances: the JAX package's own for
this comparison (``tests/test_painn.py``, the training-loss gradient on the
fused kernels): rtol 1e-4 / atol 1e-5 on loss gradients, 1e-5 relative on
loss values; 1e-4 relative on five epochs of Adam (the per-step gradient
differences compound). At the flagship's width the gradient leaves reach
~3e2 and an element where large terms cancel carries f32 summation noise
up to ~4e-4 (2.1e-6 of its leaf's max|g|, in both directions of the
comparison), so there the absolute part is 1e-5 x max|g| of each leaf
instead of 1e-5. Neighbour lists must agree exactly in their indices,
mask and overflow flags, and within 1e-6 in r and disp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.models import painn as jpainn
from surface_sampling_tpu.models import prediction as jpred
from surface_sampling_tpu.models import train as jtrain
from surface_sampling_tpu.models.convert_nff import load_params_npz
from surface_sampling_tpu.models.ensemble import stack_params
from surface_sampling_tpu.ops import neighbors as jnb
from surface_sampling_tpu.structure.atoms import Structure as JStructure
from surface_sampling_tpu_torch.models import prediction as tpred
from surface_sampling_tpu_torch.models import train as ttrain
from surface_sampling_tpu_torch.models.painn import (
    PaiNNConfig,
    init_ensemble,
    init_painn,
    stack_members,
    tree_leaves,
    tree_map,
)
from surface_sampling_tpu_torch.models.weights import from_jax_params, load_painn_npz
from surface_sampling_tpu_torch.ops import neighbors as tnb
from surface_sampling_tpu_torch.structure.atoms import Structure
from surface_sampling_tpu_torch.systems import MODEL_DATA, SYSTEMS_DATA

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(feat_dim=16, n_rbf=8, cutoff=4.0, n_layers=2, readout_hidden=8, max_neighbors=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    return jpainn.PaiNNConfig(**{**TINY, **kw})


def _tcfg(jcfg):
    return PaiNNConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(PaiNNConfig)})


def _carry(jparams):
    """A JAX parameter tree (one model) as the port's stacked tree."""
    return stack_members([from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")])


def _frames(seed, n_frames, n_atoms, boxes):
    """Random periodic frames (one box each, cycling over ``boxes``) with
    random labels, as (port, JAX) structure lists and the labels."""
    rng = np.random.default_rng(seed)
    t, j, e, f = [], [], [], []
    for b in range(n_frames):
        box = np.asarray(boxes[b % len(boxes)], float)
        n = n_atoms[b % len(n_atoms)]
        pos = rng.uniform(0, 1, (n, 3)) * box
        numbers = np.asarray(([8, 22, 38, 8] * n)[:n], np.int32)
        t.append(Structure(numbers, pos, np.diag(box)))
        j.append(JStructure(numbers, pos, np.diag(box)))
        e.append(float(rng.normal()))
        f.append(rng.normal(size=(n, 3)))
    return t, j, e, f


def _jbatch(b):
    return jtrain.PaddedBatch(*(
        None if x is None else jnp.asarray(x, jnp.float32) if np.asarray(x).dtype.kind == "f"
        else jnp.asarray(x) for x in b))


def _port_loss_and_grads(params, cfg, tcfg, batch):
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    loss = ttrain.make_loss_fn(cfg, tcfg)(p, ttrain.batch_to_device(batch, "cpu"))
    grads = iter(torch.autograd.grad(loss.sum(), leaves))
    return loss, tree_map(lambda _: next(grads), params)


def _assert_grads(got, want, atol_of_max=None):
    """Every leaf of a port gradient tree (member axis K = 1) against a JAX
    gradient tree; with ``atol_of_max``, atol is that fraction of the
    leaf's max|g|."""
    n = []

    def same(g, w):
        w = np.asarray(w)
        tol = dict(GRAD_TOL)
        if atol_of_max is not None:
            tol["atol"] = atol_of_max * float(np.abs(w).max())
        np.testing.assert_allclose(g[0].numpy(), w, **tol)
        n.append(1)

    tree_map(same, got, jax.tree.map(np.asarray, want))
    assert len(n) == len(jax.tree.leaves(want))


# ----------------------------------------------------------------------
# neighbour list
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
def test_neighbor_list_matches_jax(case):
    """Per-frame image shifts (unused slots parked at 1e6), dead atoms,
    exact distance ties on a simple-cubic lattice (the 12 pairs at 2.83 A
    compete for the last 6 of M = 12 slots: lax.top_k's lower-index rule),
    and frames with more in-range pairs than M (overflow)."""
    rng = np.random.default_rng({"random": 0, "ties": 1, "overflow": 2}[case])
    cutoff, M = 4.0, 12
    if case == "ties":
        grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)
        cells = [np.eye(3) * 6.0, np.eye(3) * 6.0]
        pos = np.stack([grid * 2.0, grid * 2.0 + 0.5]).astype(np.float32)
    else:
        cells = [np.diag([7.0, 6.0, 9.0]), np.diag([9.0, 10.0, 8.0])]
        dense = 0.45 if case == "overflow" else 1.0
        pos = np.stack([rng.uniform(0, 1, (27, 3)) * np.diag(c) * dense
                        for c in cells]).astype(np.float32)
    C, N = pos.shape[:2]
    sh = [tnb.pair_shifts(c, cutoff) for c in cells]
    shifts = np.full((C, max(len(s) for s in sh), 3), 1e6, np.float32)
    for c, s in enumerate(sh):
        shifts[c, :len(s)] = s
    alive = np.ones((C, N), bool)
    alive[1, -4:] = False
    got = tnb.neighbor_list(torch.as_tensor(pos), torch.as_tensor(shifts),
                            torch.as_tensor(alive), cutoff, M)
    for c in range(C):
        disp, r, nbr, mask, overflow = jnb.neighbor_list(
            jnp.asarray(pos[c]), jnp.asarray(shifts[c]), jnp.asarray(alive[c]), cutoff, M)
        np.testing.assert_array_equal(got.nbr_j[c].numpy(), np.asarray(nbr))
        np.testing.assert_array_equal(got.mask[c].numpy(), np.asarray(mask))
        assert bool(got.overflow[c]) == bool(overflow)
        np.testing.assert_allclose(got.r[c].numpy(), np.asarray(r), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.disp[c].numpy(), np.asarray(disp), rtol=0, atol=1e-6)
    if case == "overflow":
        assert bool(got.overflow.any())


def test_neighbor_list_is_twice_differentiable():
    """The edge geometry's second derivative in the positions equals the
    one of a plain-indexing reference (the neighbour gather's backward is a
    fixed-order sum over the reverse table, and its backward a gather)."""
    rng = np.random.default_rng(5)
    pos = torch.as_tensor(rng.uniform(0, 5, (2, 10, 3)), dtype=torch.float32)
    shifts = torch.as_tensor(np.repeat(tnb.pair_shifts(np.eye(3) * 5.0, 3.0)[None], 2, 0),
                             dtype=torch.float32)
    alive = torch.ones((2, 10), dtype=torch.bool)
    w = torch.as_tensor(rng.normal(size=(2, 10, 8)), dtype=torch.float32)

    def hvp(fn):
        x = pos.clone().requires_grad_(True)
        e = (fn(x) * w).sum()
        (g,) = torch.autograd.grad(e, x, create_graph=True)
        return torch.autograd.grad((g * g).sum(), x)[0]

    def ours(x):
        return torch.sin(tnb.neighbor_list(x, shifts, alive, 3.0, 8).r)

    edges = tnb.neighbor_list(pos, shifts, alive, 3.0, 8)

    def reference(x):
        j = edges.nbr_j
        pj = torch.stack([x[c, j[c]] for c in range(2)])
        k = torch.stack([(edges.disp[c] - (x[c, :, None] - pj[c])) for c in range(2)])
        disp = x[:, :, None] - pj + k.detach()
        r = torch.sqrt(torch.clamp((disp * disp).sum(-1), min=1e-12))
        return torch.sin(torch.where(edges.mask, r, torch.full_like(r, 3.0)))

    np.testing.assert_allclose(hvp(ours).numpy(), hvp(reference).numpy(), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# initialisation, loss, gradients, training, prediction
# ----------------------------------------------------------------------
def test_init_has_jax_shapes_and_distributions():
    """init_painn / init_ensemble draw the JAX package's tree with its
    shapes and distributions: embeddings N(0, 0.1^2), dense weights
    U(+-1/sqrt(n_in)), zero biases (the values differ: another generator)."""
    jcfg = jpainn.PaiNNConfig(feat_dim=32, n_rbf=8, n_layers=2, readout_hidden=16)
    want = jax.tree.map(np.asarray, jpainn.init_painn(jax.random.PRNGKey(0), jcfg))
    got = init_painn(torch.Generator().manual_seed(0), _tcfg(jcfg))
    leaves = []

    def check(g, w):
        assert tuple(g.shape) == w.shape
        leaves.append(g)

    tree_map(check, got, want)
    assert len(leaves) == len(jax.tree.leaves(want))
    emb = got["atom_embed"]
    assert abs(float(emb.std()) - 0.1) < 0.01 and abs(float(emb.mean())) < 0.01
    for layer in got["message"] + got["update"]:
        for dense in layer.values():
            bound = 1.0 / np.sqrt(dense["w"].shape[0])
            assert float(dense["w"].abs().max()) <= bound
            assert float(dense["w"].abs().max()) > 0.9 * bound
            if "b" in dense:
                assert not bool(dense["b"].any())
    ens = init_ensemble(torch.Generator().manual_seed(1), _tcfg(jcfg), 3)
    assert ens["atom_embed"].shape == (3, 100, 32)
    assert not torch.equal(ens["atom_embed"][0], ens["atom_embed"][1])
def _elongated_batch():
    """The batch of the JAX package's fused-kernel training test: two
    copies of 12 atoms in a 12 x 8 x 8 box, labels from numpy."""
    rng = np.random.default_rng(23)
    box = np.asarray([12.0, 8.0, 8.0])
    pos = (rng.uniform(0, 1, (12, 3)) * box).astype(np.float32)
    numbers = np.asarray(([8, 22, 38, 8] * 3), np.int32)
    shifts = tnb.pair_shifts(np.diag(box), 4.0).astype(np.float32)
    B = 2
    return ttrain.PaddedBatch(
        positions=np.tile(pos[None], (B, 1, 1)), numbers=np.tile(numbers[None], (B, 1)),
        shifts=np.tile(shifts[None], (B, 1, 1)), energy=np.asarray([1.0, 2.0], np.float32),
        forces=rng.normal(size=(B, 12, 3)).astype(np.float32))


def test_loss_and_gradients_match_jax_pallas():
    """make_loss_fn's value and every parameter gradient against the JAX
    loss with message_mode="pallas", pallas_routing="f32" (its grad-of-grad
    through _message_bwd_op and the bwd2 kernel in interpret mode)."""
    jcfg = _jcfg(message_mode="pallas", pallas_routing="f32")
    jparams = jpainn.init_painn(jax.random.PRNGKey(0), jcfg)
    batch = _elongated_batch()
    tcfg = jtrain.TrainConfig(energy_weight=0.3, force_weight=0.7)
    jl, jg = jax.value_and_grad(jtrain.make_loss_fn(jcfg, tcfg))(jparams, _jbatch(batch))
    loss, grads = _port_loss_and_grads(_carry(jparams), _tcfg(jcfg),
                                       ttrain.TrainConfig(energy_weight=0.3, force_weight=0.7),
                                       batch)
    np.testing.assert_allclose(float(loss[0].detach()), float(jl), rtol=1e-5, atol=1e-6)
    _assert_grads(grads, jg)


def test_flagship_width_loss_and_gradients_match_jax():
    """One anchor at the flagship's width: srtio3_painn_01.npz (F = 128, 3
    layers, 20 RBFs, excluded volume), two frames of the SrTiO3(001) 2x2
    slab jittered by 0.03 A, against the JAX loss in "gather" mode (the
    gradient tolerance is scaled to each leaf, see the module docstring)."""
    jparams, jcfg = load_params_npz(MODEL_DATA / "srtio3_painn_01.npz")
    tree, cfg = load_painn_npz(MODEL_DATA / "srtio3_painn_01.npz")
    data = np.load(SYSTEMS_DATA / "SrTiO3_001_2x2.npz")
    rng = np.random.default_rng(0)
    frames = [Structure(data["numbers"], data["positions"]
                        + rng.normal(0, 0.03, data["positions"].shape), data["cell"])
              for _ in range(2)]
    batch = ttrain.pad_structures(frames, [-460.0, -470.0],
                                  [rng.normal(0, 0.5, (60, 3)) for _ in frames], cfg.cutoff)
    tcfg = jtrain.TrainConfig()
    jl, jg = jax.value_and_grad(jtrain.make_loss_fn(
        dataclasses.replace(jcfg, message_mode="gather"), tcfg))(jparams, _jbatch(batch))
    loss, grads = _port_loss_and_grads(stack_members([from_jax_params(tree, "cpu")]), cfg,
                                       ttrain.TrainConfig(), batch)
    np.testing.assert_allclose(float(loss[0].detach()), float(jl), rtol=1e-5)
    _assert_grads(grads, jg, atol_of_max=1e-5)


def _train_batches():
    t, j, e, f = _frames(3, 4, [9, 7], [[7.0, 6.5, 8.0], [6.0, 9.0, 7.5]])
    return ([ttrain.pad_structures(t[i:i + 2], e[i:i + 2], f[i:i + 2], 4.0) for i in (0, 2)],
            [jtrain.pad_structures(j[i:i + 2], e[i:i + 2], f[i:i + 2], 4.0) for i in (0, 2)])


@pytest.mark.parametrize("ensemble", [False, True])
def test_train_painn_matches_jax(ensemble):
    """Five epochs of two batches from the same parameters: the per-epoch
    losses agree. For the 2-member ensemble grad_clip sits between the
    members' first gradient norms, so one member is clipped and the other
    is not (Adam is nearly blind to a constant clip factor, so the
    optimizer test below pins the per-member rule itself)."""
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    tb, jb = _train_batches()
    if ensemble:
        jparams = stack_params([jpainn.init_painn(jax.random.PRNGKey(s), jcfg) for s in (0, 7)])
        params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
        stacked = params
    else:
        jparams = jpainn.init_painn(jax.random.PRNGKey(0), jcfg)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
        stacked = stack_members([params])
    clip = 1e9
    if ensemble:
        _, g = _port_loss_and_grads(stacked, cfg, ttrain.TrainConfig(), tb[0])
        norms = torch.sqrt(sum(x.reshape(2, -1).pow(2).sum(1) for x in tree_leaves(g)))
        lo, hi = sorted(float(x) for x in norms)
        clip = float(np.sqrt(lo * hi))
        assert lo < clip < hi
    kw = dict(epochs=5, learning_rate=3e-3, grad_clip=clip)
    _, jhist = jtrain.train_painn(jparams, jcfg, jb, jtrain.TrainConfig(**kw), ensemble=ensemble)
    trained, hist = ttrain.train_painn(params, cfg, tb, ttrain.TrainConfig(**kw),
                                       ensemble=ensemble)
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    assert hist[-1] < hist[0]
    assert trained["atom_embed"].shape == params["atom_embed"].shape


def test_clip_and_adam_match_optax_per_member():
    """The optimizer of train_painn against optax.chain(clip_by_global_norm,
    adam) vmapped over members, on three steps of given gradients: member
    0's global norm is 4x the clip at every step, member 1's 0.5x, then 2x:
    each member is clipped by its own norm (a clip by the joint norm moves
    the parameters by ~1e-3). Tolerance: f32 rounding of three Adam steps."""
    import optax

    rng = np.random.default_rng(9)
    shapes = [(2, 5, 3), (2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = []
    for scale in ((4.0, 0.5), (4.0, 2.0), (4.0, 0.5)):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        norms = np.sqrt(sum((x.reshape(2, -1) ** 2).sum(1) for x in g))
        steps.append([x * (np.asarray(scale) / norms).reshape((2,) + (1,) * (x.ndim - 1))
                      for x in g])
    tcfg = ttrain.TrainConfig(learning_rate=1e-2, grad_clip=1.0)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
    jp = [jnp.asarray(x) for x in params]
    state = jax.vmap(opt.init)(jp)
    leaves = [torch.as_tensor(x) for x in params]
    tstate = ttrain._AdamState(0, [torch.zeros_like(x) for x in leaves],
                               [torch.zeros_like(x) for x in leaves])
    for g in steps:
        upd, state = jax.vmap(opt.update)([jnp.asarray(x) for x in g], state)
        jp = optax.apply_updates(jp, upd)
        tstate = ttrain._clip_adam_update(leaves, [torch.as_tensor(x) for x in g], tstate,
                                          tcfg, 2)
    for a, b in zip(leaves, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_get_prediction_matches_jax():
    """Energies, forces, embeddings and the population std of a 2-member
    ensemble, and one model's prediction, against the JAX package."""
    jcfg = _jcfg()
    cfg = _tcfg(jcfg)
    tb, jb = _train_batches()
    jparams = stack_params([jpainn.init_painn(jax.random.PRNGKey(s), jcfg) for s in (1, 2)])
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    got = tpred.get_prediction(params, cfg, tb[0], ensemble=True)
    jb0 = _jbatch(jb[0])
    want = jax.jit(lambda p, b: jpred.get_prediction(p, jcfg, b, ensemble=True))(jparams, jb0)
    for key in ("energy", "forces", "embedding", "energy_std"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert float(got["energy_std"].min()) > 0
    numbers = tb[0].numbers
    np.testing.assert_allclose(tpred.get_embedding(got, numbers),
                               jpred.get_embedding(want, numbers), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tpred.get_residual(got, tb[0]), jpred.get_residual(want, jb[0]),
                               rtol=1e-4, atol=1e-5)
    for order in ("sum", "mean", "max", "min"):
        np.testing.assert_allclose(tpred.get_system_val(got["forces"], numbers, order),
                                   jpred.get_system_val(np.asarray(want["forces"]), numbers,
                                                        order), rtol=1e-4, atol=1e-5)
    errs, jerrs = tpred.get_errors(got, tb[0]), jpred.get_errors(want, jb[0])
    for key in ("energy_mae_per_atom", "force_mae"):
        np.testing.assert_allclose(errs[key], jerrs[key], rtol=1e-4, atol=1e-5)
    one = tpred.get_prediction(tree_map(lambda x: x[0], params), cfg, tb[0])
    want = jax.jit(lambda p, b: jpred.get_prediction(p, jcfg, b))(
        jax.tree.map(lambda x: x[0], jparams), jb0)
    np.testing.assert_allclose(one["forces"].numpy(), np.asarray(want["forces"]), rtol=1e-4,
                               atol=1e-5)
    assert not bool(one["energy_std"].any())
