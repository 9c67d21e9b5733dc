"""The port's CHGNet atom conv (``ops/chgnet_kernels.py``) against the JAX
package's Pallas kernels in interpret mode, f32 routing, on the toy shapes
of ``tests/test_chgnet.py``: the forward (row 10), the banded forward on a
synthetic band (row 11), every cotangent of the backward (row 12), and the
autograd op against ``jax.vjp`` of the reference. On the CPU every wrapper
runs its plain version, which is what is held to JAX here; the CUDA
kernels are held to the plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Inputs are made with numpy from a seed and handed to both packages. The
JAX kernels take the zero-extended (2F, F) second-layer weights, the port
their live (F, F) halves. Tolerance 1e-4, the JAX tests' own f32 bound
for these kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.ops import pallas_chgnet as pc
from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
from surface_sampling_tpu_torch.ops.banding import DeviceBand

TOL = dict(rtol=1e-4, atol=1e-4)
F, M = 8, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: run them on one torch thread (restored
    afterwards), as the other port test modules do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, C, n_pad, nbr=None, m=M):
    """Seeded conv inputs (numpy): per-chain tensors with a leading chain
    axis (m edge slots a centre), and the live-half weights."""
    E = n_pad * m

    def rn(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if nbr is None:
        nbr = rng.integers(0, n_pad, (C, E))
    return dict(
        ai2=rn(C, n_pad, 2 * F), aj2=rn(C, n_pad, 2 * F), be=rn(C, E, F), bw=rn(C, E, F),
        maskf=(rng.random((C, E)) > 0.2).astype(np.float32), nbr=nbr.astype(np.int32),
        w2=rn(F, 2 * F), wc1=rn(F, F), wg1=rn(F, F), bc1=rn(F), bg1=rn(F),
        lnc=np.stack([np.ones(F) * 1.1, np.zeros(F) + 0.05]).astype(np.float32),
        lng=np.stack([np.ones(F) * 0.9, np.zeros(F) - 0.02]).astype(np.float32),
    )


ORDER = ("ai2", "aj2", "be", "bw", "maskf", "nbr", "w2", "wc1", "wg1", "bc1", "bg1", "lnc",
         "lng")


def _torch_args(x):
    return tuple(torch.as_tensor(x[k]) for k in ORDER)


def _jax_args(x, c):
    """Chain c's inputs in the JAX kernels' layout: (E, 1) mask and
    neighbours, zero-extended second-layer weights, (1, F) biases."""
    z = np.zeros((F, F), np.float32)
    return (jnp.asarray(x["ai2"][c]), jnp.asarray(x["aj2"][c]), jnp.asarray(x["be"][c]),
            jnp.asarray(x["bw"][c]), jnp.asarray(x["maskf"][c][:, None]),
            jnp.asarray(x["nbr"][c][:, None]), jnp.asarray(x["w2"]),
            jnp.asarray(np.concatenate([x["wc1"], z])), jnp.asarray(np.concatenate([z, x["wg1"]])),
            jnp.asarray(x["bc1"][None]), jnp.asarray(x["bg1"][None]), jnp.asarray(x["lnc"]),
            jnp.asarray(x["lng"]))


def _live_halves(g):
    """JAX's 11 cotangents with the zero-extended weights' cotangents cut
    to their live halves and the (1, F) biases flattened."""
    g = [np.asarray(a) for a in g]
    g[5], g[6] = g[5][:F], g[6][F:]
    g[7], g[8] = g[7][0], g[8][0]
    return g


def test_conv_plain_matches_pallas_per_chain():
    """Row 10: three chains in one call, each equal to the Pallas kernel on
    its own inputs (chains do not mix)."""
    x = _inputs(np.random.default_rng(0), C=3, n_pad=16)
    got = ck.chgnet_conv(*_torch_args(x)).numpy()
    assert got.shape == (3, 16, F)
    for c in range(3):
        want = pc._conv_pallas(*_jax_args(x, c), n_blk=8, routing="f32")
        np.testing.assert_allclose(got[c], np.asarray(want), **TOL)


def test_banded_plain_matches_pallas():
    """Row 11 on the synthetic band of tests/test_chgnet.py: every block's
    neighbours in a 16-wide circular window of n_pad 32, the wrap held by an
    8-row halo."""
    rng = np.random.default_rng(7)
    n_pad, n_blk, window, halo = 32, 8, 16, 8
    ws = np.array([0, 8, 16, 24], np.int32)
    C = 2
    nbr = np.zeros((C, n_pad, M), np.int64)
    for b in range(n_pad // n_blk):
        nbr[:, b * n_blk:(b + 1) * n_blk] = ws[b] + rng.integers(0, window, (C, n_blk, M))
    x = _inputs(rng, C, n_pad, nbr=(nbr % n_pad).reshape(C, -1))
    ident = torch.arange(n_pad)
    band = DeviceBand(perm=ident, inv_perm=ident, rank=ident, win_start=torch.as_tensor(ws),
                      window=window, halo=halo, n_blk=n_blk)
    args = list(_torch_args(x))
    args[1] = torch.cat([args[1], args[1][:, :halo]], dim=1)
    got = ck.chgnet_conv_banded(*args, band).numpy()
    for c in range(C):
        ja = list(_jax_args(x, c))
        ja[1] = jnp.concatenate([ja[1], ja[1][:halo]])
        want = pc.chgnet_conv_fused_banded(*ja, jnp.asarray(ws), n_blk=n_blk, window=window,
                                           n_pad=n_pad, routing="f32")
        np.testing.assert_allclose(got[c], np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def bwd_case():
    """Two chains' backward inputs and the fused Pallas backward of each."""
    rng = np.random.default_rng(12)
    C, n_pad = 2, 16
    x = _inputs(rng, C, n_pad)
    gagg = rng.normal(size=(C, n_pad, F)).astype(np.float32)
    per_chain = [_live_halves(pc._conv_bwd_pallas(*_jax_args(x, c), jnp.asarray(gagg[c]),
                                                  n_blk=8, routing="f32")) for c in range(C)]
    return x, gagg, per_chain


@pytest.mark.parametrize("want_weights", [True, False])
def test_backward_plain_matches_pallas(bwd_case, want_weights):
    """Row 12: all 11 cotangents against the fused Pallas backward (the
    weight ones summed over both chains), or the four input cotangents and
    no weight ones."""
    x, gagg, per_chain = bwd_case
    got = ck.chgnet_conv_bwd(*_torch_args(x), torch.as_tensor(gagg), want_weights=want_weights)
    assert len(got) == len(ck.GRAD_NAMES)
    for k, name in enumerate(ck.GRAD_NAMES):
        if k < 4:
            want = np.stack([g[k] for g in per_chain])
        elif want_weights:
            want = sum(g[k] for g in per_chain)
        else:
            assert got[k] is None, name
            continue
        np.testing.assert_allclose(got[k].numpy(), want, err_msg=name, **TOL)


def test_autograd_op_matches_jax_vjp_and_is_once_differentiable():
    """The port's autograd op (plain on the CPU) gives jax.vjp of the JAX
    reference ``_conv_ref`` for every float input; it is differentiable
    twice (the second order is held to JAX's in
    ``tests/test_torch_chgnet_training.py``), and a third order raises."""
    rng = np.random.default_rng(21)
    x = _inputs(rng, 1, 16)
    gagg = rng.normal(size=(1, 16, F)).astype(np.float32)
    args = list(_torch_args(x))
    diff = [0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12]
    for i in diff:
        args[i].requires_grad_(True)
    out = ck.chgnet_conv(*args)
    got = torch.autograd.grad(out, [args[i] for i in diff], torch.as_tensor(gagg),
                              create_graph=True)

    ja = _jax_args(x, 0)
    _, vjp = jax.vjp(lambda *a: pc._conv_ref(a[0], a[1], a[2], a[3], ja[4], ja[5], *a[4:]),
                     *(ja[i] for i in diff))
    want = _live_halves(vjp(jnp.asarray(gagg[0])))
    for k, name in enumerate(ck.GRAD_NAMES):
        np.testing.assert_allclose(got[k].detach().numpy().reshape(want[k].shape), want[k],
                                   err_msg=name, **TOL)
    (g2,) = torch.autograd.grad(got[0].sum(), args[1], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiable twice"):
        torch.autograd.grad(g2.sum(), args[0])


def test_banded_conv_is_forward_only():
    rng = np.random.default_rng(3)
    x = _inputs(rng, 1, 16, nbr=rng.integers(0, 8, (1, 16 * M)))
    ident = torch.arange(16)
    band = DeviceBand(perm=ident, inv_perm=ident, rank=ident,
                      win_start=torch.zeros(2, dtype=torch.int32), window=8, halo=0, n_blk=8)
    args = list(_torch_args(x))
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        ck.chgnet_conv_banded(*args, band)
