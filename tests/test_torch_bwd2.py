"""The message block's second order (slice 7, kernel row 5) against the JAX
package on the CPU.

``painn_message_bwd2_plain`` (the VJP of the plain message backward, by
autograd) against the JAX Pallas kernel ``_message_bwd2_pallas`` in
interpret mode with f32 routing; ``painn_message_fused`` differentiated
twice against the plain forward differentiated twice (the port of
``tests/test_painn.py``'s second-order check); and the premise of the
reverse-table contract of the second-order kernel in training: the
cotangent reaching g_envm is zero on masked edges.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: the JAX comparison at rtol 1e-6, with atol 1e-6 x max|JAX
output| in place of the ground rules' absolute 1e-5: the nine outputs reach
~4e2 (each element a sum of hundreds of f32 products of O(1) inputs), and
the two summation orders differ by up to ~9e-5 there, 3.3e-7 of the
output's max. The second-order checks at 1e-4, the JAX package's own f32
tolerance for its second-order check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.ops import pallas_painn as pp
from surface_sampling_tpu_torch.ops import painn_kernels as pk

C, K, N_PAD, F, M, R = 2, 2, 32, 16, 8, 8
E = N_PAD * M
NAMES = ("dphi", "dvcat", "drbf", "denvm", "dunit", "ddw", "ddb", "dgds", "dgdv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, masked=0.3):
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return rng.normal(size=shape).astype(np.float32)

    mask = rng.random((C, E)) >= masked
    return dict(phi=rn(C, K, N_PAD, 3 * F), vcat=rn(C, K, N_PAD, 3 * F), rbf=rn(C, E, R),
                envm=np.abs(rn(C, E)) * mask, nbr=rng.integers(0, N_PAD, (C, E)).astype(np.int32),
                unit=rn(C, 3, N_PAD, M), dw=rn(K, R, 3 * F), db=rn(K, 3 * F),
                gds=rn(C, K, N_PAD, F), gdv=rn(C, K, N_PAD, 3 * F),
                cphi=rn(C, K, N_PAD, 3 * F), cvcat=rn(C, K, N_PAD, 3 * F), crbf=rn(C, E, R),
                cenvm=rn(C, E), cunit=rn(C, 3, N_PAD, M), cdw=rn(K, R, 3 * F),
                cdb=rn(K, 3 * F), mask=mask)


def _x_major_to_3(v):
    """(n_pad, 3F) x-major rows -> the JAX kernels' (3, n_pad, F)."""
    return v.reshape(N_PAD, 3, F).transpose(1, 0, 2)


def _jax_bwd2(x):
    """Per-(chain, member) JAX kernel calls stacked into the port's batched
    layout: edge cotangents summed over members, weight cotangents over
    chains, dgdv x-major."""
    out = {}
    per = [[None] * K for _ in range(C)]
    for c in range(C):
        for k in range(K):
            per[c][k] = [np.asarray(a) for a in pp._message_bwd2_pallas(
                jnp.asarray(x["phi"][c, k]), jnp.asarray(x["vcat"][c, k]),
                jnp.asarray(x["cphi"][c, k]), jnp.asarray(x["cvcat"][c, k]),
                jnp.asarray(x["rbf"][c]), jnp.asarray(x["envm"][c][:, None]),
                jnp.asarray(x["nbr"][c][:, None]), jnp.asarray(x["unit"][c]),
                jnp.asarray(x["dw"][k]), jnp.asarray(x["db"][k][None]),
                jnp.asarray(x["gds"][c, k]), jnp.asarray(_x_major_to_3(x["gdv"][c, k])),
                jnp.asarray(x["crbf"][c]), jnp.asarray(x["cenvm"][c][:, None]),
                jnp.asarray(x["cunit"][c]), jnp.asarray(x["cdw"][k]),
                jnp.asarray(x["cdb"][k][None]), n_blk=8, routing="f32")]
    out["dphi"] = np.asarray([[per[c][k][0] for k in range(K)] for c in range(C)])
    out["dvcat"] = np.asarray([[per[c][k][1] for k in range(K)] for c in range(C)])
    out["drbf"] = np.asarray([sum(per[c][k][2] for k in range(K)) for c in range(C)])
    out["denvm"] = np.asarray([sum(per[c][k][3][:, 0] for k in range(K)) for c in range(C)])
    out["dunit"] = np.asarray([sum(per[c][k][4] for k in range(K)) for c in range(C)])
    out["ddw"] = np.asarray([sum(per[c][k][5] for c in range(C)) for k in range(K)])
    out["ddb"] = np.asarray([sum(per[c][k][6][0] for c in range(C)) for k in range(K)])
    out["dgds"] = np.asarray([[per[c][k][7] for k in range(K)] for c in range(C)])
    out["dgdv"] = np.asarray([[per[c][k][8].transpose(1, 0, 2).reshape(N_PAD, 3 * F)
                               for k in range(K)] for c in range(C)])
    return out


ARGS = ("phi", "vcat", "rbf", "envm", "nbr", "unit", "dw", "db", "gds", "gdv",
        "cphi", "cvcat", "crbf", "cenvm", "cunit", "cdw", "cdb")


@pytest.mark.parametrize("cdw", ["zero", "random"])
def test_bwd2_plain_matches_pallas(cdw):
    """All nine outputs of the plain second-order backward against the JAX
    kernel, with random cotangents everywhere (cenvm too, on masked edges),
    and with c_dw = c_db = 0, the training case, where the kernel skips
    their terms."""
    x = _inputs(11)
    if cdw == "zero":
        x["cdw"], x["cdb"] = np.zeros_like(x["cdw"]), np.zeros_like(x["cdb"])
    want = _jax_bwd2(x)
    t = {n: torch.as_tensor(x[n]) for n in ARGS}
    if cdw == "zero":
        t["cdw"] = t["cdb"] = None
    before = pk.painn_message_bwd2.launches
    got = pk.painn_message_bwd2(*(t[n] for n in ARGS))
    for name, g in zip(NAMES, got):
        assert g.shape == want[name].shape, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want[name]).max()), err_msg=name)
    assert pk.painn_message_bwd2.launches == before       # the plain version: no launch


def test_message_fused_second_order_matches_plain():
    """grad-of-grad through painn_message_fused (an outer reverse pass over
    the inner VJP, the force loss's structure) equals the plain forward's
    second order: the port of the JAX package's second-order check."""
    x = _inputs(17, masked=0.0)
    rng = np.random.default_rng(3)
    wds = torch.as_tensor(rng.normal(size=(C, K, N_PAD, F)).astype(np.float32))
    wdv = torch.as_tensor(rng.normal(size=(C, K, N_PAD, 3 * F)).astype(np.float32))
    names = ("phi", "vcat", "rbf", "envm", "unit", "dw", "db")
    cg = [torch.as_tensor(rng.normal(size=x[n].shape).astype(np.float32)) for n in names]
    nbr = torch.as_tensor(x["nbr"])

    def outer(fn):
        a = [torch.as_tensor(x[n]).clone().requires_grad_(True) for n in names]
        ds, dv = fn(a[0], a[1], a[2], a[3], nbr, a[4], a[5], a[6])
        g = torch.autograd.grad((ds * wds).sum() + (dv * wdv).sum(), a, create_graph=True)
        s = sum((gi * ci).sum() for gi, ci in zip(g, cg))
        return s.detach(), torch.autograd.grad(s, a)

    s_ref, g_ref = outer(pk.painn_message_fused_plain)
    s_got, g_got = outer(pk.painn_message_fused)
    np.testing.assert_allclose(float(s_got), float(s_ref), rtol=1e-5)
    for name, a, b in zip(names, g_got, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)


def test_masked_edges_get_zero_cenvm_in_training(monkeypatch):
    """The reverse-table contract's premise: when envm = envelope * mask is
    built in the graph (as prepare_message_geometry does), the cotangent of
    g_envm that reaches painn_message_bwd2 is zero on every masked edge, so
    a reverse table may leave those edges out; and the double backward
    through such masked edges equals the plain forward's."""
    x = _inputs(23, masked=0.4)
    seen = []
    bwd2 = pk.painn_message_bwd2

    def recorded(*args, **kwargs):
        seen.append(args[13].clone())
        return bwd2(*args, **kwargs)

    monkeypatch.setattr(pk, "painn_message_bwd2", recorded)
    mask = torch.as_tensor(x["mask"])
    nbr = torch.as_tensor(x["nbr"])
    rng = np.random.default_rng(4)
    env0 = torch.as_tensor(np.abs(rng.normal(size=(C, E))).astype(np.float32))
    names = ("phi", "vcat", "rbf", "unit", "dw", "db")

    wds = torch.as_tensor(rng.normal(size=(C, K, N_PAD, F)).astype(np.float32))
    wdv = torch.as_tensor(rng.normal(size=(C, K, N_PAD, 3 * F)).astype(np.float32))
    c_env = torch.as_tensor(rng.normal(size=(C, E)).astype(np.float32))
    c_rbf = torch.as_tensor(rng.normal(size=(C, E, R)).astype(np.float32))

    def force_like(fn):
        a = {n: torch.as_tensor(x[n]).clone().requires_grad_(True) for n in names}
        env = env0.clone().requires_grad_(True)
        envm = env * mask
        ds, dv = fn(a["phi"], a["vcat"], a["rbf"], envm, nbr, a["unit"], a["dw"], a["db"])
        g_env, g_rbf = torch.autograd.grad((ds * wds).sum() + (dv * wdv).sum(),
                                           (env, a["rbf"]), create_graph=True)
        loss = (g_env * c_env).sum() + (g_rbf * c_rbf).sum()
        return torch.autograd.grad(loss, [a[n] for n in names])

    want = force_like(pk.painn_message_fused_plain)
    got = force_like(pk.painn_message_fused)
    assert len(seen) == 1
    assert not bool(seen[0][~mask].any()) and bool(seen[0][mask].any())
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
