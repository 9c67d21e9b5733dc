"""Plain PyTorch versions of the port's PaiNN kernels vs the JAX package's
Pallas kernels (interpret mode on the CPU, routing="f32").

Each case batches two chains and two members in one port call and holds
every (chain, member) slice against one JAX call on that slice's inputs,
so the batch indexing is checked along with the arithmetic. Tolerance:
rtol 1e-5, atol 1e-5 — both sides sum the same f32 terms in another
order on O(1)..O(10) values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.ops import pallas_painn as pp
from surface_sampling_tpu_torch.ops import painn_kernels as pk

C, K, N_PAD, F, M, R = 2, 2, 32, 16, 8, 8
E = N_PAD * M
TOL = dict(rtol=1e-5, atol=1e-5)


def _geometry(rng):
    """Edge geometry of C chains: rbf (C, E, R), envm (C, E) with a third
    of the edges masked to 0, nbr (C, E), unit (C, 3, n_pad, M)."""
    rbf = rng.normal(size=(C, E, R)).astype(np.float32)
    envm = np.abs(rng.normal(size=(C, E))).astype(np.float32)
    envm[rng.random((C, E)) < 0.33] = 0.0
    nbr = rng.integers(0, N_PAD, (C, E)).astype(np.int32)
    unit = rng.normal(size=(C, 3, N_PAD, M)).astype(np.float32)
    return rbf, envm, nbr, unit


def _jax_dv_to_vcat(dv3):
    """JAX dv (3, n_pad, F) -> the port's x-major (n_pad, 3F)."""
    return np.concatenate([np.asarray(dv3[x]) for x in range(3)], axis=1)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_message_l1_plain_matches_pallas():
    rng = np.random.default_rng(0)
    rbf, envm, nbr, unit = _geometry(rng)
    T = 3
    species = rng.integers(0, T + 1, (C, N_PAD)).astype(np.int32)   # T = dead
    philt8 = np.zeros((K, 8, 2 * F), np.float32)                    # JAX table
    philt8[:, :T] = rng.normal(size=(K, T, 2 * F))
    philt = np.concatenate([philt8[:, :T], np.zeros((K, 1, 2 * F), np.float32)], axis=1)
    dw2 = rng.normal(size=(K, R, 2 * F)).astype(np.float32)
    db2 = rng.normal(size=(K, 2 * F)).astype(np.float32)

    ds, dv = pk.painn_message_l1(*_t(species, philt, rbf, envm, nbr, unit, dw2, db2))
    for c in range(C):
        sp8 = np.zeros((N_PAD, 8), np.float32)
        live = species[c] < T
        sp8[np.arange(N_PAD)[live], species[c][live]] = 1.0
        for k in range(K):
            ds_j, dv_j = pp.painn_message_l1(
                jnp.asarray(sp8), jnp.asarray(philt8[k]), jnp.asarray(rbf[c]),
                jnp.asarray(envm[c][:, None]), jnp.asarray(nbr[c][:, None]),
                jnp.asarray(unit[c]), jnp.asarray(dw2[k]), jnp.asarray(db2[k][None]),
                n_blk=16, routing="f32")
            np.testing.assert_allclose(ds[c, k].numpy(), np.asarray(ds_j), **TOL)
            np.testing.assert_allclose(dv[c, k].numpy(), _jax_dv_to_vcat(dv_j), **TOL)


def test_message_fused_plain_matches_pallas():
    rng = np.random.default_rng(1)
    rbf, envm, nbr, unit = _geometry(rng)
    phi = rng.normal(size=(C, K, N_PAD, 3 * F)).astype(np.float32)
    vcat = rng.normal(size=(C, K, N_PAD, 3 * F)).astype(np.float32)
    dw = rng.normal(size=(K, R, 3 * F)).astype(np.float32)
    db = rng.normal(size=(K, 3 * F)).astype(np.float32)

    ds, dv = pk.painn_message_fused(*_t(phi, vcat, rbf, envm, nbr, unit, dw, db))
    for c in range(C):
        for k in range(K):
            ds_j, dv_j = pp.painn_message_fused(
                jnp.asarray(phi[c, k]), jnp.asarray(vcat[c, k]), jnp.asarray(rbf[c]),
                jnp.asarray(envm[c][:, None]), jnp.asarray(nbr[c][:, None]),
                jnp.asarray(unit[c]), jnp.asarray(dw[k]), jnp.asarray(db[k][None]),
                16, "f32")
            np.testing.assert_allclose(ds[c, k].numpy(), np.asarray(ds_j), **TOL)
            np.testing.assert_allclose(dv[c, k].numpy(), _jax_dv_to_vcat(dv_j), **TOL)


def test_update_fused_plain_matches_pallas():
    rng = np.random.default_rng(2)
    s = rng.normal(size=(C, K, N_PAD, F)).astype(np.float32)
    vcat = rng.normal(size=(C, K, N_PAD, 3 * F)).astype(np.float32)
    scale = 1.0 / np.sqrt(F)
    u = (rng.normal(size=(K, F, F)) * scale).astype(np.float32)
    v = (rng.normal(size=(K, F, F)) * scale).astype(np.float32)
    w0 = (rng.normal(size=(K, 2 * F, F)) * scale).astype(np.float32)
    b0 = rng.normal(size=(K, F)).astype(np.float32)
    w1 = (rng.normal(size=(K, F, 3 * F)) * scale).astype(np.float32)
    b1 = rng.normal(size=(K, 3 * F)).astype(np.float32)
    alive = (rng.random((C, N_PAD)) < 0.7).astype(np.float32)

    s_out, v_out = pk.painn_update_fused(*_t(s, vcat, u, v, w0, b0, w1, b1, alive))
    for c in range(C):
        for k in range(K):
            up = {"u_mat": {"w": jnp.asarray(u[k])}, "v_mat": {"w": jnp.asarray(v[k])},
                  "s_dense0": {"w": jnp.asarray(w0[k]), "b": jnp.asarray(b0[k])},
                  "s_dense1": {"w": jnp.asarray(w1[k]), "b": jnp.asarray(b1[k])}}
            s_j, v_j = pp.painn_update_fused(
                jnp.asarray(s[c, k]), jnp.asarray(vcat[c, k]), up,
                jnp.asarray(alive[c][:, None]), routing="f32")
            np.testing.assert_allclose(s_out[c, k].numpy(), np.asarray(s_j), **TOL)
            np.testing.assert_allclose(v_out[c, k].numpy(), np.asarray(v_j), **TOL)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_wrapper_rejects_malformed_input(bad):
    """The wrappers check dtype, shape and contiguity before either path."""
    rng = np.random.default_rng(3)
    rbf, envm, nbr, unit = _t(*_geometry(rng))
    phi = torch.zeros((C, K, N_PAD, 3 * F))
    vcat = torch.zeros((C, K, N_PAD, 3 * F))
    dw, db = torch.zeros((K, R, 3 * F)), torch.zeros((K, 3 * F))
    if bad == "dtype":
        nbr = nbr.long()
    elif bad == "shape":
        dw = torch.zeros((K, R + 1, 3 * F))
    else:
        vcat = torch.zeros((C, K, 3 * F, N_PAD)).transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        pk.painn_message_fused(phi, vcat, rbf, envm, nbr, unit, dw, db)
    assert pk.painn_message_fused.launches == 0      # no CPU call counts as a launch
