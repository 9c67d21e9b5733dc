"""The facts the general message kernel (row 2) relies on, shown on the
plain versions on the CPU.

``csrc/painn_message_fused.cu`` runs the banded message's body
(``csrc/painn_message_banded.cuh``) on an identity band: it computes each
centre's live edges only (envm != 0), never reads a dead edge's rbf, unit
vector or neighbour index, and sums in one order fixed by the centre's own
edges. That is the same function only if

- an edge with envm == 0 contributes nothing, whatever its rbf, unit and
  (in-range) nbr hold: the plain version gives bitwise the same ds and dv
  when those values are replaced by random finite ones;
- the plain unbanded message equals the plain banded message on an
  identity band (every window at row 0, n_pad wide, no halo), bitwise;
- and the JAX package's Pallas kernel (interpret mode, f32 routing) agrees
  with the plain version, with and without the dead-edge values replaced,
  at the ground rules' kernel tolerance (rtol 1e-6, atol 1e-5: the same
  f32 terms summed in another order).

The card tests (``tests/test_torch_cuda_kernels.py``) hold the kernel itself
to these on the GPU, with NaN and out-of-range values on dead edges; the
last test here pins the limits its wrapper checks before a launch. A toy
cell (48 slots, 6 edge slots a centre, ~40% dead edges), two chains, two
members, on one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.ops import pallas_painn as pp
from surface_sampling_tpu_torch.ops import painn_kernels as pk
from surface_sampling_tpu_torch.ops.banding import identity_band

C, K, F, R, M, N_PAD = 2, 2, 8, 8, 6, 48
KERNEL_TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the comparisons are bitwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """Row 2's inputs (numpy), and a copy whose dead edges carry random
    finite rbf and unit values and random in-range neighbour indices."""
    rng = np.random.default_rng(5)
    E = N_PAD * M
    envm = np.abs(rng.normal(size=(C, E))).astype(np.float32)
    envm[rng.random(envm.shape) < 0.4] = 0.0
    nbr = rng.integers(0, N_PAD, (C, E)).astype(np.int32)
    rbf = rng.normal(size=(C, E, R)).astype(np.float32)
    unit = rng.normal(size=(C, 3, N_PAD, M)).astype(np.float32)
    phi = rng.normal(size=(C, K, N_PAD, 3 * F)).astype(np.float32)
    vcat = rng.normal(size=(C, K, N_PAD, 3 * F)).astype(np.float32)
    dw = rng.normal(size=(K, R, 3 * F)).astype(np.float32)
    db = rng.normal(size=(K, 3 * F)).astype(np.float32)
    dead = envm == 0
    rbf_d = np.where(dead[..., None], 10 * rng.normal(size=rbf.shape), rbf).astype(np.float32)
    unit_d = np.where(dead.reshape(C, 1, N_PAD, M), 10 * rng.normal(size=unit.shape),
                      unit).astype(np.float32)
    nbr_d = np.where(dead, rng.integers(0, N_PAD, nbr.shape), nbr).astype(np.int32)
    assert (rbf_d != rbf).any() and (unit_d != unit).any() and (nbr_d != nbr).any()
    return dict(args=(phi, vcat, rbf, envm, nbr, unit, dw, db),
                dead_args=(phi, vcat, rbf_d, envm, nbr_d, unit_d, dw, db))


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_dead_edges_leave_the_plain_message_unchanged(case):
    """Random finite rbf, unit and in-range nbr on the envm == 0 edges
    change no output of row 2's plain version (torch.equal)."""
    ref = pk.painn_message_fused_plain(*_t(case["args"]))
    got = pk.painn_message_fused_plain(*_t(case["dead_args"]))
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


@pytest.mark.parametrize("n_blk", [8, 16])
def test_plain_message_is_the_banded_message_on_an_identity_band(case, n_blk):
    """The plain unbanded message equals the plain banded message
    (``_banded_message_plain``) on an identity band, bitwise, whatever the
    band's block size."""
    band = identity_band(N_PAD, n_blk, "cpu")
    full = pk.painn_message_fused_plain(*_t(case["args"]))
    banded = pk.painn_message_fused_banded_plain(*_t(case["args"]), band)
    assert all(torch.equal(a, b) for a, b in zip(full, banded))


@pytest.mark.parametrize("dead_values", [False, True])
def test_plain_message_matches_pallas(case, dead_values):
    """Row 2's plain version against the JAX Pallas kernel
    (``painn_message_fused``, interpret mode, routing="f32"), each (chain,
    member) slice against one JAX call, with the dead edges' rbf, unit and
    nbr as drawn or replaced."""
    args = case["dead_args" if dead_values else "args"]
    phi, vcat, rbf, envm, nbr, unit, dw, db = args
    ds, dv = pk.painn_message_fused_plain(*_t(args))
    for c in range(C):
        for k in range(K):
            ds_j, dv_j = pp.painn_message_fused(
                jnp.asarray(phi[c, k]), jnp.asarray(vcat[c, k]), jnp.asarray(rbf[c]),
                jnp.asarray(envm[c][:, None]), jnp.asarray(nbr[c][:, None]),
                jnp.asarray(unit[c]), jnp.asarray(dw[k]), jnp.asarray(db[k][None]),
                16, "f32")
            np.testing.assert_allclose(ds[c, k].numpy(), np.asarray(ds_j), **KERNEL_TOL)
            np.testing.assert_allclose(
                dv[c, k].numpy(), np.concatenate([np.asarray(dv_j[x]) for x in range(3)], 1),
                **KERNEL_TOL)


@pytest.mark.parametrize("R_, F_, match", [
    (32, 128, "radial width must be 8, 16 or 24, got 32"),
    (24, 120, "F=120 must be a multiple of 16"),
])
def test_message_kernel_limits_raise_before_a_launch(monkeypatch, R_, F_, match):
    """Row 2's wrapper refuses, before any launch, what its kernel does not
    take: R = 32 (8, 16 and 24 only; row 1 and the old kernel took 32) and F
    not a multiple of the 16-channel slice. Tensors on the meta device take
    the kernel's branch of the wrapper without a card; a launch would
    fail the test."""
    def no_launch(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(pk, "_launch", no_launch)
    meta = dict(device="meta", dtype=torch.float32)
    n_pad, m = 16, 4
    E = n_pad * m
    args = (torch.empty(2, 3, n_pad, 3 * F_, **meta), torch.empty(2, 3, n_pad, 3 * F_, **meta),
            torch.empty(2, E, R_, **meta), torch.empty(2, E, **meta),
            torch.empty(2, E, device="meta", dtype=torch.int32),
            torch.empty(2, 3, n_pad, m, **meta), torch.empty(3, R_, 3 * F_, **meta),
            torch.empty(3, 3 * F_, **meta))
    with pytest.raises(ValueError, match=match):
        pk.painn_message_fused(*args)
