"""The facts the banded message kernel (rows 7 and 8) relies on, shown on
the plain versions on the CPU.

``csrc/painn_message_banded.cuh`` computes each centre's live edges only
(envm != 0) and sums them in one order fixed by the centre's own edges, so
that the delta engine can mix row 7's cached rows with row 8's recomputed
ones. That is the same function only if

- an edge with envm == 0 contributes nothing, whatever its rbf and unit
  vector hold: the plain versions give bitwise the same ds and dv when those
  values are replaced by random finite ones;
- row 8 over every block of the band, in block order, is row 7: the plain
  versions agree bitwise;
- and the JAX package's banded Pallas kernel (interpret mode, f32 routing)
  agrees with the plain version, with and without the dead-edge values
  replaced, at the ground rules' kernel tolerance (rtol 1e-6, atol 1e-5:
  the same f32 terms summed in another order).

Row 6 (the banded layer-1 message) sums each centre's live edges only too,
binned by species: its plain version is as blind to a dead edge's rbf and
unit.

The card tests (``tests/test_torch_cuda_kernels.py``) hold the kernel itself
to these on the GPU; the last tests here pin the limits the wrappers check
before a launch. A toy band (42 slots on a periodic line, blocks of 16,
a halo, windows that wrap), two chains, two members, on one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.ops import pallas_painn as pp
from surface_sampling_tpu_torch.ops import painn_kernels as pk
from surface_sampling_tpu_torch.ops.banding import (
    build_routing_band,
    choose_message_block,
    stage_band,
)

C, K, F, R, M = 2, 2, 8, 8, 6
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
    """The band, row 7's inputs (numpy) and a copy whose dead edges carry
    random finite rbf and unit values."""
    n, n_pad = 42, 48
    x = np.arange(n, dtype=np.float64)
    diff = (x[None, :] - x[:, None] + n / 2) % n - n / 2
    order = np.argsort(np.abs(diff) + np.eye(n) * 1e9, axis=1)
    slot_j = order[:, :12].astype(np.int32)
    band = build_routing_band(np.stack([x, 0 * x, 0 * x], 1), slot_j,
                              np.ones_like(slot_j, bool), choose_message_block(n_pad), n_pad)
    assert band is not None and band.halo > 0 and band.window < n_pad
    rng = np.random.default_rng(3)
    cand = slot_j[np.minimum(np.tile(np.asarray(band.perm), (C, 1)), n - 1)]
    pick = rng.integers(0, cand.shape[-1], (C, n_pad, M))
    nbr = np.asarray(band.rank)[np.take_along_axis(cand, pick, axis=2)]
    nbr = nbr.reshape(C, n_pad * M).astype(np.int32)
    envm = np.abs(rng.normal(size=(C, n_pad * M))).astype(np.float32)
    envm[rng.random(envm.shape) < 0.4] = 0.0
    rbf = rng.normal(size=(C, n_pad * M, R)).astype(np.float32)
    unit = rng.normal(size=(C, 3, n_pad, M)).astype(np.float32)

    def ext(a):
        return np.concatenate([a, a[:, :, :band.halo]], axis=2)

    phi = ext(rng.normal(size=(C, K, n_pad, 3 * F)).astype(np.float32))
    vcat = ext(rng.normal(size=(C, K, n_pad, 3 * F)).astype(np.float32))
    dw = rng.normal(size=(K, R, 3 * F)).astype(np.float32)
    db = rng.normal(size=(K, 3 * F)).astype(np.float32)
    dead = envm == 0
    rbf_d = np.where(dead[..., None], 10 * rng.normal(size=rbf.shape), rbf).astype(np.float32)
    unit_d = np.where(dead.reshape(C, 1, n_pad, M), 10 * rng.normal(size=unit.shape),
                      unit).astype(np.float32)
    assert (rbf_d != rbf).any() and (unit_d != unit).any()
    return dict(band=band, args=(phi, vcat, rbf, envm, nbr, unit, dw, db),
                dead_args=(phi, vcat, rbf_d, envm, nbr, unit_d, dw, db))


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _subset_args(args, band, blocks):
    """Row 8's inputs over ``blocks`` (C, NB) of each chain: the blocks'
    geometry gathered in compact block order, the full tables."""
    phi, vcat, rbf, envm, nbr, unit, dw, db = args
    n_blk = band.n_blk
    rows = (blocks[:, :, None] * n_blk + np.arange(n_blk)).reshape(C, -1)

    def take(a, width):
        a = a.reshape(C, -1, width, *a.shape[2:])
        return np.stack([a[c][rows[c]] for c in range(C)]).reshape(C, -1, *a.shape[3:])

    unit_s = np.stack([unit[c][:, rows[c]] for c in range(C)])
    ws_sel = np.asarray(band.win_start)[blocks].astype(np.int32)
    return (phi, vcat, take(rbf, M), take(envm, M), take(nbr, M), unit_s, dw, db, ws_sel)


def test_dead_edges_leave_the_plain_banded_message_unchanged(case):
    """Random finite rbf and unit values on the envm == 0 edges change no
    output of rows 7 and 8's plain versions (torch.equal)."""
    band = stage_band(case["band"], "cpu")
    ref = pk.painn_message_fused_banded_plain(*_t(case["args"]), band)
    got = pk.painn_message_fused_banded_plain(*_t(case["dead_args"]), band)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    blocks = np.array([[2, 0], [1, 1]])
    ref = pk.painn_message_subset_plain(*_t(_subset_args(case["args"], case["band"], blocks)),
                                        band)
    got = pk.painn_message_subset_plain(
        *_t(_subset_args(case["dead_args"], case["band"], blocks)), band)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def _layer1_args(case, dead_values):
    """Row 6's inputs on the case's band and geometry: species rows of the
    halo-extended table (T = 3 species and the zero row), philt and the
    layer-1 weights drawn from a seed."""
    band = case["band"]
    _, _, rbf, envm, nbr, unit, _, _ = case["dead_args" if dead_values else "args"]
    rng = np.random.default_rng(5)
    T = 3
    n_ext = len(band.perm) + band.halo
    species = rng.integers(0, T + 1, (C, n_ext)).astype(np.int32)
    philt = np.concatenate([rng.normal(size=(K, T, 2 * F)), np.zeros((K, 1, 2 * F))], 1)
    dw2 = rng.normal(size=(K, R, 2 * F))
    db2 = rng.normal(size=(K, 2 * F))
    return (species, philt.astype(np.float32), rbf, envm, nbr, unit, dw2.astype(np.float32),
            db2.astype(np.float32))


def test_dead_edges_leave_the_plain_banded_layer1_message_unchanged(case):
    """Random finite rbf and unit values on the envm == 0 edges change no
    output of row 6's plain version (torch.equal): its kernel never reads
    them either."""
    band = stage_band(case["band"], "cpu")
    ref = pk.painn_message_l1_banded_plain(*_t(_layer1_args(case, False)), band)
    got = pk.painn_message_l1_banded_plain(*_t(_layer1_args(case, True)), band)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert float(ref[1].abs().max()) > 0


def test_plain_subset_over_every_block_is_the_full_message(case):
    """Row 8's plain version over all blocks, in block order, equals row
    7's bitwise."""
    band = stage_band(case["band"], "cpu")
    full = pk.painn_message_fused_banded_plain(*_t(case["args"]), band)
    n_blocks = len(case["band"].win_start)
    blocks = np.tile(np.arange(n_blocks), (C, 1))
    sub = pk.painn_message_subset_plain(*_t(_subset_args(case["args"], case["band"], blocks)),
                                        band)
    assert all(torch.equal(a, b) for a, b in zip(full, sub))


@pytest.mark.parametrize("dead_values", [False, True])
def test_plain_banded_message_matches_pallas(case, dead_values):
    """Row 7's plain version against the JAX banded Pallas kernel (interpret
    mode, routing="f32"), each (chain, member) slice against one JAX call,
    with the dead edges' rbf and unit as drawn or replaced."""
    band = case["band"]
    args = case["dead_args" if dead_values else "args"]
    phi, vcat, rbf, envm, nbr, unit, dw, db = args
    ds, dv = pk.painn_message_fused_banded_plain(*_t(args), stage_band(band, "cpu"))
    ws = jnp.asarray(band.win_start)
    for c in range(C):
        for k in range(K):
            ds_j, dv_j = pp.painn_message_fused_banded(
                jnp.asarray(phi[c, k]), jnp.asarray(vcat[c, k]), jnp.asarray(rbf[c]),
                jnp.asarray(envm[c][:, None]), jnp.asarray(nbr[c][:, None]),
                jnp.asarray(unit[c]), jnp.asarray(dw[k]), jnp.asarray(db[k][None]), ws,
                band.n_blk, band.window, len(band.perm), "f32")
            np.testing.assert_allclose(ds[c, k].numpy(), np.asarray(ds_j), **KERNEL_TOL)
            np.testing.assert_allclose(
                dv[c, k].numpy(), np.concatenate([np.asarray(dv_j[x]) for x in range(3)], 1),
                **KERNEL_TOL)


def test_banded_kernel_limits_raise():
    """Rows 7 and 8 refuse, before a launch, what the kernel does not take:
    R = 32 (8, 16 and 24 only), F not a multiple of its 16-channel slice,
    and a table that does not start on a 16-byte boundary."""
    x = torch.zeros(64)
    pk._check_banded_kernel("row", 2, 3, 24, 128, x, x[4:])
    with pytest.raises(ValueError, match="radial width must be 8, 16 or 24, got 32"):
        pk._check_banded_kernel("row", 2, 3, 32, 128, x)
    with pytest.raises(ValueError, match="multiple of 16"):
        pk._check_banded_kernel("row", 2, 3, 24, 120, x)
    with pytest.raises(ValueError, match="16-byte boundary"):
        pk._check_banded_kernel("row", 2, 3, 24, 128, x, x[1:])


@pytest.mark.parametrize("R_,T1,refusal", [
    (32, 4, "radial width must be 8, 16 or 24, got 32"),
    (24, 33, "33 species rows exceed the kernel's 32"),
    (24, 4, None),
    (8, 32, None),
])
def test_banded_layer1_wrapper_refuses_before_a_launch(case, monkeypatch, R_, T1, refusal):
    """Row 6's wrapper refuses R = 32 and more than 32 species rows before
    any launch: tensors on a device other than the CPU (meta here) take the
    kernel's path, where the limits are checked before the launch, which
    is replaced by one that fails the test. Shapes within the limits reach
    it (F = 24: the kernel takes any width)."""

    def launched(*args, **kwargs):
        raise AssertionError("launched")

    monkeypatch.setattr(pk, "_launch", launched)
    band = stage_band(case["band"], "meta")
    n_pad, n_ext = band.n_pad, band.n_pad + band.halo
    F_ = 24

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    args = (z(C, n_ext, dtype=torch.int32), z(K, T1, 2 * F_), z(C, n_pad * M, R_),
            z(C, n_pad * M), z(C, n_pad * M, dtype=torch.int32), z(C, 3, n_pad, M),
            z(K, R_, 2 * F_), z(K, 2 * F_))
    if refusal is None:
        with pytest.raises(AssertionError, match="launched"):
            pk.painn_message_l1_banded(*args, band)
    else:
        with pytest.raises(ValueError, match=refusal):
            pk.painn_message_l1_banded(*args, band)
