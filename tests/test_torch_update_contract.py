"""The facts the update kernel (row 3) and the layer-1 message kernel (row
1) rely on, shown on the plain versions on the CPU.

``csrc/painn_update_fused.cu`` computes the alive rows (alive != 0) only
and writes exact zeros to the others without reading them. That is the same
function only if the plain update gives exact zeros on a dead row whatever
the row holds, and an alive row's outputs do not depend on the other rows.
``csrc/painn_message_l1.cu`` runs row 6's species-binned body on an identity
band, never reading a dead edge's rbf, unit vector or neighbour index: the
plain layer-1 message is the plain banded one on that band, and both are
blind to a dead edge's values, NaN included.

The wrappers' limits are checked before a launch: tensors on the meta
device take the kernel's path, where a launch that fails the test stands in
for the card's. The card tests (``tests/test_torch_cuda_kernels.py``) hold
the kernels themselves to these on the GPU.
"""

import numpy as np
import pytest
import torch

from surface_sampling_tpu_torch.models.painn import painn_update
from surface_sampling_tpu_torch.ops import painn_kernels as pk
from surface_sampling_tpu_torch.ops.banding import identity_band

C, K, N_PAD, F = 3, 2, 20, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the comparisons are bitwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _update_args(rng, alive_share=0.5, dtype=np.float32):
    w = 1.0 / np.sqrt(F)

    def rn(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.normal(size=shape)).astype(dtype))

    alive = torch.as_tensor((rng.random((C, N_PAD)) < alive_share).astype(dtype))
    return [rn(C, K, N_PAD, F), rn(C, K, N_PAD, 3 * F), rn(K, F, F, scale=w),
            rn(K, F, F, scale=w), rn(K, 2 * F, F, scale=w), rn(K, F), rn(K, F, 3 * F, scale=w),
            rn(K, 3 * F), alive]


def test_plain_update_zeroes_dead_rows_whatever_they_hold():
    """Rows with alive = 0 come out exactly 0 when their s and vcat hold
    large random finite values, and the alive rows' outputs stay bitwise
    the same: a row's update reads only its own row."""
    rng = np.random.default_rng(0)
    args = _update_args(rng)
    dead = (args[-1] == 0)[:, None, :, None]
    assert bool(dead.any()) and bool((~dead).any())
    ref = pk.painn_update_fused_plain(*args)
    noisy = list(args)
    noisy[0] = torch.where(dead, torch.as_tensor(rng.normal(0, 1e3, args[0].shape),
                                                 dtype=torch.float32), args[0])
    noisy[1] = torch.where(dead, torch.as_tensor(rng.normal(0, 1e3, args[1].shape),
                                                 dtype=torch.float32), args[1])
    got = pk.painn_update_fused_plain(*noisy)
    for r, g in zip(ref, got):
        assert bool((g.masked_select(dead) == 0).all())
        assert torch.equal(r.masked_select(~dead), g.masked_select(~dead))


def test_general_trunk_update_is_the_plain_update_and_differentiable():
    """``models.painn.painn_update`` (the general trunk's update) gives
    bitwise the plain version's outputs, and its gradients agree with finite
    differences (float64)."""
    rng = np.random.default_rng(1)
    args = _update_args(rng)
    for a, b in zip(painn_update(*args), pk.painn_update_fused_plain(*args)):
        assert torch.equal(a, b)
    g = np.random.default_rng(2)
    k, n, f = 2, 3, 4
    small = [torch.as_tensor(g.normal(size=shape), dtype=torch.float64).requires_grad_()
             for shape in ((1, k, n, f), (1, k, n, 3 * f), (k, f, f), (k, f, f), (k, 2 * f, f),
                           (k, f), (k, f, 3 * f), (k, 3 * f))]
    small.append(torch.tensor([[1.0, 0.0, 1.0]], dtype=torch.float64))
    assert torch.autograd.gradcheck(lambda *x: painn_update(*x), small, eps=1e-6, atol=1e-5)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("F_, C_, refusal", [(128, 2, None), (256, 2, None), (64, 2, None),
                                             (24, 2, "multiple of 16"),
                                             (272, 2, "multiple of 16"),
                                             (128, 2 ** 28, "32-bit row numbers")])
def test_update_wrapper_refuses_before_a_launch(monkeypatch, F_, C_, refusal):
    """Row 3's wrapper refuses F that is not a multiple of 16 up to 256, and
    more rows than its 32-bit row numbers count, before any launch; the
    shapes it takes reach the launch."""

    def launched(*args, **kwargs):
        raise AssertionError("launched")

    monkeypatch.setattr(pk, "_launch", launched)
    args = (_meta(C_, 3, 10, F_), _meta(C_, 3, 10, 3 * F_), _meta(3, F_, F_), _meta(3, F_, F_),
            _meta(3, 2 * F_, F_), _meta(3, F_), _meta(3, F_, 3 * F_), _meta(3, 3 * F_),
            _meta(C_, 10))
    if refusal is None:
        with pytest.raises(AssertionError, match="launched"):
            pk.painn_update_fused(*args)
    else:
        with pytest.raises(ValueError, match=refusal):
            pk.painn_update_fused(*args)


@pytest.mark.parametrize("R_, T1, refusal", [(24, 4, None), (8, 32, None),
                                             (32, 4, "radial width"), (24, 33, "species rows")])
def test_layer1_wrapper_refuses_before_a_launch(monkeypatch, R_, T1, refusal):
    """Row 1's wrapper refuses R = 32 and more than 32 species rows (the
    binned body's limits) before any launch."""

    def launched(*args, **kwargs):
        raise AssertionError("launched")

    monkeypatch.setattr(pk, "_launch", launched)
    n_pad, M, F_ = 8, 4, 24
    args = (_meta(2, n_pad, dtype=torch.int32), _meta(3, T1, 2 * F_), _meta(2, n_pad * M, R_),
            _meta(2, n_pad * M), _meta(2, n_pad * M, dtype=torch.int32), _meta(2, 3, n_pad, M),
            _meta(3, R_, 2 * F_), _meta(3, 2 * F_))
    if refusal is None:
        with pytest.raises(AssertionError, match="launched"):
            pk.painn_message_l1(*args)
    else:
        with pytest.raises(ValueError, match=refusal):
            pk.painn_message_l1(*args)


def test_plain_layer1_is_the_banded_one_on_an_identity_band_with_nan_dead_edges():
    """The plain layer-1 message equals the plain banded one on an identity
    band bitwise, and NaN rbf and unit vectors on the dead edges (envm ==
    0) leave both bitwise as they were with finite ones."""
    rng = np.random.default_rng(3)
    n_pad, M, R, T, F_ = 16, 6, 8, 3, 8
    E = n_pad * M
    envm = np.abs(rng.normal(size=(C, E))) * (rng.random((C, E)) > 0.4)
    args = [rng.integers(0, T + 1, (C, n_pad)).astype(np.int32),
            np.concatenate([rng.normal(size=(K, T, 2 * F_)), np.zeros((K, 1, 2 * F_))], 1),
            rng.normal(size=(C, E, R)), envm, rng.integers(0, n_pad, (C, E)).astype(np.int32),
            rng.normal(size=(C, 3, n_pad, M)), rng.normal(size=(K, R, 2 * F_)),
            rng.normal(size=(K, 2 * F_))]
    args = [torch.as_tensor(a if a.dtype == np.int32 else a.astype(np.float32)) for a in args]
    dead = args[3] == 0
    assert bool(dead.any())
    nan = float("nan")
    dirty = list(args)
    dirty[2] = torch.where(dead[..., None], nan, args[2])
    dirty[5] = torch.where(dead.reshape(C, 1, n_pad, M), nan, args[5])
    band = identity_band(n_pad, 4, "cpu")
    ref = pk.painn_message_l1_plain(*args)
    assert float(ref[1].abs().max()) > 0
    for out in (pk.painn_message_l1_plain(*dirty), pk.painn_message_l1_banded_plain(*args, band),
                pk.painn_message_l1_banded_plain(*dirty, band)):
        assert all(torch.equal(a, b) for a, b in zip(ref, out))
