"""The facts the CHGNet atom-conv kernels (rows 10-12) rely on, shown on the
plain versions on the CPU.

``csrc/chgnet_conv.cuh`` computes each centre's live edges only (maskf !=
0): a masked edge's be and bw are never loaded, and the backward writes g_be
and g_bw as exact zeros at masked slots without computing them. That is the
same function only if

- a masked edge contributes nothing, whatever its be and bw hold: the plain
  versions give bitwise the same agg, g_ai2 and g_aj2 when those values are
  replaced by random finite ones;
- the plain g_be and g_bw are exactly 0 at masked edges;
- and the JAX package's Pallas kernels (interpret mode, f32 routing) agree
  with the plain versions, with and without the masked edges' values
  replaced, at the JAX tests' 1e-4.

The card tests (``tests/test_torch_cuda_kernels.py``) hold the kernels
themselves to these on the GPU, with NaN in the masked edges' be and bw; the
last test here pins the limits the wrappers check before a launch. The toy
shapes and seeded inputs of ``tests/test_torch_chgnet_kernels.py`` (F = M =
8), and a case past the kernels' first slot-list capacity (M = 160, one
chain of 8 centres), on one torch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chgnet_kernels import F, _inputs, _jax_args, _live_halves, _torch_args

from surface_sampling_tpu.ops import pallas_chgnet as pc
from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

TOL = dict(rtol=1e-4, atol=1e-4)
C, N_PAD = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the comparisons are bitwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, n_chains, n_pad, m):
    """Inputs (numpy), a copy whose masked edges carry random finite be and
    bw, and the cotangent of agg."""
    rng = np.random.default_rng(seed)
    x = _inputs(rng, n_chains, n_pad, m=m)
    dead = x["maskf"] == 0
    assert dead.any() and (~dead).any()
    y = dict(x)
    for k in ("be", "bw"):
        y[k] = np.where(dead[..., None], 10 * rng.normal(size=x[k].shape), x[k]).astype(np.float32)
        assert (y[k] != x[k]).any()
    gagg = rng.normal(size=(n_chains, n_pad, F)).astype(np.float32)
    return dict(x=x, replaced=y, gagg=gagg, dead=torch.as_tensor(dead), chains=n_chains)


@pytest.fixture(scope="module")
def case():
    return _case(31, C, N_PAD, 8)


@pytest.fixture(scope="module")
def case_m160():
    """M = 160 slots a centre: past the kernels' 128-slot instantiation."""
    return _case(37, 1, 8, 160)


def test_masked_edges_leave_the_plain_conv_unchanged(case):
    """Random finite be and bw on the maskf == 0 edges change neither the
    plain agg nor the plain g_ai2 and g_aj2 (torch.equal)."""
    gagg = torch.as_tensor(case["gagg"])
    a, b = _torch_args(case["x"]), _torch_args(case["replaced"])
    assert torch.equal(ck.chgnet_conv_plain(*a), ck.chgnet_conv_plain(*b))
    ga = ck.chgnet_conv_bwd_plain(*a, gagg, want_weights=False)
    gb = ck.chgnet_conv_bwd_plain(*b, gagg, want_weights=False)
    assert torch.equal(ga[0], gb[0]) and torch.equal(ga[1], gb[1])


def test_plain_bond_cotangents_are_zero_at_masked_edges(case):
    """The plain g_be and g_bw are exactly 0 at every masked edge, whatever
    its be and bw hold: the kernel writes zeros there without computing."""
    gagg = torch.as_tensor(case["gagg"])
    for x in (case["x"], case["replaced"]):
        g = ck.chgnet_conv_bwd_plain(*_torch_args(x), gagg, want_weights=False)
        assert bool((g[2][case["dead"]] == 0).all()) and bool((g[3][case["dead"]] == 0).all())


@pytest.mark.parametrize("m", [8, 160])
@pytest.mark.parametrize("part", ["forward", "backward"])
@pytest.mark.parametrize("replaced", [False, True])
def test_plain_conv_matches_pallas(request, m, part, replaced):
    """Rows 10 and 12's plain versions against the JAX Pallas kernels
    (``_conv_pallas``, ``_conv_bwd_pallas``; interpret mode, routing="f32"),
    each chain against one JAX call, with the masked edges' be and bw as
    drawn or replaced; at M = 8 and at M = 160 slots a centre."""
    case = request.getfixturevalue("case" if m == 8 else "case_m160")
    x = case["replaced" if replaced else "x"]
    n_chains = case["chains"]
    if part == "forward":
        got = ck.chgnet_conv_plain(*_torch_args(x)).numpy()
        for c in range(n_chains):
            want = pc._conv_pallas(*_jax_args(x, c), n_blk=8, routing="f32")
            np.testing.assert_allclose(got[c], np.asarray(want), **TOL)
        return
    gagg = case["gagg"]
    got = ck.chgnet_conv_bwd_plain(*_torch_args(x), torch.as_tensor(gagg))
    per_chain = [_live_halves(pc._conv_bwd_pallas(*_jax_args(x, c), jnp.asarray(gagg[c]),
                                                  n_blk=8, routing="f32"))
                 for c in range(n_chains)]
    for k, name in enumerate(ck.GRAD_NAMES):
        want = (np.stack([g[k] for g in per_chain]) if k < 4
                else sum(g[k] for g in per_chain))
        np.testing.assert_allclose(got[k].numpy(), want, err_msg=name, **TOL)


def test_conv_kernel_limits_raise():
    """Rows 10-12 refuse, before a launch, what the kernels do not take: F
    other than 64, more than KERNEL_MAX_M slots a centre (each warp lists
    its centre's live slots in shared memory), more chains than the
    neighbour pass's grid, 2^31 or more (chain, centre) items, and a row
    tensor that does not start on a 16-byte boundary."""
    x = torch.zeros(64)
    ck._check_kernel("row", 8, 288, ck.KERNEL_MAX_M, 64, x, x[4:])
    with pytest.raises(ValueError, match="built for F = 64, got 32"):
        ck._check_kernel("row", 8, 288, 96, 32)
    with pytest.raises(ValueError, match=f"M={ck.KERNEL_MAX_M + 1} slots a centre"):
        ck._check_kernel("row", 8, 288, ck.KERNEL_MAX_M + 1, 64)
    with pytest.raises(ValueError, match="grid limit"):
        ck._check_kernel("row", ck.MAX_CHAINS + 1, 288, 96, 64)
    with pytest.raises(ValueError, match="exceed the work list"):
        ck._check_kernel("row", 65535, 2 ** 15 + 1, 96, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ck._check_kernel("row", 8, 288, 96, 64, x, x[1:])



def test_conv_kernel_takes_m_past_128_and_names_its_limits():
    """The kernels are built at two slot-list capacities, 128 and 256: M =
    160 passes the wrapper's checks; one slot more than KERNEL_MAX_M, and F
    other than KERNEL_F, are refused with messages naming the limit."""
    x = torch.zeros(64)
    assert ck.KERNEL_MAX_M == 256 and ck.KERNEL_F == 64
    ck._check_kernel("row", 8, 288, 160, 64, x, x[4:])
    with pytest.raises(ValueError, match="at most KERNEL_MAX_M = 256"):
        ck._check_kernel("row", 8, 288, 257, 64)
    with pytest.raises(ValueError, match="built for F = 64, got 128"):
        ck._check_kernel("row", 8, 288, 160, 128)
