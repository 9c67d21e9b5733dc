"""The benchmark's frozen work arithmetic equals ``chip_smoke.py``'s on the
same inputs, and a CHGNet evaluation counts only the work the model runs."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

from benchmark.work import kernels as wk  # noqa: E402


@pytest.mark.parametrize("F,R", [(128, 20), (64, 31), (32, 8)])
def test_message_and_conv_operations(F, R):
    assert wk.msg_flops_per_edge(F, R) == cs.msg_flops_per_edge(F, R)
    assert wk.conv_flops_per_edge(F) == cs.conv_flops_per_edge(F)
    assert 8 * F * F == cs.conv_products_per_edge(F, backward=False)


@pytest.mark.parametrize("products,rest,nbytes", [(1e12, 1e10, 1e9), (1e6, 1e6, 1e11), (0, 5e9, 1)])
def test_bound_tc(products, rest, nbytes):
    assert wk.bound_tc_s(products, rest, nbytes) == pytest.approx(
        cs.bwd_bounds(products, rest, nbytes)[1] / 1e3, rel=1e-12)


@pytest.mark.parametrize("C,K,N,F,alive_share", [(2, 3, 124, 128, 0.7), (4, 1, 30, 16, 0.5)])
def test_update_work(C, K, N, F, alive_share):
    n_pad = wk.n_pad(N)
    gen = torch.Generator().manual_seed(0)
    alive = torch.zeros((C, n_pad))
    alive[:, :N] = (torch.rand((C, N), generator=gen) < alive_share).float()
    args = (torch.zeros((C, K, n_pad, F)), torch.zeros((C, K, n_pad, 3 * F)),
            torch.zeros((K, F, F)), torch.zeros((K, F, F)), torch.zeros((K, 2 * F, F)),
            torch.zeros((K, F)), torch.zeros((K, F, 3 * F)), torch.zeros((K, 3 * F)), alive)
    products, rest, nbytes = cs.update_work(args)
    counts = wk.StateCounts(C, N, int(alive.sum()), 0, 0)
    want = 1e-3 * cs.bwd_bounds(products, rest, nbytes)[1]
    assert wk.painn_update_s(counts, K, F) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("F,n_conv,hidden", [(64, 4, 64), (32, 2, 16)])
@pytest.mark.parametrize("counts", [wk.StateCounts(64, 276, 5000, 380000, 9000),
                                    wk.StateCounts(1, 276, 80, 6100, 150)], ids=["64", "1"])
def test_chgnet_counts_the_atom_convs_and_the_readout(F, n_conv, hidden, counts):
    # the published bond graph and bond / angle updates reach no output and
    # the model does not run them: no count of bonds or angles enters
    assert wk.StateCounts._fields == ("chains", "slots", "alive", "live_edges", "present")
    atom = counts.alive * 10 * F * F + counts.live_edges * wk.conv_flops_per_edge(F)
    readout = counts.alive * 2 * (F * hidden + 2 * hidden * hidden + hidden)
    assert wk.chgnet_eval_flops(counts, F, n_conv, hidden) == n_conv * atom + readout
    other = counts._replace(chains=3, slots=512, present=1)
    assert wk.chgnet_eval_flops(other, F, n_conv, hidden) == n_conv * atom + readout
