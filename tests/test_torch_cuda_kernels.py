"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test takes the ``cuda_device`` fixture, which skips
with a reason when no CUDA device is visible. Run them on an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: max|kernel - plain| <= 1e-4 * max|plain|. Both sum the same
f32 terms in another order; an indexing fault moves values by O(max|plain|).
"""

import pytest
import torch

from surface_sampling_tpu_torch.ops import painn_kernels as pk

pytestmark = pytest.mark.cuda
RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    from surface_sampling_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _inputs(dev, C=3, K=2, n_pad=32, M=16, R=24, F=128, T=3, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    E = n_pad * M
    envm = rn(C, E).abs() * (torch.rand((C, E), generator=g, device=dev) > 0.3)
    return dict(
        C=C, K=K, n_pad=n_pad, F=F,
        species=torch.randint(0, T + 1, (C, n_pad), generator=g, device=dev,
                              dtype=torch.int32),
        philt=torch.cat([rn(K, T, 2 * F), torch.zeros((K, 1, 2 * F), device=dev)], 1),
        rbf=rn(C, E, R), envm=envm,
        nbr=torch.randint(0, n_pad, (C, E), generator=g, device=dev, dtype=torch.int32),
        unit=rn(C, 3, n_pad, M), rn=rn,
    )


def _assert_close(got, ref):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = float((a.cpu() - b.cpu()).abs().max())
        assert err <= RTOL * float(b.abs().max()), err


@pytest.mark.parametrize("R", [8, 24])
def test_message_l1_kernel_matches_plain(cuda_device, R):
    x = _inputs(cuda_device, R=R)
    rn, K, F = x["rn"], x["K"], x["F"]
    args = (x["species"], x["philt"], x["rbf"], x["envm"], x["nbr"], x["unit"],
            rn(K, R, 2 * F), rn(K, 2 * F))
    before = pk.painn_message_l1.launches
    got = pk.painn_message_l1(*args)
    assert pk.painn_message_l1.launches == before + 1
    _assert_close(got, pk.painn_message_l1_plain(*args))


@pytest.mark.parametrize("R", [16, 24])
def test_message_fused_kernel_matches_plain(cuda_device, R):
    x = _inputs(cuda_device, R=R, seed=1)
    rn, C, K, n_pad, F = x["rn"], x["C"], x["K"], x["n_pad"], x["F"]
    args = (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), x["rbf"], x["envm"], x["nbr"],
            x["unit"], rn(K, R, 3 * F), rn(K, 3 * F))
    before = pk.painn_message_fused.launches
    got = pk.painn_message_fused(*args)
    assert pk.painn_message_fused.launches == before + 1
    _assert_close(got, pk.painn_message_fused_plain(*args))


@pytest.mark.parametrize("n_pad", [32, 36])
def test_update_kernel_matches_plain(cuda_device, n_pad):
    """n_pad = 36 leaves a partial tile of rows in the last block."""
    x = _inputs(cuda_device, n_pad=n_pad, seed=2)
    rn, C, K, F = x["rn"], x["C"], x["K"], x["F"]
    w = 1.0 / F ** 0.5
    alive = (torch.rand((C, n_pad), device=cuda_device) < 0.7).float()
    args = (rn(C, K, n_pad, F), rn(C, K, n_pad, 3 * F), rn(K, F, F) * w, rn(K, F, F) * w,
            rn(K, 2 * F, F) * w, rn(K, F), rn(K, F, 3 * F) * w, rn(K, 3 * F), alive)
    before = pk.painn_update_fused.launches
    got = pk.painn_update_fused(*args)
    assert pk.painn_update_fused.launches == before + 1
    _assert_close(got, pk.painn_update_fused_plain(*args))


def test_mixed_devices_raise(cuda_device):
    x = _inputs(cuda_device)
    rn, K, F = x["rn"], x["K"], x["F"]
    with pytest.raises(ValueError, match="is on"):
        pk.painn_message_l1(x["species"], x["philt"].cpu(), x["rbf"], x["envm"], x["nbr"],
                            x["unit"], rn(K, 24, 2 * F), rn(K, 2 * F))


def test_flagship_energy_on_card_matches_cpu(cuda_device):
    """End to end through the kernels: pristine anchor and random states
    agree with the CPU plain path to 1e-3 eV."""
    import numpy as np

    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    gpu, cpu = srtio3_001_painn(device=cuda_device), srtio3_001_painn(device="cpu")
    rng = np.random.default_rng(6)
    ss = rng.integers(0, 4, (4, gpu.spec.n_sites))
    ss = torch.as_tensor(np.where(rng.random(ss.shape) < 0.9, 0, ss))
    ss[0] = 0
    e_gpu = gpu.run.state_energy_fn(ss.to(cuda_device)).surface_energy.cpu()
    e_cpu = cpu.run.state_energy_fn(ss).surface_energy
    assert abs(float(e_gpu[0]) - 12.49) < 0.02
    assert float((e_gpu - e_cpu).abs().max()) <= 1e-3


def _bwd_args(x, R, dead_rows=4):
    """Backward inputs on the card: a third of the edges masked (envm = 0)
    and the last ``dead_rows`` rows padded (no edges out, none in)."""
    rn, C, K, n_pad, F = x["rn"], x["C"], x["K"], x["n_pad"], x["F"]
    M = x["unit"].shape[-1]
    envm = x["envm"].clone().view(C, n_pad, M)
    envm[:, n_pad - dead_rows:] = 0.0
    nbr = torch.where(envm > 0, x["nbr"].view(C, n_pad, M) % (n_pad - dead_rows), 0)
    return (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), x["rbf"], envm.view(C, -1),
            nbr.view(C, -1).to(torch.int32).contiguous(), x["unit"], rn(K, R, 3 * F),
            rn(K, 3 * F), rn(C, K, n_pad, F), rn(C, K, n_pad, 3 * F))


@pytest.mark.parametrize("R", [8, 24])
def test_message_bwd_kernel_matches_plain(cuda_device, R):
    """All seven cotangents (g_dw / g_db requested) against the plain
    version, with masked and padded edges; a second launch repeats the
    first bitwise (no float atomics)."""
    from surface_sampling_tpu_torch.ops.neighbors import reverse_table

    x = _inputs(cuda_device, R=R, seed=3)
    args = _bwd_args(x, R)
    rev = reverse_table(args[4], args[3] != 0, x["n_pad"])
    before = pk.painn_message_bwd.launches, pk.painn_message_bwd.dw_launches
    got = pk.painn_message_bwd(*args, rev=rev, want_dw=True)
    assert (pk.painn_message_bwd.launches, pk.painn_message_bwd.dw_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_close(got, pk.painn_message_bwd_plain(*args))
    again = pk.painn_message_bwd(*args, rev=None, want_dw=True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_fused_autograd_on_card_matches_cpu(cuda_device):
    """The gradient through painn_message_fused (forward kernel, backward
    kernel) equals the CPU plain path's; g_dw only when dw requires grad."""
    x = _inputs(cuda_device, R=24, seed=4)
    args = _bwd_args(x, 24)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        a = [t.detach().to(dev, copy=True) for t in args[:8]]
        leaves = [a[i].requires_grad_(True) for i in (0, 1, 2, 3, 5, 6, 7)]
        ds, dv = pk.painn_message_fused(*a)
        grads.append(torch.autograd.grad((ds, dv), leaves, (args[8].to(dev), args[9].to(dev))))
    _assert_close([g.cpu() for g in grads[0]], grads[1])
    before = pk.painn_message_bwd.dw_launches
    a = [t.detach().clone() for t in args[:8]]
    a[0].requires_grad_(True)
    ds, dv = pk.painn_message_fused(*a)
    torch.autograd.grad((ds, dv), a[0], (args[8], args[9]))
    assert pk.painn_message_bwd.dw_launches == before


def test_forces_on_card_match_cpu_without_g_dw(cuda_device):
    """energy_and_forces of the flagship at the compile entry point's
    inputs: card vs CPU within 1e-3 eV and 1e-3 eV/A, three backward
    launches (one per layer) and none of the g_dw part."""
    from surface_sampling_tpu_torch.core import state as st
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    out = []
    for dev in (cuda_device, torch.device("cpu")):
        sys_ = srtio3_001_painn(device=dev)
        d = sys_.run.d
        ss = torch.zeros((1, sys_.spec.n_sites), dtype=torch.int64, device=dev)
        ss[0, 0] = 1
        pk.reset_launch_counts()
        out.append(sys_.potential.energy_and_forces(
            st.realize_positions(d, ss), st.realize_type_idx(d, ss), st.realize_alive(d, ss)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = pk.launch_counts()
            assert counts["painn_message_bwd"] == 3 and counts["painn_message_fused"] == 3
            assert counts["painn_message_bwd.g_dw"] == 0
    (e_gpu, f_gpu), (e_cpu, f_cpu) = out
    assert abs(float(e_gpu[0]) - float(e_cpu[0])) <= 1e-3
    assert float((f_gpu.cpu() - f_cpu).abs().max()) <= 1e-3
