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
from surface_sampling_tpu_torch.ops.neighbors import reverse_table

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


def _assert_bwd_close(got, ref, envm):
    """Rows 4 and 9 against their plain versions under the dead-edge
    contract: every output within RTOL x max|plain|, except g_envm (index
    3), which is compared on the edges with envm != 0 and must be exactly 0
    on the others (the plain version's value there never reaches a
    position; ROADMAP Queue 3)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    live = (envm != 0).cpu()
    assert bool((got[3].cpu()[~live] == 0).all())
    _assert_close([*got[:3], got[3].cpu()[live], *got[4:]],
                  [*ref[:3], ref[3].cpu()[live], *ref[4:]])


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


@pytest.mark.parametrize("R", [8, 16, 24])
def test_message_fused_kernel_matches_plain(cuda_device, R):
    x = _inputs(cuda_device, R=R, seed=1)
    rn, C, K, n_pad, F = x["rn"], x["C"], x["K"], x["n_pad"], x["F"]
    args = (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), x["rbf"], x["envm"], x["nbr"],
            x["unit"], rn(K, R, 3 * F), rn(K, 3 * F))
    before = pk.painn_message_fused.launches
    got = pk.painn_message_fused(*args)
    assert pk.painn_message_fused.launches == before + 1
    _assert_close(got, pk.painn_message_fused_plain(*args))


def _message_case(dev, C, K, n_pad, M, R, F, seed, prefix=False):
    """Row 2's inputs with ~60% dead edges (envm == 0), scattered over the
    slots or the live ones a prefix of each centre's slots."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    E = n_pad * M
    live = torch.rand((C, n_pad, M), generator=g, device=dev) > 0.6
    if prefix:
        live = torch.arange(M, device=dev) < live.sum(-1, keepdim=True)
    envm = (rn(C, n_pad, M).abs() * live).reshape(C, E).contiguous()
    nbr = torch.randint(0, n_pad, (C, E), generator=g, device=dev, dtype=torch.int32)
    return (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), rn(C, E, R), envm, nbr,
            rn(C, 3, n_pad, M), rn(K, R, 3 * F), rn(K, 3 * F)), g


@pytest.mark.parametrize("shape", [(3, 2, 32, 16, 24, 128), (4, 3, 128, 64, 24, 128),
                                   (16, 1, 64, 64, 8, 64)])
@pytest.mark.parametrize("prefix", [False, True])
def test_message_fused_is_the_banded_message_on_an_identity_band(cuda_device, shape, prefix):
    """Row 2 equals row 7 on an identity band (every window at row 0, n_pad
    wide, no halo) bitwise, repeats bitwise, and ignores what its dead edges
    (envm == 0) hold: NaN rbf and unit, out-of-range nbr leave ds and dv
    bitwise unchanged. Shapes: the card tests', the flagship's (n_pad 128,
    M 64, three members) and a training step's (16 frames of n_pad 64, one
    member)."""
    from surface_sampling_tpu_torch.ops.banding import identity_band

    C, K, n_pad, M, R, F = shape
    args, g = _message_case(cuda_device, C, K, n_pad, M, R, F, seed=21, prefix=prefix)
    got = pk.painn_message_fused(*args)
    again = pk.painn_message_fused(*args)
    band = pk.painn_message_fused_banded(*args, identity_band(n_pad, 16, cuda_device))
    for a, b, c in zip(got, again, band):
        assert torch.equal(a, b) and torch.equal(a, c)
    _assert_close(got, pk.painn_message_fused_plain(*args))
    phi, vcat, rbf, envm, nbr, unit, dw, db = args
    dead = envm == 0
    nan = float("nan")
    dirty = (phi, vcat, torch.where(dead[..., None], nan, rbf), envm,
             torch.where(dead, torch.randint(-10 ** 6, 10 ** 6, nbr.shape, generator=g,
                                             device=cuda_device, dtype=torch.int32), nbr),
             torch.where(dead.reshape(C, 1, n_pad, M), nan, unit), dw, db)
    for a, b in zip(got, pk.painn_message_fused(*dirty)):
        assert torch.equal(a, b)


def _update_case(dev, C, K, n_pad, F, share, seed):
    """Row 3's inputs: seeded features and weights (scaled as a layer's),
    an alive mask with about ``share`` of the rows alive."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    w = 1.0 / F ** 0.5
    alive = (torch.rand((C, n_pad), generator=g, device=dev) < share).float()
    return (rn(C, K, n_pad, F), rn(C, K, n_pad, 3 * F), rn(K, F, F) * w, rn(K, F, F) * w,
            rn(K, 2 * F, F) * w, rn(K, F), rn(K, F, 3 * F) * w, rn(K, 3 * F), alive)


@pytest.mark.parametrize("n_pad", [32, 36, 50])
@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
def test_update_kernel_matches_plain(cuda_device, n_pad, share):
    """Row 3 at the flagship's width (F = 128, three members) against its
    plain version. n_pad = 36 and 50 leave partial tiles of alive rows (the
    delta engine gathers any row count); no row alive, about half, all."""
    args = _update_case(cuda_device, 3, 3, n_pad, 128, share, seed=2)
    before = pk.painn_update_fused.launches
    got = pk.painn_update_fused(*args)
    assert pk.painn_update_fused.launches == before + 1
    _assert_close(got, pk.painn_update_fused_plain(*args))


@pytest.mark.parametrize("F", [16, 64, 256])
def test_update_kernel_widths(cuda_device, F):
    """Row 3 at other widths: F = 256 takes tiles of 16 rows, F < 128 fewer
    warps a block."""
    args = _update_case(cuda_device, 4, 2, 40, F, 0.6, seed=3)
    _assert_close(pk.painn_update_fused(*args), pk.painn_update_fused_plain(*args))


def test_update_kernel_dead_rows_are_inert_and_bitwise(cuda_device):
    """Row 3 at the 1x1 flagship's shape (n_pad 128, three members, ~56%
    alive): dead rows come out exactly 0, NaN in their s and vcat changes
    no bit of the outputs, and two launches repeat bitwise."""
    args = _update_case(cuda_device, 16, 3, 128, 128, 0.56, seed=4)
    got = pk.painn_update_fused(*args)
    again = pk.painn_update_fused(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dead = (args[-1] == 0)[:, None, :, None]
    assert bool(dead.any()) and bool((~dead).any())
    assert bool((got[0].masked_select(dead) == 0).all())
    assert bool((got[1].masked_select(dead) == 0).all())
    nan = float("nan")
    dirty = (torch.where(dead, nan, args[0]), torch.where(dead, nan, args[1]), *args[2:])
    out = pk.painn_update_fused(*dirty)
    assert all(torch.equal(a, b) for a, b in zip(got, out))
    _assert_close(got, pk.painn_update_fused_plain(*args))


def test_update_kernel_rows_do_not_depend_on_their_tiles(cuda_device):
    """A row's bits do not depend on the rows packed beside it: row 3 over
    rows 16 .. 47 of each chain (as the delta engine gathers blocks) gives
    those rows bitwise what it gives them over all 128."""
    args = _update_case(cuda_device, 8, 3, 128, 128, 0.56, seed=5)
    full = pk.painn_update_fused(*args)
    sub = pk.painn_update_fused(*(a[:, :, 16:48].contiguous() for a in args[:2]), *args[2:8],
                                args[8][:, 16:48].contiguous())
    for a, b in zip(full, sub):
        assert torch.equal(a[:, :, 16:48], b)


@pytest.mark.parametrize("shape", [(3, 2, 32, 16, 24, 3), (4, 3, 128, 64, 24, 3),
                                   (2, 1, 36, 12, 8, 5)])
def test_message_l1_is_the_banded_layer1_on_an_identity_band(cuda_device, shape):
    """Row 1 equals row 6 on an identity band (every window at row 0, n_pad
    wide, no halo) bitwise, repeats bitwise, and ignores what its dead edges
    (envm == 0) hold: NaN rbf and unit, out-of-range nbr leave ds and dv
    bitwise unchanged. Shapes: the card tests', the flagship's (n_pad 128,
    M 64, three members) and one whose n_pad takes 4 centres a block."""
    from surface_sampling_tpu_torch.ops.banding import identity_band

    C, K, n_pad, M, R, T = shape
    x = _inputs(cuda_device, C=C, K=K, n_pad=n_pad, M=M, R=R, T=T, seed=5)
    rn, F = x["rn"], x["F"]
    args = (x["species"], x["philt"], x["rbf"], x["envm"], x["nbr"], x["unit"],
            rn(K, R, 2 * F), rn(K, 2 * F))
    got = pk.painn_message_l1(*args)
    again = pk.painn_message_l1(*args)
    band = pk.painn_message_l1_banded(*args, identity_band(n_pad, 4, cuda_device))
    for a, b, c in zip(got, again, band):
        assert torch.equal(a, b) and torch.equal(a, c)
    _assert_close(got, pk.painn_message_l1_plain(*args))
    species, philt, rbf, envm, nbr, unit, dw2, db2 = args
    dead = envm == 0
    assert bool(dead.any())
    nan = float("nan")
    far = torch.randint(-10 ** 6, 10 ** 6, nbr.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(6), device=cuda_device, dtype=torch.int32)
    dirty = (species, philt, torch.where(dead[..., None], nan, rbf), envm,
             torch.where(dead, far, nbr), torch.where(dead.reshape(C, 1, n_pad, M), nan, unit),
             dw2, db2)
    for a, b in zip(got, pk.painn_message_l1(*dirty)):
        assert torch.equal(a, b)


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


def _bwd_tile_case(dev, K, n_pad, M, R, F, seed):
    """Backward inputs whose live edges cross the kernels' tiles: centre 0
    has all M slots live, centre 1 none, centre 3 a count that ends a
    16-edge tile inside the centre, the last centre (the chain's end) a
    few; row 2 is padding (no edges out, none in); row 4 is read by many
    edges (several 8-edge tiles of the neighbour kernel)."""
    C = 2
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    live = torch.rand((C, n_pad, M), generator=g, device=dev) < 0.35
    live[:, 0] = True
    live[:, 1] = False
    live[:, 2] = False
    live[:, 3] = torch.arange(M, device=dev) < min(M, 21)
    live[:, n_pad - 1] = torch.arange(M, device=dev) < 3
    envm = (rn(C, n_pad, M).abs() + 0.05) * live
    nbr = torch.randint(0, n_pad - 1, (C, n_pad, M), generator=g, device=dev)
    nbr = torch.where(nbr >= 2, nbr + 1, nbr)               # never row 2
    nbr[:, :, : M // 2] = torch.where(live[:, :, : M // 2], 4, nbr[:, :, : M // 2])
    nbr = torch.where(live, nbr, 0).to(torch.int32).view(C, -1).contiguous()
    return (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), rn(C, n_pad * M, R),
            envm.view(C, -1).contiguous(), nbr, rn(C, 3, n_pad, M), rn(K, R, 3 * F),
            rn(K, 3 * F), rn(C, K, n_pad, F), rn(C, K, n_pad, 3 * F))


@pytest.mark.parametrize("want_dw", [False, True])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("F", [64, 128])
@pytest.mark.parametrize("R", [8, 16, 24])
def test_message_bwd_kernel_matches_plain(cuda_device, R, F, K, want_dw):
    """Row 4 against the plain version under the dead-edge contract, on
    live edges that cross the kernels' tiles (``_bwd_tile_case``) and on
    ``_bwd_args``' masked and padded edges; one launch counted (and one
    g_dw launch when asked), and a second launch repeats the first bitwise
    (no float atomics)."""
    x = _inputs(cuda_device, K=K, F=F, R=R, seed=3)
    for args in (_bwd_args(x, R), _bwd_tile_case(cuda_device, K, 24, 40, R, F, seed=R + F + K)):
        n_pad = args[0].shape[2]
        rev = reverse_table(args[4], args[3] != 0, n_pad)
        before = pk.painn_message_bwd.launches, pk.painn_message_bwd.dw_launches
        got = pk.painn_message_bwd(*args, rev=rev, want_dw=want_dw)
        assert (pk.painn_message_bwd.launches, pk.painn_message_bwd.dw_launches) == (
            before[0] + 1, before[1] + int(want_dw))
        ref = pk.painn_message_bwd_plain(*args, want_dw=want_dw)
        n_out = 7 if want_dw else 5
        assert all(r is None for r in got[n_out:])
        _assert_bwd_close(got[:n_out], ref[:n_out], args[3])
        again = pk.painn_message_bwd(*args, rev=None, want_dw=want_dw)
        for a, b in zip(got[:n_out], again[:n_out]):
            assert torch.equal(a, b)


def test_fused_autograd_on_card_matches_cpu(cuda_device):
    """The gradient through painn_message_fused (forward kernel, backward
    kernel) equals the CPU plain path's (the envm leaf on live edges, zero
    on dead ones); g_dw only when dw requires grad."""
    x = _inputs(cuda_device, R=24, seed=4)
    args = _bwd_args(x, 24)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        a = [t.detach().to(dev, copy=True) for t in args[:8]]
        leaves = [a[i].requires_grad_(True) for i in (0, 1, 2, 3, 5, 6, 7)]
        ds, dv = pk.painn_message_fused(*a)
        grads.append(torch.autograd.grad((ds, dv), leaves, (args[8].to(dev), args[9].to(dev))))
    # the envm leaf (index 3) on live edges only: the kernel gives exact
    # zeros at dead edges (dead-edge contract, ROADMAP Queue 3)
    _assert_bwd_close([g.cpu() for g in grads[0]], grads[1], args[3])
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


def _line_band(n_blk=16, n=42, n_pad=48, n_cand=12):
    """A routing band over n slots on an n A periodic line (candidates:
    the n_cand nearest), n_pad rows in blocks of n_blk, with a halo."""
    import numpy as np

    from surface_sampling_tpu_torch.ops.banding import build_routing_band

    x = np.arange(n, dtype=np.float64)
    diff = (x[None, :] - x[:, None] + n / 2) % n - n / 2
    slot_j = np.argsort(np.abs(diff) + np.eye(n) * 1e9, axis=1)[:, :n_cand].astype(np.int32)
    band = build_routing_band(np.stack([x, 0 * x, 0 * x], 1), slot_j,
                              np.ones_like(slot_j, bool), n_blk, n_pad)
    return band, slot_j


def _banded_geometry(dev, band, slot_j, centre_slot, M, R, g, prefix=False):
    """Edge geometry of the centres ``centre_slot`` (C, rows): neighbour
    ranks among each centre's candidates, a third of the edges masked at
    random, or (``prefix``) each centre's live edges a random prefix of its
    slots, as the rigid tables order them."""
    C, rows = centre_slot.shape
    cand = torch.as_tensor(slot_j, device=dev)[centre_slot.clamp(max=slot_j.shape[0] - 1)]
    pick = torch.randint(0, cand.shape[-1], (C, rows, M), generator=g, device=dev)
    rank = torch.as_tensor(band.rank, device=dev).long()
    nbr = rank[torch.gather(cand.long(), 2, pick)].reshape(C, rows * M).to(torch.int32)
    envm = torch.rand((C, rows * M), generator=g, device=dev)
    if prefix:
        n_live = torch.randint(0, M + 1, (C, rows, 1), generator=g, device=dev)
        live = (torch.arange(M, device=dev) < n_live).reshape(C, rows * M)
    else:
        live = torch.rand((C, rows * M), generator=g, device=dev) > 0.33
    return (torch.randn((C, rows * M, R), generator=g, device=dev), envm * live,
            nbr.contiguous(), torch.randn((C, 3, rows, M), generator=g, device=dev))


def _banded_case(dev, R, n_blk=16, M=16, prefix=False, seed=7, **band_kw):
    """Row 7's inputs on a line band (C = 3, K = 2, F = 128), and row 8's
    over per-chain blocks with one chain repeating a block."""
    from surface_sampling_tpu_torch.ops.banding import stage_band

    C, K, F = 3, 2, 128
    band, slot_j = _line_band(n_blk, **band_kw)
    dband = stage_band(band, dev)
    n_pad = dband.n_pad
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    geom = _banded_geometry(dev, band, slot_j, dband.perm.expand(C, -1), M, R, g, prefix)
    n_ext = n_pad + band.halo
    phi, vcat = rn(C, K, n_ext, 3 * F), rn(C, K, n_ext, 3 * F)
    dw, db = rn(K, R, 3 * F), rn(K, 3 * F)
    nb = n_pad // n_blk
    blocks = torch.tensor([[nb - 1, 0], [1, 1], [0, nb - 1]], device=dev)
    rows = (blocks[..., None] * n_blk + torch.arange(n_blk, device=dev)).reshape(C, -1)
    sub_geom = _banded_geometry(dev, band, slot_j, dband.perm[rows], M, R, g, prefix)
    return dict(g=g, rn=rn, full=(phi, vcat, *geom, dw, db, dband),
                subset=(phi, vcat, *sub_geom, dw, db, dband.win_start[blocks], dband))


def _layer1_args(x, R, T=3):
    """Row 6's inputs on a _banded_case: its band and geometry, species rows
    of the halo-extended table (T species and the zero row), philt and the
    layer-1 weights from the case's generator."""
    rn, (phi, _, rbf, envm, nbr, unit, _, _, dband) = x["rn"], x["full"]
    C, K, n_ext, F = phi.shape[0], phi.shape[1], phi.shape[2], phi.shape[3] // 3
    dev = phi.device
    species = torch.randint(0, T + 1, (C, n_ext), generator=x["g"], device=dev,
                            dtype=torch.int32)
    philt = torch.cat([rn(K, T, 2 * F), torch.zeros((K, 1, 2 * F), device=dev)], 1)
    return (species, philt, rbf, envm, nbr, unit, rn(K, R, 2 * F), rn(K, 2 * F), dband)


@pytest.mark.parametrize("R", [8, 16, 24])
def test_banded_kernels_match_plain(cuda_device, R):
    """Rows 6-8 (banded layer-1, banded general, subset) against their
    plain versions on a real band with a halo; the subset over per-chain
    blocks, one chain repeating a block; each kernel counts one launch.
    Rows 6-8 also at a production-like shape: blocks of 8 centres, 64 edge
    slots a centre, live edges both scattered and a prefix."""
    dev, T = cuda_device, 3
    x = _banded_case(dev, R)
    rn, (phi, vcat, rbf, envm, nbr, unit, dw, db, dband) = x["rn"], x["full"]
    C, K, F = phi.shape[0], phi.shape[1], phi.shape[3] // 3
    species = torch.randint(0, T + 1, (C, phi.shape[2]), generator=x["g"], device=dev,
                            dtype=torch.int32)
    philt = torch.cat([rn(K, T, 2 * F), torch.zeros((K, 1, 2 * F), device=dev)], 1)
    cases = [(pk.painn_message_l1_banded,
              (species, philt, rbf, envm, nbr, unit, rn(K, R, 2 * F), rn(K, 2 * F), dband)),
             (pk.painn_message_fused_banded, x["full"]),
             (pk.painn_message_subset, x["subset"])]
    for prefix in (False, True):
        y = _banded_case(dev, R, n_blk=8, M=64, prefix=prefix, seed=8, n=124, n_pad=128,
                         n_cand=40)
        cases += [(pk.painn_message_fused_banded, y["full"]),
                  (pk.painn_message_subset, y["subset"]),
                  (pk.painn_message_l1_banded, _layer1_args(y, R))]
    for fn, args in cases:
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1
        _assert_close(got, pk.PLAIN[fn](*args))


@pytest.mark.parametrize("prefix", [False, True])
def test_banded_message_is_per_centre_and_bitwise(cuda_device, prefix):
    """Row 8 over every block of the band, in block order, and over a
    shuffled subset of blocks per chain gives each centre row 7's bits; two
    launches repeat bitwise; dead edges (envm == 0) carrying arbitrary
    finite rbf and unit values change no bit of the output."""
    dev = cuda_device
    x = _banded_case(dev, 24, n_blk=8, M=64, prefix=prefix, seed=9, n=124, n_pad=128,
                     n_cand=40)
    phi, vcat, rbf, envm, nbr, unit, dw, db, dband = x["full"]
    g, C, n_blk = x["g"], phi.shape[0], dband.n_blk
    n_pad, M = dband.n_pad, unit.shape[-1]
    nb = n_pad // n_blk
    full = pk.painn_message_fused_banded(*x["full"])
    again = pk.painn_message_fused_banded(*x["full"])
    assert all(torch.equal(a, b) for a, b in zip(full, again))

    blocks = torch.arange(nb, device=dev).expand(C, -1).contiguous()
    every = pk.painn_message_subset(phi, vcat, rbf, envm, nbr, unit, dw, db,
                                    dband.win_start[blocks], dband)
    assert all(torch.equal(a, b) for a, b in zip(full, every))

    blocks = torch.stack([torch.randperm(nb, generator=g, device=dev)[:nb - 3]
                          for _ in range(C)])
    rows = (blocks[..., None] * n_blk + torch.arange(n_blk, device=dev)).reshape(C, -1)

    def take(t, dim, width):
        v = t.reshape(t.shape[:dim] + (n_pad, width) + t.shape[dim + 1:])
        return torch.stack([v[c].index_select(dim - 1, rows[c]) for c in range(C)]).reshape(
            t.shape[:dim] + (-1,) + t.shape[dim + 1:]).contiguous()

    sub = pk.painn_message_subset(phi, vcat, take(rbf, 1, M), take(envm, 1, M),
                                  take(nbr, 1, M), take(unit, 2, 1),
                                  dw, db, dband.win_start[blocks].contiguous(), dband)
    for a, b in zip(full, sub):
        assert torch.equal(torch.stack([a[c][:, rows[c]] for c in range(C)]), b)

    dead = envm == 0
    rbf_d = torch.where(dead[..., None], 10 * torch.randn(rbf.shape, generator=g, device=dev),
                        rbf)
    unit_d = torch.where(dead.reshape(C, 1, n_pad, M),
                         10 * torch.randn(unit.shape, generator=g, device=dev), unit)
    pert = pk.painn_message_fused_banded(phi, vcat, rbf_d, envm, nbr, unit_d, dw, db, dband)
    assert all(torch.equal(a, b) for a, b in zip(full, pert))


@pytest.mark.parametrize("prefix", [False, True])
def test_banded_layer1_is_bitwise_and_blind_to_dead_edges(cuda_device, prefix):
    """Row 6 at the production-like shape (blocks of 8 centres, 64 slots a
    centre): two launches repeat bitwise, and NaN in the rbf and unit
    vector of every dead edge (envm == 0), and a species row out of range
    read through no live edge, change no bit of ds and dv."""
    x = _banded_case(cuda_device, 24, n_blk=8, M=64, prefix=prefix, seed=10, n=124,
                     n_pad=128, n_cand=40)
    args = _layer1_args(x, 24)
    species, philt, rbf, envm, nbr, unit = args[:6]
    C, M = rbf.shape[0], unit.shape[-1]
    got = pk.painn_message_l1_banded(*args)
    again = pk.painn_message_l1_banded(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dead = envm == 0
    assert bool(dead.any()) and bool((~dead).any())
    nan = float("nan")
    dirty = (species, philt, torch.where(dead[..., None], nan, rbf), envm, nbr,
             torch.where(dead.reshape(C, 1, -1, M), nan, unit), *args[6:])
    out = pk.painn_message_l1_banded(*dirty)
    assert all(torch.equal(a, b) for a, b in zip(got, out))
    assert float(got[1].abs().max()) > 0


@pytest.mark.parametrize("R", [8, 24])
def test_banded_backward_kernel_matches_plain(cuda_device, R):
    """Row 9 (the banded message backward) against its plain version on a
    band of 8-blocks with a halo whose windows wrap, all seven cotangents
    (g_dw / g_db requested; g_envm under the dead-edge contract), with the
    reverse table keyed by extended row;
    one launch counted, and a second launch repeats the first bitwise."""
    from surface_sampling_tpu_torch.ops.banding import banded_reverse_table, stage_band

    dev, C, K, F, M = cuda_device, 3, 2, 128, 16
    band, slot_j = _line_band(8)
    dband = stage_band(band, dev)
    g = torch.Generator(device=dev).manual_seed(11)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    rbf, envm, nbr, unit = _banded_geometry(dev, band, slot_j, dband.perm.expand(C, -1), M, R, g)
    n_ext = 48 + band.halo
    args = (rn(C, K, n_ext, 3 * F), rn(C, K, n_ext, 3 * F), rbf, envm, nbr, unit,
            rn(K, R, 3 * F), rn(K, 3 * F), rn(C, K, 48, F), rn(C, K, 48, 3 * F))
    rev = banded_reverse_table(nbr, envm != 0, dband, None)
    fn = pk.painn_message_bwd_banded
    before = fn.launches, fn.dw_launches
    got = fn(*args, dband, rev=rev, want_dw=True)
    assert (fn.launches, fn.dw_launches) == (before[0] + 1, before[1] + 1)
    _assert_bwd_close(got, pk.painn_message_bwd_banded_plain(*args, dband), envm)
    again = fn(*args, dband, rev=None, want_dw=True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_incremental_run_repeats_bitwise(cuda_device):
    """A short delta-engine run on the 2x2 supercell through the subset
    kernel: the same seed twice gives bitwise identical states and caches,
    and the cached energies equal a fresh full evaluation to 1e-3 eV."""
    from surface_sampling_tpu_torch.core.engine import make_generator
    from surface_sampling_tpu_torch.core.incremental import (
        make_incremental_painn_from_system,
        make_incremental_run,
        make_incremental_semigrand_step,
    )
    from surface_sampling_tpu_torch.parallel.chains import incremental_chain_states
    from surface_sampling_tpu_torch.systems import srtio3_001_painn

    sys_ = srtio3_001_painn(supercell=(2, 2), device=cuda_device)
    eng = make_incremental_painn_from_system(sys_)
    run = make_incremental_run(make_incremental_semigrand_step(eng), 4, eng.n_sites, eng.n_codes)
    states = incremental_chain_states(eng, sys_.run.d, 4)
    before = pk.painn_message_subset.launches
    a, rec_a = run(states, [1.0, 0.9], make_generator(3, cuda_device))
    b, rec_b = run(states, [1.0, 0.9], make_generator(3, cuda_device))
    torch.cuda.synchronize()
    assert pk.painn_message_subset.launches == before + 2 * 2 * 4 * 3
    assert torch.equal(a.site_state, b.site_state) and torch.equal(a.energy, b.energy)
    assert torch.equal(rec_a.energy, rec_b.energy)
    for x, y in zip(a.caches.s + a.caches.phi + a.caches.vcat, b.caches.s + b.caches.phi
                    + b.caches.vcat):
        assert torch.equal(x, y)
    fresh, _, _ = eng.energy_full(a.site_state)
    assert float((fresh - a.energy).abs().max()) <= 1e-3


# ----------------------------------------------------------------------
# CHGNet atom conv (rows 10-12)
# ----------------------------------------------------------------------
def _conv_inputs(dev, C=3, n_pad=36, M=40, seed=7, dead_rows=5):
    """CHGNet conv inputs at the kernels' width F = 64: M = 40 leaves a
    partial tile, a third of the edges are masked and the last
    ``dead_rows`` centres have none (whole tiles skipped); masked edges
    point at row 0, as unselected edges do."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    F = ck.KERNEL_F
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    E = n_pad * M
    maskf = (torch.rand((C, n_pad, M), generator=g, device=dev) > 0.3).float()
    maskf[:, n_pad - dead_rows:] = 0.0
    nbr = torch.randint(0, n_pad - dead_rows, (C, n_pad, M), generator=g, device=dev)
    nbr = torch.where(maskf > 0, nbr, 0).to(torch.int32).reshape(C, E).contiguous()
    lnc = torch.stack([1.0 + rn(F, scale=0.1), rn(F, scale=0.1)])
    lng = torch.stack([1.0 + rn(F, scale=0.1), rn(F, scale=0.1)])
    return (rn(C, n_pad, 2 * F), rn(C, n_pad, 2 * F), rn(C, E, F), rn(C, E, F),
            maskf.reshape(C, E).contiguous(), nbr, rn(F, 2 * F, scale=0.125),
            rn(F, F, scale=0.125), rn(F, F, scale=0.125), rn(F, scale=0.1), rn(F, scale=0.1),
            lnc, lng), rn


def test_chgnet_conv_kernel_matches_plain(cuda_device):
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    args, _ = _conv_inputs(cuda_device)
    before = ck.chgnet_conv.launches
    got = ck.chgnet_conv(*args)
    assert ck.chgnet_conv.launches == before + 1
    _assert_close([got], [ck.chgnet_conv_plain(*args)])
    assert torch.equal(got, ck.chgnet_conv(*args))


@pytest.mark.parametrize("M", [40, 160])
def test_chgnet_conv_banded_kernel_matches_plain(cuda_device, M):
    """Row 11 on a synthetic band (every block's neighbours in a 16-wide
    window of n_pad 32, an 8-row halo) against its plain version and, on
    the same edges, against row 10; M = 160 runs the 256-slot
    instantiation."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.ops.banding import DeviceBand

    n_pad, n_blk, window, halo, C = 32, 8, 16, 8, 2
    args, _ = _conv_inputs(cuda_device, C=C, n_pad=n_pad, M=M, dead_rows=0)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    ws = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=cuda_device)
    blk = ws.long().repeat_interleave(n_blk * M)
    off = torch.randint(0, window, (C, n_pad * M), generator=g, device=cuda_device)
    nbr = ((blk + off) % n_pad).to(torch.int32).contiguous()
    args = list(args)
    args[5] = nbr
    ident = torch.arange(n_pad, device=cuda_device)
    band = DeviceBand(perm=ident, inv_perm=ident, rank=ident, win_start=ws, window=window,
                      halo=halo, n_blk=n_blk)
    ext = list(args)
    ext[1] = torch.cat([args[1], args[1][:, :halo]], dim=1).contiguous()
    before = ck.chgnet_conv_banded.launches
    got = ck.chgnet_conv_banded(*ext, band)
    assert ck.chgnet_conv_banded.launches == before + 1
    _assert_close([got], [ck.chgnet_conv_banded_plain(*ext, band)])
    _assert_close([got], [ck.chgnet_conv(*args)])


@pytest.mark.parametrize("want_weights", [True, False])
def test_chgnet_conv_bwd_kernel_matches_plain(cuda_device, want_weights):
    """All eleven cotangents (or the four input ones) against the plain
    version, with masked edges, dead centres and a partial tile; a second
    launch repeats the first bitwise (no float atomics)."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    args, rn = _conv_inputs(cuda_device, seed=9)
    gagg = rn(*args[0].shape[:2], ck.KERNEL_F)
    rev = reverse_table(args[5], args[4] != 0, args[0].shape[1])
    before = ck.chgnet_conv_bwd.launches, ck.chgnet_conv_bwd.weight_launches
    got = ck.chgnet_conv_bwd(*args, gagg, rev=rev, want_weights=want_weights)
    assert (ck.chgnet_conv_bwd.launches, ck.chgnet_conv_bwd.weight_launches) == (
        before[0] + 1, before[1] + int(want_weights))
    ref = ck.chgnet_conv_bwd_plain(*args, gagg, want_weights=want_weights)
    n = 11 if want_weights else 4
    assert all(x is None for x in got[n:])
    _assert_close(got[:n], ref[:n])
    again = ck.chgnet_conv_bwd(*args, gagg, rev=rev, want_weights=want_weights)
    for a, b in zip(got[:n], again[:n]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="reverse table"):
        ck.chgnet_conv_bwd(*args, gagg)


def test_chgnet_conv_bwd_reverse_table_may_list_masked_edges(cuda_device):
    """A reverse table that also lists masked edges, among them the edges
    of the dead centres, gives the same g_aj2: the neighbour pass skips
    every masked edge, whose dpre is never written (the device memory the
    kernel reuses holds NaN here)."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    args, rn = _conv_inputs(cuda_device, seed=13)
    C, n_pad, F2 = args[0].shape
    gagg = rn(C, n_pad, ck.KERNEL_F)
    rev_all = reverse_table(args[5], torch.ones_like(args[4], dtype=torch.bool), n_pad)
    assert int((rev_all >= 0).sum()) > int((args[4] != 0).sum())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    poison = torch.full((16 << 20,), float("nan"), device=cuda_device)
    del poison   # the caching allocator carves the kernel's dpre from this block
    got = ck.chgnet_conv_bwd(*args, gagg, rev=rev_all)
    ref = ck.chgnet_conv_bwd_plain(*args, gagg, want_weights=False)
    _assert_close(got[:4], ref[:4])


# Shapes of the live-edge cases: M not a multiple of the 16-edge tile; a
# centre whose live edges span 8 tiles (M at the 128-slot instantiation's
# limit, more tiles than a block has warps); a work list of 4,800 (chain,
# centre) items, many for every block of the grid; M = 160 and 256, the
# 256-slot instantiation (up to 16 tiles a centre).
CONV_SHAPES = [(3, 36, 40), (2, 20, 128), (16, 300, 24), (2, 20, 160), (2, 12, 256)]


def _masked_nan_case(dev, C, n_pad, M, seed):
    """Conv inputs with scattered live slots (not a prefix), every fifth
    centre all dead and centre 1 all live; and a copy whose masked edges
    carry NaN in be and bw. The kernels never load a masked edge's be or
    bw, so on the NaN copy they must give the plain version's result on the
    clean one."""
    args, rn = _conv_inputs(dev, C=C, n_pad=n_pad, M=M, seed=seed, dead_rows=0)
    args = list(args)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    maskf = (torch.rand((C, n_pad, M), generator=g, device=dev) > 0.6).float()
    maskf[:, ::5] = 0.0
    maskf[:, 1] = 1.0
    args[4] = maskf.reshape(C, -1).contiguous()
    args[5] = torch.where(args[4] > 0, args[5], 0).to(torch.int32).contiguous()
    dirty = list(args)
    dead = (args[4] == 0)[..., None]
    for k in (2, 3):
        dirty[k] = torch.where(dead, float("nan"), args[k]).contiguous()
    return args, dirty, rn


@pytest.mark.parametrize("C,n_pad,M", CONV_SHAPES)
def test_chgnet_conv_kernel_never_loads_masked_edges(cuda_device, C, n_pad, M):
    """Row 10 on inputs whose masked edges hold NaN in be and bw equals the
    plain version on the clean inputs, and repeats bitwise."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    clean, dirty, _ = _masked_nan_case(cuda_device, C, n_pad, M, seed=17)
    got = ck.chgnet_conv(*dirty)
    _assert_close([got], [ck.chgnet_conv_plain(*clean)])
    assert torch.equal(got, ck.chgnet_conv(*dirty))


@pytest.mark.parametrize("want_weights", [False, True])
@pytest.mark.parametrize("C,n_pad,M", CONV_SHAPES)
def test_chgnet_conv_bwd_kernel_never_loads_masked_edges(cuda_device, C, n_pad, M,
                                                         want_weights):
    """Row 12 on the NaN copy against the plain version on the clean
    inputs: every cotangent within tolerance, g_be and g_bw exactly 0 at
    masked slots, a bitwise repeat."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    clean, dirty, rn = _masked_nan_case(cuda_device, C, n_pad, M, seed=19)
    gagg = rn(C, n_pad, ck.KERNEL_F)
    rev = reverse_table(clean[5], clean[4] != 0, n_pad)
    got = ck.chgnet_conv_bwd(*dirty, gagg, rev=rev, want_weights=want_weights)
    ref = ck.chgnet_conv_bwd_plain(*clean, gagg, want_weights=want_weights)
    n = 11 if want_weights else 4
    _assert_close(got[:n], ref[:n])
    masked = clean[4] == 0
    assert bool((got[2][masked] == 0).all()) and bool((got[3][masked] == 0).all())
    again = ck.chgnet_conv_bwd(*dirty, gagg, rev=rev, want_weights=want_weights)
    for a, b in zip(got[:n], again[:n]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("want_weights", [False, True])
def test_chgnet_conv_instantiations_agree_bitwise(cuda_device, want_weights):
    """The same live edges at M = 96 (the 128-slot instantiation) and padded
    with 64 masked slots to M = 160 (the 256-slot one): rows 10 and 12 give
    the same bits (a centre's sums run over its live edges in tile order),
    g_be / g_bw exactly 0 at the padding; the five weight cotangents summed
    over chunks of edge slots (whose bounds move with M) within tolerance."""
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck

    C, n_pad, M, pad = 3, 36, 96, 64
    args, rn = _conv_inputs(cuda_device, C=C, n_pad=n_pad, M=M, seed=23)

    def widen(t):
        t = t.reshape(C, n_pad, M, *t.shape[2:])
        z = torch.zeros((C, n_pad, pad, *t.shape[3:]), dtype=t.dtype, device=t.device)
        return torch.cat([t, z], dim=2).reshape(C, n_pad * (M + pad), *t.shape[3:]).contiguous()

    wide = list(args)
    for k in (2, 3, 4, 5):
        wide[k] = widen(args[k])
    assert torch.equal(ck.chgnet_conv(*args), ck.chgnet_conv(*wide))
    gagg = rn(C, n_pad, ck.KERNEL_F)
    got = ck.chgnet_conv_bwd(*args, gagg, rev=reverse_table(args[5], args[4] != 0, n_pad),
                             want_weights=want_weights)
    got_w = ck.chgnet_conv_bwd(*wide, gagg, rev=reverse_table(wide[5], wide[4] != 0, n_pad),
                               want_weights=want_weights)
    n = 11 if want_weights else 4
    for k in range(n):
        a, b = got[k], got_w[k]
        if k in (2, 3):   # g_be, g_bw: per edge slot
            b = b.reshape(C, n_pad, M + pad, -1)
            assert bool((b[:, :, M:] == 0).all())
            b = b[:, :, :M].reshape(a.shape)
        if 4 <= k <= 8:
            _assert_close([b], [a])
        else:
            assert torch.equal(a, b), ck.GRAD_NAMES[k]


def test_lamno3_energy_and_forces_on_card_match_cpu(cuda_device):
    """lamno3_001_chgnet through rows 10 and 12: the pristine anchor and a
    state with one OH, energies and forces card vs CPU within 1e-3 eV and
    1e-3 eV/A, four forward and four backward launches per force call."""
    from surface_sampling_tpu_torch.core import state as st
    from surface_sampling_tpu_torch.ops import chgnet_kernels as ck
    from surface_sampling_tpu_torch.systems import lamno3_001_chgnet

    out = []
    for dev in (cuda_device, torch.device("cpu")):
        sys_ = lamno3_001_chgnet(device=dev)
        d = sys_.run.d
        ss = torch.zeros((2, sys_.spec.n_sites), dtype=torch.int64, device=dev)
        ss[1, 3] = 2
        ck.reset_launch_counts()
        out.append(sys_.potential.energy_and_forces(
            st.realize_positions(d, ss), st.realize_type_idx(d, ss), st.realize_alive(d, ss)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = ck.launch_counts()
            assert counts["chgnet_conv"] == 4 and counts["chgnet_conv_bwd"] == 4
            assert counts["chgnet_conv_bwd.weights"] == 0
    (e_gpu, f_gpu), (e_cpu, f_cpu) = out
    assert abs(float(e_gpu[0]) + 405.206) < 1e-3
    assert float((e_gpu.cpu() - e_cpu).abs().max()) <= 1e-3
    assert float((f_gpu.cpu() - f_cpu).abs().max()) <= 1e-3


# ----------------------------------------------------------------------
# EAM pair pass (row 13) and the canonical engine
# ----------------------------------------------------------------------
def _eam_case(dev, system: str, n_chains: int, seed: int):
    """The kernel potential of Cu(100) or Au(110) on ``dev`` and the slot
    geometry of seeded occupancies (a site filled with probability 0.3:
    physical states and some overlapping pairs)."""
    import numpy as np

    from surface_sampling_tpu_torch.core import state as st
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
    from surface_sampling_tpu_torch.potentials.eam import builtin_eam
    from surface_sampling_tpu_torch.systems import au110_eam, cu100_eam

    sys_ = cu100_eam(device=dev) if system == "cu" else au110_eam(device=dev)
    tables = builtin_eam("Cu_u3" if system == "cu" else "Au_u3")
    nbr = build_static_neighbor_table(sys_.spec, tables.cutoff, relax_slack=0.05)
    pot = make_eam_kernel_potential(tables, nbr, device=dev)
    rng = np.random.default_rng(seed)
    ss = torch.as_tensor((rng.random((n_chains, sys_.spec.n_sites)) < 0.3).astype(np.int64),
                         device=dev)
    d = sys_.run.d
    return pot, st.realize_positions(d, ss), st.realize_type_idx(d, ss), st.realize_alive(d, ss)


@pytest.mark.parametrize("system,n_chains", [("cu", 37), ("au", 70), ("cu", 4099)])
def test_eam_kernel_matches_plain(cuda_device, system, n_chains):
    """Row 13 against its plain version (chain counts that are not a
    multiple of the kernel's 16-chain block; 4,099 spans 257 blocks), one
    launch a call, bitwise on repeat."""
    from surface_sampling_tpu_torch.ops import eam_kernels as ek

    pot, pos, _, alive = _eam_case(cuda_device, system, n_chains, seed=n_chains)
    args = (pos.contiguous(), alive.float(), pot.pairs, pot.cheb)
    before = ek.eam_rho_ep.launches
    got = ek.eam_rho_ep(*args)
    assert ek.eam_rho_ep.launches == before + 1
    _assert_close(got, ek.eam_rho_ep_plain(*args))
    for a, b in zip(got, ek.eam_rho_ep(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("system", ["cu", "au"])
def test_eam_kernel_never_reads_dead_pairs(cuda_device, system):
    """NaN in the shift of every padding pair (kernel_j == -1) and in the
    positions of every dead slot changes no bit of rho and ep: the kernel
    tests j >= 0 and aliveness before it reads a shift or a position."""
    from surface_sampling_tpu_torch.ops import eam_kernels as ek

    pot, pos, _, alive = _eam_case(cuda_device, system, 70, seed=3)
    pos, alive_f, pairs = pos.contiguous(), alive.float(), pot.pairs
    assert bool((pairs.kernel_j < 0).any()) and bool((alive_f == 0).any())
    got = ek.eam_rho_ep(pos, alive_f, pairs, pot.cheb)
    nan = float("nan")
    dirty_pairs = pairs._replace(
        shift=torch.where((pairs.kernel_j < 0)[..., None], nan, pairs.shift).contiguous())
    dirty_pos = torch.where((alive_f == 0)[..., None], nan, pos).contiguous()
    for a, b in zip(got, ek.eam_rho_ep(dirty_pos, alive_f, dirty_pairs, pot.cheb)):
        assert torch.equal(a, b)


def test_eam_kernel_potential_on_card_matches_cpu(cuda_device):
    """The kernel potential's energies on the card against the CPU plain
    path within 1e-3 eV where |E| < 999 eV (tests/test_pallas_eam.py's rule
    for the kernel against the cheb path: the card's Clenshaw contracts to
    FMAs), and its refusal of gradients on the card."""
    pot_g, pos_g, ti_g, al_g = _eam_case(cuda_device, "cu", 64, seed=5)
    pot_c, pos_c, ti_c, al_c = _eam_case(torch.device("cpu"), "cu", 64, seed=5)
    e_g, e_c = pot_g.energy(pos_g, ti_g, al_g).cpu(), pot_c.energy(pos_c, ti_c, al_c)
    phys = e_c.abs() < 999.0
    assert int(phys.sum()) > 0
    assert float((e_g - e_c).abs()[phys].max()) <= 1e-3
    with pytest.raises(NotImplementedError, match="energy only"):
        pot_g.energy(pos_g.requires_grad_(True), ti_g, al_g)


def test_canonical_run_repeats_and_continues_bitwise_on_card(cuda_device):
    """au110_eam's canonical run on the card: the same seed twice gives the
    same records, and a run cut into two chunks that pass one generator
    along equals one run."""
    from surface_sampling_tpu_torch.core.engine import (
        EngineConfig,
        geometric_schedule,
        make_generator,
        make_run_fn,
    )
    from surface_sampling_tpu_torch.systems import au110_eam

    sys_ = au110_eam(fast=True, device=cuda_device)
    cfg = EngineConfig(sweep_size=8, canonical=True, num_ads_atoms=6)
    temps = geometric_schedule(1.0, 6, 0.8)
    a, rec_a = sys_.run.run(0, temps, cfg=cfg, n_chains=64)
    b, rec_b = sys_.run.run(0, temps, cfg=cfg, n_chains=64)
    assert torch.equal(rec_a.energy, rec_b.energy) and torch.equal(a.site_state, b.site_state)
    assert bool((rec_a.n_ads == 6).all())
    run = make_run_fn(sys_.run.d, sys_.run.state_energy_fn, cfg)
    whole, rec = run(a, temps, make_generator(3, cuda_device))
    gen = make_generator(3, cuda_device)
    half, rec_1 = run(a, temps[:2], gen)
    end, rec_2 = run(half, temps[2:], gen)
    assert torch.equal(rec.site_state, torch.cat([rec_1.site_state, rec_2.site_state], dim=1))
    assert torch.equal(whole.energy, end.energy)


def _assert_bwd2_close(got, ref, envm, cenvm):
    """Row 5 against its plain version under the dead-slot contract: every
    output within RTOL x max|plain|, except d_envm (index 3), which is
    compared on the slots with envm != 0 or c_envm != 0 and must be exactly
    0 on the others (the plain version's value there reaches only the
    positions; ROADMAP Queue 3)."""
    _assert_bwd_close(got, ref, (envm != 0) | (cenvm != 0))


def _bwd2_args(x, R):
    """Second-order backward inputs on the card: the backward's inputs of
    ``_bwd_args`` and random cotangents of its outputs, c_envm zero on the
    masked edges as training makes it."""
    rn, C, K, n_pad, F = x["rn"], x["C"], x["K"], x["n_pad"], x["F"]
    M = x["unit"].shape[-1]
    args = _bwd_args(x, R)
    cots = (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), rn(C, n_pad * M, R),
            rn(C, n_pad * M) * (args[3] != 0), rn(C, 3, n_pad, M))
    return args, cots


@pytest.mark.parametrize("R,with_cdw", [(8, False), (24, False), (24, True)])
def test_message_bwd2_kernel_matches_plain(cuda_device, R, with_cdw):
    """All nine outputs of the second-order kernel against its plain
    version under the dead-slot contract, with and without c_dw / c_db (the
    training case skips their terms, and explicit zeros take the same
    path); a second launch repeats the first bitwise."""
    from surface_sampling_tpu_torch.ops.neighbors import reverse_table

    x = _inputs(cuda_device, R=R, seed=8)
    args, cots = _bwd2_args(x, R)
    rn, K, F = x["rn"], x["K"], x["F"]
    rev = reverse_table(args[4], args[3] != 0, x["n_pad"])
    cdw, cdb = (rn(K, R, 3 * F), rn(K, 3 * F)) if with_cdw else (None, None)
    before = pk.painn_message_bwd2.launches, pk.painn_message_bwd2.cdw_launches
    got = pk.painn_message_bwd2(*args, *cots, cdw, cdb, rev=rev)
    assert (pk.painn_message_bwd2.launches, pk.painn_message_bwd2.cdw_launches) == (
        before[0] + 1, before[1] + int(with_cdw))
    _assert_bwd2_close(got, pk.painn_message_bwd2_plain(*args, *cots, cdw, cdb), args[3],
                       cots[3])
    again = pk.painn_message_bwd2(*args, *cots, cdw, cdb, rev=rev)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if not with_cdw:
        dev = x["rbf"].device
        zeros = pk.painn_message_bwd2(*args, *cots, torch.zeros((K, R, 3 * F), device=dev),
                                      torch.zeros((K, 3 * F), device=dev), rev=rev)
        for a, b in zip(got, zeros):
            assert torch.equal(a, b)


def test_message_bwd2_reverse_table_contract(cuda_device):
    """A reverse table that leaves the masked edges out is exact only when
    c_envm is zero there too: with random c_envm on masked edges the kernel
    and the plain version differ; with a table that lists every edge, masked
    ones included, they agree; with c_envm zeroed, the short table agrees."""
    from surface_sampling_tpu_torch.ops.neighbors import reverse_table

    x = _inputs(cuda_device, R=24, seed=9)
    args, cots = _bwd2_args(x, 24)
    mask = args[3] != 0
    n_pad = x["n_pad"]
    bad = list(cots)
    bad[3] = cots[3] + x["rn"](*mask.shape) * ~mask
    short = reverse_table(args[4], mask, n_pad)
    full = reverse_table(args[4], torch.ones_like(mask), n_pad)
    ref = pk.painn_message_bwd2_plain(*args, *bad)
    got = pk.painn_message_bwd2(*args, *bad, rev=short)
    torch.cuda.synchronize()
    assert float((got[0] - ref[0]).abs().max()) > RTOL * float(ref[0].abs().max())
    _assert_bwd2_close(pk.painn_message_bwd2(*args, *bad, rev=full), ref, args[3], bad[3])
    _assert_bwd2_close(pk.painn_message_bwd2(*args, *cots, rev=short),
                       pk.painn_message_bwd2_plain(*args, *cots), args[3], cots[3])


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("with_cdw", [False, True])
def test_message_bwd2_across_tiles_and_blind_to_dead_slots(cuda_device, K, with_cdw):
    """Row 5 on live slots that cross its tiles (a centre with all 64 slots
    live, one with none, a tile ending inside a centre and at the chain's
    end, a row read by many edges) against its plain version under the
    dead-slot contract; then NaN in the rbf, c_rbf, unit and c_unit of
    every dead slot (envm == 0 and c_envm == 0) changes no bit of the
    nine outputs."""
    dev, C, n_pad, M, R, F = cuda_device, 2, 16, 64, 24, 128
    args = _bwd_tile_case(dev, K, n_pad, M, R, F, seed=11)
    g = torch.Generator(device=dev).manual_seed(12)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    cots = (rn(C, K, n_pad, 3 * F), rn(C, K, n_pad, 3 * F), rn(C, n_pad * M, R),
            rn(C, n_pad * M) * (args[3] != 0), rn(C, 3, n_pad, M))
    cw = (rn(K, R, 3 * F), rn(K, 3 * F)) if with_cdw else (None, None)
    got = pk.painn_message_bwd2(*args, *cots, *cw)
    _assert_bwd2_close(got, pk.painn_message_bwd2_plain(*args, *cots, *cw), args[3], cots[3])
    dead = (args[3] == 0) & (cots[3] == 0)
    assert bool(dead.any())
    nan = float("nan")
    edge, slot = dead[..., None], dead.reshape(C, 1, n_pad, M)
    dirty = list(args)
    dirty[2], dirty[5] = torch.where(edge, nan, args[2]), torch.where(slot, nan, args[5])
    dirty_cots = list(cots)
    dirty_cots[2] = torch.where(edge, nan, cots[2])
    dirty_cots[4] = torch.where(slot, nan, cots[4])
    out = pk.painn_message_bwd2(*dirty, *dirty_cots, *cw)
    assert all(torch.equal(a, b) for a, b in zip(got, out))


def test_training_step_on_card_repeats_and_matches_cpu(cuda_device):
    """One full-width force-loss step (srtio3_painn_01.npz, two jittered
    frames of the SrTiO3(001) 2x2 slab): the loss and every parameter
    gradient repeat bitwise on the card, run the second-order kernel once
    per layer, and agree with the CPU plain path (loss relative 1e-5, each
    leaf within 1e-3 x max|cpu| of that leaf)."""
    import numpy as np

    from surface_sampling_tpu_torch.models import train as tr
    from surface_sampling_tpu_torch.models.painn import tree_leaves
    from surface_sampling_tpu_torch.models.weights import load_painn_ensemble
    from surface_sampling_tpu_torch.structure.atoms import Structure
    from surface_sampling_tpu_torch.systems import MODEL_DATA, SYSTEMS_DATA

    data = np.load(SYSTEMS_DATA / "SrTiO3_001_2x2.npz")
    rng = np.random.default_rng(0)
    frames = [Structure(data["numbers"], data["positions"]
                        + rng.normal(0, 0.03, data["positions"].shape), data["cell"])
              for _ in range(2)]
    batch = tr.pad_structures(frames, [-10780.0, -10781.0],
                              [rng.normal(0, 1.0, (60, 3)) for _ in frames], 5.0)
    out = {}
    for dev in (cuda_device, cuda_device, torch.device("cpu")):
        params, cfg = load_painn_ensemble([MODEL_DATA / "srtio3_painn_01.npz"], dev)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        pk.reset_launch_counts()
        loss = tr.make_loss_fn(cfg, tr.TrainConfig())(params, tr.batch_to_device(batch, dev))
        grads = torch.autograd.grad(loss.sum(), leaves)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert pk.painn_message_bwd2.launches == 3
            assert pk.painn_message_bwd2.cdw_launches == 0
        out.setdefault(dev.type, []).append((loss.detach().cpu(), [g.cpu() for g in grads]))
    (l1, g1), (l2, g2) = out["cuda"]
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    lc, gc = out["cpu"][0]
    assert abs(float(l1) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(g1, gc):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
