"""The multiple-try and distance-criterion steps on the card against the
same steps on the CPU plain path, fed the same draws.

Marked ``cuda``: each test takes the ``cuda_device`` fixture, which skips
with a reason when no CUDA device is visible. Run them on an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_cuda_engine.py

The card runs the PaiNN kernels (rows 1-3) where the CPU runs their plain
versions; the steps must take the same decisions and reach the same
occupancies, energies within 1e-3 eV (the port's card-vs-CPU limit).
"""

import numpy as np
import pytest
import torch

from surface_sampling_tpu_torch.core.engine import make_generator
from surface_sampling_tpu_torch.core.events import (
    canonical_draws,
    make_canonical_step,
    make_canonical_step_mtm,
    make_distance_accept,
    make_semigrand_step,
    make_semigrand_step_mtm,
    mtm_draws,
    semigrand_draws,
)
from surface_sampling_tpu_torch.parallel.chains import chain_states
from surface_sampling_tpu_torch.systems import srtio3_001_painn

pytestmark = pytest.mark.cuda
E_TOL = 1e-3
N_CHAINS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    from surface_sampling_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _pair(dev):
    """The flagship 1x1 on the card and on the CPU, and physical start
    states: three adsorbates a chain on sites at least 2.5 A apart (crowded
    random occupancies score 1e3-eV overlaps, where card and CPU sums differ
    by more than the limit)."""
    gpu, cpu = srtio3_001_painn(device=dev), srtio3_001_painn(device="cpu")
    rng = np.random.default_rng(0)
    S, xyz = cpu.spec.n_sites, cpu.spec.site_coords
    ss = np.zeros((N_CHAINS, S), np.int64)
    for c in range(N_CHAINS):
        picked = []
        for s in rng.permutation(S):
            if all(np.linalg.norm(xyz[s] - xyz[p]) >= 2.5 for p in picked):
                picked.append(s)
            if len(picked) == 3:
                break
        ss[c, picked] = rng.integers(1, cpu.spec.n_codes, len(picked))
    states = []
    for sys_ in (gpu, cpu):
        st = chain_states(sys_.run.d, N_CHAINS, ss)
        states.append(st._replace(energy=sys_.run.state_energy_fn(st.site_state).surface_energy))
    return gpu, cpu, states


def _to(draws, dev):
    if isinstance(draws, torch.Tensor):
        return draws.to(dev)
    return tuple(_to(x, dev) for x in draws)


def _replay(dev, make, draw_fn, n_steps=3, temp=1.0):
    gpu, cpu, (sg, sc) = _pair(dev)
    steps = [make(sys_) for sys_ in (gpu, cpu)]
    gen = make_generator(0, "cpu")
    d = cpu.run.d
    accepted = []
    for _ in range(n_steps):
        dr = draw_fn(gen, N_CHAINS, d.site_coords.shape[0], d.n_codes)
        sg, ig = steps[0](sg, temp, *_to(dr, dev))
        sc, ic = steps[1](sc, temp, *dr)
        assert torch.equal(ig.accepted.cpu(), ic.accepted)
        assert torch.equal(sg.site_state.cpu(), sc.site_state)
        assert float((sg.energy.cpu() - sc.energy).abs().max()) <= E_TOL
        accepted.append(ic.accepted)
    return torch.stack(accepted), sc, cpu


@pytest.mark.parametrize("canonical", [False, True])
def test_mtm_step_card_matches_cpu(cuda_device, canonical):
    """K = 4 trials: the card's batched evaluations (rows 1-3 at 4 and 3
    chains' worth of states a chain) give the CPU's decisions."""
    make = make_canonical_step_mtm if canonical else make_semigrand_step_mtm
    acc, _, _ = _replay(cuda_device, lambda s: make(s.run.d, s.run.state_energy_fn, 4),
                        mtm_draws(4, canonical=canonical))
    assert acc.any()


@pytest.mark.parametrize("canonical", [False, True])
def test_metropolis_distance_step_card_matches_cpu(cuda_device, canonical):
    """The distance filter's hard wall on the card and on the CPU: the same
    decisions, and no accepted state closer than the filter."""
    make = make_canonical_step if canonical else make_semigrand_step
    acc, states, cpu = _replay(
        cuda_device, lambda s: make(s.run.d, s.run.state_energy_fn,
                                    criterion="metropolis_distance", filter_distance=1.5),
        canonical_draws if canonical else semigrand_draws)
    ok = make_distance_accept(cpu.run.d, 1.5)(states.site_state)
    assert ok[acc.any(0)].all()
