"""The spans and the counter of the port's MC step (utils/tracing.py):
off and free without a profiler, nested under ``mc.step`` with one, and
without effect on any number.

The delta system is the banded toy line of tests/test_torch_incremental.py
(42 slots, blocks of 16, two layers, two members), built here from the
port alone with random weights.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from surface_sampling_tpu_torch.core.energy import make_state_energy_fn
from surface_sampling_tpu_torch.core.engine import EngineConfig, make_generator, make_run_fn
from surface_sampling_tpu_torch.core.incremental import (
    make_incremental_painn,
    make_incremental_run,
    make_incremental_semigrand_step,
)
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import device_spec
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.chgnet import (
    CHGNetConfig,
    chgnet_apply_structures,
    init_chgnet,
)
from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, init_ensemble
from surface_sampling_tpu_torch.ops.banding import build_routing_band_for_spec
from surface_sampling_tpu_torch.parallel.chains import chain_states, incremental_chain_states
from surface_sampling_tpu_torch.structure import Structure
from surface_sampling_tpu_torch.utils import tracing
from surface_sampling_tpu_torch.utils.tracing import count, counters, reset_counters, span

TYPES = [22, 8, 38]
CFG = dict(feat_dim=16, n_rbf=6, cutoff=4.0, n_layers=2, readout_hidden=8, max_neighbors=10,
           excl_vol=True, sigma=1.2, power=8.0)
CHAINS, SWEEP = 3, 4
TEMPS = np.array([0.01])
# wider than the toy's 2 A site spacing, so that the filter has pairs to test
FILTER = 2.5
IN_STEP = ("mc.energy", "mc.filter", "delta.gather", "delta.cache_write")


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(5)
    xs = np.arange(21) * 2.0 + 0.3
    pos = np.stack([xs, np.full(21, 2.0), np.full(21, 5.0)], axis=1)
    pos[:, 1] += rng.uniform(-0.3, 0.3, 21)
    slab = Structure.from_symbols(["Ti"] * 21, pos, np.diag([42.0, 4.2, 16.0]))
    spec = make_spec(slab, pos + np.array([0.7, 0.0, 1.9]), ["O", "Sr"],
                     potential_numbers=TYPES, cutoff=4.0, surface_name="toy_band")
    cfg = PaiNNConfig(**CFG)
    nbr = build_static_neighbor_table(spec, cfg.cutoff, relax_slack=0.1)
    band = build_routing_band_for_spec(spec, nbr)
    params = init_ensemble(torch.Generator().manual_seed(0), cfg, 2)
    d = device_spec(spec, torch.device("cpu"))
    pot = make_painn_potential(params, cfg, TYPES, units="kcal/mol", static_nbr=nbr, spec=spec,
                               device="cpu", routing_band=band)
    eng = make_incremental_painn(spec, d, pot, nbr, band)
    return spec, d, pot, eng


def _delta_run(toy, temps=TEMPS, seed=3):
    spec, d, _, eng = toy
    step = make_incremental_semigrand_step(eng, d, criterion="metropolis_distance",
                                           filter_distance=FILTER)
    run = make_incremental_run(step, SWEEP, spec.n_sites, spec.n_codes)
    return run(incremental_chain_states(eng, d, CHAINS), temps, make_generator(seed, "cpu"))


def _rigid_run(toy):
    spec, d, pot, _ = toy
    sef = make_state_energy_fn(d, pot)
    run = make_run_fn(d, sef, EngineConfig(sweep_size=SWEEP, criterion="metropolis_distance",
                                           filter_distance=FILTER, record_positions=False))
    st = chain_states(d, CHAINS)
    st = st._replace(energy=sef(st.site_state).surface_energy)
    return run(st, TEMPS, make_generator(3, "cpu"))


def _profiled(fn):
    reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [ev for ev in prof.events() if ev.device_type == DeviceType.CPU]


def _inside_step(ev) -> bool:
    p = ev.cpu_parent
    while p is not None and p.name != "mc.step":
        p = p.cpu_parent
    return p is not None


def test_without_a_profiler_spans_are_one_shared_noop_and_nothing_is_counted(toy):
    reset_counters()
    assert not torch.autograd._profiler_enabled()
    assert span("mc.step") is span("delta.gather") is tracing._OFF
    with span("mc.step"):
        count("delta.blocks", 1)
    _delta_run(toy)
    assert counters() == {}


@pytest.mark.parametrize("engine", ["delta", "rigid"])
def test_spans_nest_under_each_step(toy, engine):
    events = _profiled(lambda: _delta_run(toy) if engine == "delta" else _rigid_run(toy))
    names = [ev.name for ev in events]
    assert names.count("mc.step") == SWEEP
    want = IN_STEP if engine == "delta" else IN_STEP[:2]
    for name in want:
        found = [ev for ev in events if ev.name == name]
        assert found and all(_inside_step(ev) for ev in found), name
    assert names.count("mc.energy") == names.count("mc.filter") == SWEEP
    blocks = counters().get("delta.blocks", [])
    if engine == "rigid":
        assert blocks == [] and "delta.gather" not in names
        return
    # one (C, NB) list per layer per step, layers in turn
    L = CFG["n_layers"]
    assert len(blocks) == L * SWEEP
    nb = [b.shape[1] for b in blocks[:L]]
    assert all(b.shape == (CHAINS, nb[i % L]) and b.dtype == torch.int64
               for i, b in enumerate(blocks))
    reset_counters()
    assert counters() == {}


def test_counters_hold_the_last_profiled_stretch_only():
    reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        count("delta.blocks", 1)
        count("delta.blocks", 2)
    count("delta.blocks", 3)             # no profiler: keeps nothing and drops nothing
    assert counters() == {"delta.blocks": [1, 2]}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        count("delta.blocks", 4)
    assert counters() == {"delta.blocks": [4]}
    reset_counters()


def test_numbers_are_bitwise_the_same_with_the_profiler_on_and_off(toy):
    temps = np.array([0.02, 0.01])
    off_state, off_rec = _delta_run(toy, temps, seed=11)
    reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on_state, on_rec = _delta_run(toy, temps, seed=11)
    reset_counters()
    assert 0.0 < float(on_rec.accept_rate.mean()) < 1.0
    assert torch.equal(on_state.site_state, off_state.site_state)
    assert torch.equal(on_state.energy, off_state.energy)
    assert torch.equal(on_rec.energy, off_rec.energy)
    on_c, off_c = on_state.caches, off_state.caches
    for field in ("s", "phi", "vcat"):
        for a, b in zip(getattr(on_c, field), getattr(off_c, field), strict=True):
            assert torch.equal(a, b), field
    assert torch.equal(on_c.e_atom, off_c.e_atom)


def test_chgnet_stages_are_spans_under_the_profiler_only():
    """The stage spans of a CHGNet forward: one bases and readout and an
    atom conv per layer, and no bond/angle update, which no output reads;
    the same energies without them."""
    cfg = CHGNetConfig(atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=7,
                       num_angular=7, n_conv=3, max_neighbors=16, max_bond_neighbors=8,
                       mlp_hidden_dims=(16, 16, 16))
    gen = torch.Generator().manual_seed(1)
    params = init_chgnet(gen, cfg)
    pos = 6.0 * torch.rand((2, 8, 3), generator=gen)
    numbers = torch.tensor([[8, 25] * 4, [8, 8, 25, 1] * 2])
    alive, shifts = numbers > 0, torch.zeros((2, 1, 3))
    off = chgnet_apply_structures(params, cfg, pos, numbers, alive, shifts)["energy"]
    events = _profiled(lambda: chgnet_apply_structures(params, cfg, pos, numbers, alive,
                                                       shifts)["energy"])
    names = [ev.name for ev in events]
    assert [names.count(f"chgnet.{s}") for s in ("bases", "atom_conv", "bond_angle", "readout")] \
        == [1, cfg.n_conv, 0, 1]
    assert torch.equal(chgnet_apply_structures(params, cfg, pos, numbers, alive, shifts)["energy"],
                       off)
