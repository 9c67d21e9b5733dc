"""The check sees a broken timed path: each cell's run on the CPU (the
harness without its look for a card, at a size a test can hold), sound and
with each fault an MC cell can have planted under the engine's step:

* the step returns its state unchanged;
* half of the batch (the second half of the chains) is left out;
* an answer is altered where it is produced (the step's energies, 0.05 eV).

A cell on one card has no exchange between chips to leave out. The
reference replay depends only on the draws and the reference, so a sound
run whose replay accepts moves makes every fault visible."""

import pytest
import torch

import surface_sampling_tpu_torch.core.events as events
import surface_sampling_tpu_torch.core.incremental as incremental
from benchmark import harness

SMALL = {
    "srtio3_1x1_filtered": dict(chains=8, sweep_size=4, seed=11),
    "lamno3_1x1_rigid": dict(chains=4, sweep_size=3, seed=11),
    "srtio3_2x2_delta": dict(chains=4, sweep_size=12, seed=15),
    "srtio3_1x1_relaxed": dict(chains=4, sweep_size=4, seed=11),
}


def small_cell(name: str) -> tuple[dict, int]:
    wl = harness.load_workload(name)
    size = SMALL[name]
    wl.update(chains=size["chains"], sweep_size=size["sweep_size"], warmup_sweeps=0)
    if "settings" in wl["system"]:
        wl["system"] = dict(wl["system"], overrides={"n_chains": size["chains"],
                                                     "sweep_size": size["sweep_size"]})
    wl["check"] = {"chains": size["chains"], "chunk": size["chains"]}
    if "relax" in wl:
        # three FIRE steps: a test-sized relaxation, whose gaps stay at the
        # rigid cells' float32 level (the cell's own limit awaits its fix)
        wl["relax"] = dict(wl["relax"], steps=3)
        wl["limits"] = dict(wl["limits"], relaxed_gap_ev=wl["limits"]["energy_gap_ev"])
    return wl, size["seed"]


def _keep_half(new, old, C):
    first = torch.arange(C, device=new.energy.device) < C // 2
    return type(new)(*(torch.where(first.view(-1, *[1] * (a.dim() - 1)), a, b)
                       if torch.is_tensor(a) else
                       incremental.select_caches(first, a, b) for a, b in zip(new, old)))


def plant(monkeypatch, fault: str) -> None:
    select, inc_step = events.select_trial, incremental._inc_step

    def broken_select(accept, trial_ss, trial, state):
        new, info = select(accept, trial_ss, trial, state)
        if fault == "unchanged":
            return state, info._replace(accepted=torch.zeros_like(info.accepted))
        if fault == "half":
            return _keep_half(new, state, state.energy.shape[0]), info
        return new._replace(energy=new.energy + 0.05), info

    def broken_inc(engine, dist_accept, state, *args, **kwargs):
        new, info = inc_step(engine, dist_accept, state, *args, **kwargs)
        if fault == "unchanged":
            return state, info._replace(accepted=torch.zeros_like(info.accepted))
        if fault == "half":
            return _keep_half(new, state, state.energy.shape[0]), info
        return new._replace(energy=new.energy + 0.05), info

    monkeypatch.setattr(events, "select_trial", broken_select)
    monkeypatch.setattr(incremental, "_inc_step", broken_inc)


@pytest.mark.parametrize("cell", list(SMALL))
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_check_sees_the_fault(monkeypatch, cell, fault):
    wl, seed = small_cell(cell)
    if fault is not None:
        plant(monkeypatch, fault)
    result = harness.run_cell(wl, seed, 0.0, False, "cpu")
    if fault is None:
        assert result["correct"], result["checks"]
        # the replay accepts moves in both halves, so each fault shows
        assert result["seen"]["replay_accepted"] >= 2
    else:
        assert not result["correct"], (fault, result["checks"], result["seen"])
