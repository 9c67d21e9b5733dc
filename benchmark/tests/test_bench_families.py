"""A model family enters the benchmark as files of its own: the reference
(``reference/<model>.py``) and the work count (``work/<model>.py``) are
found by the configuration's ``model`` alone, and a cell may take its
system from a campaign settings file on any engine."""

import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.check import make_reference
from benchmark.harness import TraceSummary
from benchmark.work import kernels as wk
from benchmark.work.readers import mfu

COUNTS = [wk.StateCounts(4, 124, 300, 9000, 700), wk.StateCounts(4, 124, 320, 9800, 760)]
WINDOW_S = 0.5


class ToyModel:
    def potential_energy(self, numbers, positions, cell, pbc, prec):
        return -(numbers > 0).sum(dim=1).float()


def _toy_family(monkeypatch):
    ref = types.ModuleType("benchmark.reference.toy")
    ref.make_model = lambda cfg, root, device: ToyModel()
    work = types.ModuleType("benchmark.work.toy")
    work.eval_flops = lambda c, cfg: cfg["flops_per_atom"] * c.alive
    monkeypatch.setitem(sys.modules, "benchmark.reference.toy", ref)
    monkeypatch.setitem(sys.modules, "benchmark.work.toy", work)


def _mfu_ctx(config):
    trace = TraceSummary([("k", 0.0, 1.0)], WINDOW_S, 2, 8, {}, [], {}, [])
    return {"config": config, "trace": trace, "_counts": COUNTS}


def test_a_family_from_modules_alone(monkeypatch):
    _toy_family(monkeypatch)
    cfg = {"model": "toy", "flops_per_atom": 1e9,
           "surface_energy": {"kind": "chem_pot", "chem_pots": {"O": -5.0}}}
    model, coeff = make_reference(cfg, "cpu")
    assert isinstance(model, ToyModel) and coeff == {8: -5.0}
    want = 100.0 * 1e9 * (300 + 320) / (WINDOW_S * wk.PEAK_TF32_FLOPS)
    assert mfu(_mfu_ctx(cfg)) == pytest.approx(want, rel=1e-12)


def test_an_unknown_family_names_the_file_to_add():
    cfg = {"model": "nosuch", "surface_energy": {"kind": "chem_pot", "chem_pots": {}}}
    with pytest.raises(ValueError, match="benchmark/reference/nosuch.py"):
        make_reference(cfg, "cpu")


def test_mfu_reads_nothing_without_a_work_module():
    assert mfu(_mfu_ctx({"model": "nosuch"})) is None


@pytest.mark.parametrize("cell", ["srtio3_1x1_filtered", "lamno3_1x1_rigid"])
def test_mfu_of_the_families_in_the_benchmark(cell):
    cfg = harness.load_workload(cell)["config_file"]
    if cfg["model"] == "painn":
        per = [wk.painn_eval_flops(c, cfg["n_members"], cfg["feat_dim"], cfg["n_rbf"],
                                   cfg["n_layers"], cfg["readout_hidden"]) for c in COUNTS]
    else:
        per = [wk.chgnet_eval_flops(c, cfg["atom_fea_dim"], cfg["n_conv"],
                                    cfg["mlp_hidden_dims"][0]) for c in COUNTS]
    want = 100.0 * sum(per) / (WINDOW_S * wk.PEAK_TF32_FLOPS)
    assert mfu(_mfu_ctx(cfg)) == pytest.approx(want, rel=1e-12)


def _rigid_from_settings(**changes) -> dict:
    """Campaign A's settings file on the rigid engine: 2 chains, a sweep of
    2 steps."""
    wl = harness.load_workload("srtio3_2x2_delta")
    wl.update(engine="rigid", chains=2, sweep_size=2, warmup_sweeps=0,
              check={"chains": 2, "chunk": 2})
    wl["system"] = dict(wl["system"], overrides={"n_chains": 2, "sweep_size": 2})
    wl.update(changes)
    return wl


def test_a_rigid_cell_from_a_settings_file():
    wl = _rigid_from_settings()
    result = harness.run_cell(wl, 11, 0.0, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] == 2 * 2 * result["sweeps"]


@pytest.mark.parametrize("changes", [
    {"chains": 3},
    {"schedule": {"start_temp": 1.0, "alpha": 0.99, "t_min": 0.0493}},
    {"engine": "relaxed", "relax": {"steps": 20, "fmax": 0.01, "max_step": 0.2}},
], ids=["chains", "schedule", "relaxation"])
def test_settings_that_disagree_with_the_cell_raise(changes):
    wl = _rigid_from_settings(**changes)
    with pytest.raises(RuntimeError, match="differ|relaxes"):
        harness.build_cell(wl, torch.device("cpu"))
