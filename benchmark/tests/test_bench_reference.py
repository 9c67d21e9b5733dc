"""The plain reference agrees with the port's CPU path (its plain PyTorch
versions of every kernel) on 1x1 states of each configuration: rigid,
out of bounds and FIRE-relaxed. Energies are float32 sums of a few hundred
terms of up to ~500 eV in another order: 5e-4 eV is ~1e-6 of them."""

import numpy as np
import pytest
import torch

from benchmark.check import energy_function, make_reference
from benchmark.harness import BENCH, load_workload
from benchmark.reference.common import load_lattice
from surface_sampling_tpu_torch import systems
from surface_sampling_tpu_torch.core.energy import RelaxConfig

TOL_EV = 5e-4


def _states(n_sites: int, n_codes: int, seed: int, share: float) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    ss = rng.integers(1, n_codes, (4, n_sites))
    ss = np.where(rng.random(ss.shape) < share, ss, 0)
    ss[0] = 0
    return torch.as_tensor(ss)


@pytest.mark.parametrize("cell,builder", [("srtio3_1x1_filtered", systems.srtio3_001_painn),
                                          ("lamno3_1x1_rigid", systems.lamno3_001_chgnet)])
def test_rigid_energies(cell, builder):
    wl = load_workload(cell)
    system = builder(device="cpu")
    ss = torch.cat([_states(system.spec.n_sites, system.spec.n_codes, 0, 0.05),
                    _states(system.spec.n_sites, system.spec.n_codes, 1, 0.6)])
    prog = system.run.state_energy_fn(ss).surface_energy.double()
    model, coeff = make_reference(wl["config_file"], "cpu")
    ref = energy_function(model, coeff, load_lattice(BENCH / wl["lattice"], "cpu"), 4)(ss)
    assert torch.isfinite(ref).all()
    assert (prog - ref).abs().max() <= TOL_EV * max(1.0, float(ref.abs().max()) / 500)


def test_relaxed_energies_and_positions():
    wl = load_workload("srtio3_1x1_relaxed")
    relax = dict(wl["relax"], steps=5)
    system = systems.srtio3_001_painn(relax=RelaxConfig(steps=5), device="cpu")
    ss = torch.zeros((2, system.spec.n_sites), dtype=torch.int64)
    ss[1, [4, 53]] = torch.tensor([1, 3])
    out = system.run.state_energy_fn(ss)
    model, coeff = make_reference(wl["config_file"], "cpu")
    lat = load_lattice(BENCH / wl["lattice"], "cpu")
    at_positions = energy_function(model, coeff, lat, 2)(ss, out.positions)
    relaxed = energy_function(model, coeff, lat, 2, relax=relax)(ss)
    assert (out.surface_energy.double() - at_positions).abs().max() <= TOL_EV
    assert (out.surface_energy.double() - relaxed).abs().max() <= TOL_EV
