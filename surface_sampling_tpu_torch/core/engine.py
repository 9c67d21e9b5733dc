"""The MC engine: sweeps of batched steps over all chains at once.

The counterpart of ``surface_sampling_tpu/core/engine.py``. The JAX
engine nests two ``lax.scan``s under one ``jit``; here a run is a Python
loop of batched steps, each step one evaluation of every chain. The
random draws of a run come from one ``torch.Generator`` on the chains'
device, seeded by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from surface_sampling_tpu_torch.core.energy import (
    RelaxConfig,
    identity_surface_energy,
    make_state_energy_fn,
)
from surface_sampling_tpu_torch.core.events import make_semigrand_step
from surface_sampling_tpu_torch.core.spec import SurfaceSpec
from surface_sampling_tpu_torch.core.state import MCState, device_spec, num_occupied_sites
from surface_sampling_tpu_torch.device import resolve_device


class SweepRecord(NamedTuple):
    """Per-sweep observables, leading axes (chains, sweeps)."""

    site_state: torch.Tensor        # (C, sweeps, S)
    energy: torch.Tensor            # (C, sweeps)
    accept_rate: torch.Tensor       # (C, sweeps)
    n_ads: torch.Tensor             # (C, sweeps)
    positions: torch.Tensor         # (C, sweeps, N, 3), or (C, sweeps, 0, 3)
    oob_rate: torch.Tensor          # (C, sweeps) fraction of trial moves OOB-clamped


@dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration."""

    sweep_size: int = 20
    record_positions: bool = True


def geometric_schedule(start_temp: float, total_sweeps: int, alpha: float = 0.99) -> np.ndarray:
    """T_i = start * alpha^i, the default annealing schedule."""
    return start_temp * alpha ** np.arange(total_sweeps, dtype=np.float64)


def run_sweeps(step_fn: Callable, state, temps, seed: int, sweep_size: int, n_sites: int,
               n_codes: int, record: Callable):
    """The sweep loop of a run: ``temps`` (sweeps,) or (C, sweeps); every
    step draws, per chain, a site, a code and an acceptance uniform from one
    ``torch.Generator`` on the state's device seeded with ``seed``, and calls
    ``step_fn(state, temp, site, u_code, u_acc) -> (state, StepInfo)``.
    After each sweep ``record(state, accept_rate, oob_rate)`` gives that
    sweep's record, a tuple of (C, ...) tensors. Returns the final state and
    the records stacked along a sweep axis 1."""
    dev = state.site_state.device
    C = state.site_state.shape[0]
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    recs = []
    for t in range(temps.shape[-1]):
        temp = temps[..., t]
        n_acc = torch.zeros(C, device=dev)
        n_oob = torch.zeros(C, device=dev)
        for _ in range(sweep_size):
            site = torch.randint(0, n_sites, (C,), generator=gen, device=dev)
            u_code = torch.randint(0, n_codes - 1, (C,), generator=gen, device=dev)
            u_acc = torch.rand((C,), generator=gen, device=dev)
            state, info = step_fn(state, temp, site, u_code, u_acc)
            n_acc += info.accepted
            n_oob += info.oob
        recs.append(record(state, n_acc / sweep_size, n_oob / sweep_size))
    return state, type(recs[0])(*(torch.stack(f, dim=1) for f in zip(*recs)))


def make_sweep_record(record_positions: bool = True) -> Callable:
    """``record(state, accept_rate, oob_rate) -> SweepRecord`` of an
    ``MCState`` run (the relaxed positions left out, as an empty axis,
    unless ``record_positions``)."""

    def record(state: MCState, accept_rate, oob_rate) -> SweepRecord:
        pos = state.relaxed_positions
        return SweepRecord(
            site_state=state.site_state,
            energy=state.energy,
            accept_rate=accept_rate,
            n_ads=num_occupied_sites(state.site_state),
            positions=pos if record_positions else pos[:, :0],
            oob_rate=oob_rate,
        )

    return record


def make_run_fn(d, state_energy_fn: Callable, cfg: EngineConfig) -> Callable:
    """Build ``run(state, temps, seed) -> (state, SweepRecord)``.

    ``temps`` holds one temperature per sweep, shape (sweeps,) for a
    schedule all chains share or (C, sweeps) for one per chain. Each step
    draws, per chain, a site, a code and an acceptance uniform from a
    ``torch.Generator`` on the state's device seeded with ``seed``.
    """
    step_fn = make_semigrand_step(d, state_energy_fn)
    n_sites = d.site_coords.shape[0]
    record = make_sweep_record(cfg.record_positions)

    def run(state: MCState, temps, seed: int = 0):
        return run_sweeps(step_fn, state, temps, seed, cfg.sweep_size, n_sites, d.n_codes,
                          record)

    return run


@dataclass
class MCMCRun:
    """Bundle of a spec and a potential staged on one device: the device
    spec ``d`` and the batched ``state_energy_fn`` that runs and steps use
    (every trial state FIRE-relaxed when ``relax`` is given)."""

    spec: SurfaceSpec
    potential: object
    surface_energy_fn: Callable | None = None
    device: torch.device | str = "cuda"
    relax: RelaxConfig | None = None

    def __post_init__(self):
        self.d = device_spec(self.spec, resolve_device(self.device))
        self.state_energy_fn = make_state_energy_fn(
            self.d, self.potential, self.surface_energy_fn or identity_surface_energy,
            relax=self.relax)
