"""Population annealing over the chain batch axis.

The counterpart of ``surface_sampling_tpu/parallel/population.py``: the
whole chain population anneals together, and at every temperature step
(T_{k-1} -> T_k over a decreasing schedule) it is importance-reweighted and
resampled so that it stays equilibrated at the new temperature (Hukushima &
Iba 2003):

    log w_i = -(1/T_k - 1/T_{k-1}) E_i
    ESS_k   = (sum w)^2 / sum w^2
    dlogZ_k = logsumexp(log w) - log C    (sum_k dlogZ_k -> log Z(T_K)/Z(T_0))
    resample: systematic, by w, when ESS / C < resample_threshold
    sweep:    one MC sweep per chain at T_k

On one card a resampling is one gather along the chain axis of every tensor
of the state (caches included). The resampling uniforms come from the run's
``torch.Generator``, continued in place (the JAX record's ``final_key``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from surface_sampling_tpu_torch.parallel.tempering import take_chains


class PARecord(NamedTuple):
    """Per-step observables, leading axis steps (the JAX package's)."""

    energy: torch.Tensor       # (R, C) after each step's sweep
    ess: torch.Tensor          # (R,) effective sample size of the weights
    dlogz: torch.Tensor        # (R,) log Z(T_k) / Z(T_{k-1}) estimates
    resampled: torch.Tensor    # (R,) bool
    site_state: torch.Tensor   # (R, C, S)


def systematic_resample(u0: torch.Tensor, log_w: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling: n source indices drawn by the weights
    softmax(log_w), from one uniform ``u0`` (the JAX package's
    ``uniform(key, ())``)."""
    cdf = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    u = (u0 + torch.arange(n, dtype=cdf.dtype, device=cdf.device)) / n
    return torch.searchsorted(cdf, u).clamp(0, n - 1)


def make_population_annealing_run(run_fn: Callable, resample_threshold: float = 1.0) -> Callable:
    """Build ``run(states, temps, generator, t_prev=None) -> (states,
    PARecord)``.

    ``run_fn(states, temps, generator)`` is any of the port's runs; a step
    calls it for one sweep at T_k (temps of one entry, shared). ``temps`` is
    the (R,) decreasing schedule; ``states`` must carry energies consistent
    with their occupancies, equilibrated at temps[0] (or at ``t_prev``, the
    temperature of the previous chunk, from which the first entry then
    reweights; None reweights it from itself, a zero-weight step).
    ``resample_threshold``: resample when ESS / C < threshold (1.0 always,
    0.0 never). Every step draws its resampling uniform, resampled or not.
    """

    def run(states, temps, generator: torch.Generator, t_prev=None):
        dev = states.energy.device
        temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
        C = states.energy.shape[0]
        beta = 1.0 / torch.clamp(temps, min=1e-12)
        b0 = beta[:1] if t_prev is None else 1.0 / torch.clamp(
            torch.as_tensor([t_prev], dtype=torch.float32, device=dev), min=1e-12)
        beta_prev = torch.cat([b0, beta[:-1]])
        ar = torch.arange(C, device=dev)
        recs = []
        for b_prev, b_k in zip(beta_prev, beta):
            log_w = -(b_k - b_prev) * states.energy
            dlogz = torch.logsumexp(log_w, dim=0) - math.log(float(C))
            w = torch.softmax(log_w, dim=0)
            ess = 1.0 / (w * w).sum()
            u0 = torch.rand((), generator=generator, device=generator.device)
            do_rs = ess < resample_threshold * C
            idx = torch.where(do_rs, systematic_resample(u0, log_w, C), ar)
            states, _ = run_fn(take_chains(states, idx), (1.0 / b_k)[None], generator)
            recs.append((states.energy, ess, dlogz, do_rs, states.site_state))
        return states, PARecord(*(torch.stack(x) for x in zip(*recs)))

    return run
