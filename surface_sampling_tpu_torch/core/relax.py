"""Structure relaxation inside the MC step: masked FIRE, batched over
chains.

The counterpart of ``fire_relax`` in ``surface_sampling_tpu/core/relax.py``
(which replaces the reference's per-move ASE optimizer, relax_steps=20,
fmax=0.01). The JAX package runs one ``lax.while_loop`` per chain under
``vmap``; here one Python loop advances every chain at once, and a chain
whose loop has ended (``i >= steps`` or ``max|F| < fmax``) keeps its carry
unchanged while the others go on, which is what the batched while loop
does. The loop ends when no chain is active, read back once per iteration.
Positions are detached between iterations, so no autograd graph spans the
loop. Frozen bulk atoms and dead slots enter through a force mask.

After relaxation an energy beyond the size-aware bound or a force above
``MAX_FORCE_THRESHOLD`` is out of bounds (energy clamped to the bound), and
a NaN energy or position restores the starting geometry.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

ENERGY_THRESHOLD = 1000.0           # eV
ENERGY_THRESHOLD_PER_ATOM = 20.0    # eV/atom added to it
MAX_FORCE_THRESHOLD = 1000.0        # eV/A


def energy_threshold(n_atoms) -> float:
    """Size-aware OOB energy bound: 1000 eV + 20 eV/atom."""
    return ENERGY_THRESHOLD + ENERGY_THRESHOLD_PER_ATOM * n_atoms


class FireConfig(NamedTuple):
    """FIRE hyperparameters (ASE defaults, matching the reference's use)."""

    steps: int = 20
    fmax: float = 0.01
    dt_start: float = 0.1
    dt_max: float = 1.0
    n_min: int = 5
    f_inc: float = 1.1
    f_dec: float = 0.5
    alpha_start: float = 0.1
    f_alpha: float = 0.99
    max_step: float = 0.2      # max total displacement norm per iteration


class RelaxResult(NamedTuple):
    positions: torch.Tensor    # (C, N, 3)
    energy: torch.Tensor       # (C,) post-relax potential energy (OOB-clamped)
    max_force: torch.Tensor    # (C,)
    converged: torch.Tensor    # (C,) bool
    oob: torch.Tensor          # (C,) bool, energy/force out of bounds or NaN
    n_steps: torch.Tensor      # (C,) int32 iterations each chain took


def _fnorm_max(f: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((f * f).sum(dim=2).amax(dim=1))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """(C,) Euclidean norm over all of a chain's (N, 3) entries."""
    return torch.sqrt((x * x).sum(dim=(1, 2)))


def fire_relax(
    energy_fn: Callable[[torch.Tensor], torch.Tensor],
    positions0: torch.Tensor,
    free_mask: torch.Tensor,
    cfg: FireConfig = FireConfig(),
) -> RelaxResult:
    """Relax every chain of ``positions0`` under ``energy_fn`` with FIRE.

    Args:
        energy_fn: positions (C, N, 3) -> (C,) potential energies (already
            closed over species and alive masks), differentiable.
        positions0: (C, N, 3) starting geometries.
        free_mask: (C, N) bool, True for atoms allowed to move.
        cfg: FIRE hyperparameters.
    """
    dtype, dev = positions0.dtype, positions0.device
    C = positions0.shape[0]
    fmask = free_mask[..., None].to(dtype)
    positions0 = positions0.detach()

    def force_of(pos):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e = energy_fn(p)
            (g,) = torch.autograd.grad(e.sum(), p)
        return e.detach(), -g * fmask

    def sel(active, new, old):
        return torch.where(active.view(-1, *([1] * (new.dim() - 1))), new, old)

    pos = positions0
    vel = torch.zeros_like(pos)
    dt = torch.full((C,), cfg.dt_start, dtype=dtype, device=dev)
    alpha = torch.full((C,), cfg.alpha_start, dtype=dtype, device=dev)
    i = torch.zeros(C, dtype=torch.int32, device=dev)
    n_pos = torch.zeros(C, dtype=torch.int32, device=dev)
    e, f = force_of(pos)
    while True:
        active = (i < cfg.steps) & (_fnorm_max(f) >= cfg.fmax)
        if not bool(active.any()):
            break
        vf = (f * vel).sum(dim=(1, 2))
        uphill = vf <= 0.0
        v_norm, f_norm = _norm(vel), _norm(f)
        scale = (v_norm / torch.clamp(f_norm, min=1e-30))[:, None, None]
        a3 = alpha[:, None, None]
        mixed = (1.0 - a3) * vel + a3 * f * scale
        vel_n = sel(uphill, torch.zeros_like(vel), mixed)
        grow = ~uphill & (n_pos > cfg.n_min)
        dt_n = torch.where(grow, torch.clamp(dt * cfg.f_inc, max=cfg.dt_max), dt)
        alpha_n = torch.where(grow, alpha * cfg.f_alpha, alpha)
        dt_n = torch.where(uphill, dt_n * cfg.f_dec, dt_n)
        alpha_n = torch.where(uphill, torch.full_like(alpha_n, cfg.alpha_start), alpha_n)
        n_pos_n = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        vel_n = vel_n + dt_n[:, None, None] * f
        dr = dt_n[:, None, None] * vel_n
        step = torch.clamp(cfg.max_step / torch.clamp(_norm(dr), min=1e-30), max=1.0)
        pos_n = pos + dr * step[:, None, None] * fmask
        e_n, f_n = force_of(pos_n)
        pos, vel, f = sel(active, pos_n, pos), sel(active, vel_n, vel), sel(active, f_n, f)
        e, dt, alpha = sel(active, e_n, e), sel(active, dt_n, dt), sel(active, alpha_n, alpha)
        n_pos, i = sel(active, n_pos_n, n_pos), sel(active, i + 1, i)
    return _finish(pos, e, _fnorm_max(f), positions0, i, cfg)


def _finish(pos, e, mf, positions0, i, cfg: FireConfig) -> RelaxResult:
    e_bound = torch.full_like(e, energy_threshold(pos.shape[1]))
    oob = (e.abs() > e_bound) | (mf > MAX_FORCE_THRESHOLD)
    e_out = torch.where(oob, e_bound, e)
    nan_guard = torch.isnan(e_out) | torch.isnan(pos).any(dim=(1, 2))
    e_out = torch.where(nan_guard, e_bound, e_out)
    pos = torch.where(nan_guard[:, None, None], positions0, pos)
    return RelaxResult(
        positions=pos,
        energy=e_out,
        max_force=mf,
        converged=mf < cfg.fmax,
        oob=oob | nan_guard,
        n_steps=i,
    )
