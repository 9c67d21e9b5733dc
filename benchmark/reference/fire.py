"""Plain FIRE relaxation (Bitzek et al., PRL 97, 170201 (2006), with ASE's
defaults), each chain on its own: forces by autograd of the reference
energy, the frozen slab and dead slots held.

Per iteration of a chain that is still moving (max |F| >= fmax, fewer than
``steps`` iterations): with P = F . v, P <= 0 zeroes v, halves dt and
resets alpha; otherwise v = (1 - alpha) v + alpha |v| F / |F|, and after
more than ``n_min`` such iterations in a row dt grows by ``f_inc`` (to
``dt_max``) and alpha shrinks by ``f_alpha``. Then v += dt F and the atoms
move by dt v, the whole chain's displacement capped at ``max_step``.
"""

from __future__ import annotations

from typing import Callable

import torch


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=(1, 2)))


def forces(energy_of: Callable, pos: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy_of(p).sum(), p)
    return -g * free[..., None]


def fire(energy_of: Callable, pos0: torch.Tensor, free: torch.Tensor, cfg: dict):
    """Relaxed positions (C, N, 3) and the final max |F| (C,) of every
    chain of ``pos0`` under ``energy_of(positions) -> (C,)``."""
    C = pos0.shape[0]
    dev = pos0.device
    pos, vel = pos0.detach(), torch.zeros_like(pos0)
    dt = torch.full((C,), cfg["dt_start"], device=dev)
    alpha = torch.full((C,), cfg["alpha_start"], device=dev)
    n_pos = torch.zeros(C, dtype=torch.int64, device=dev)
    f = forces(energy_of, pos, free)
    for _ in range(cfg["steps"]):
        fmax = torch.sqrt((f * f).sum(-1).amax(-1))
        moving = fmax >= cfg["fmax"]
        if not bool(moving.any()):
            break
        p = (f * vel).sum(dim=(1, 2))
        up = p <= 0
        mixed = ((1 - alpha)[:, None, None] * vel
                 + (alpha * _norm(vel) / _norm(f).clamp(min=1e-30))[:, None, None] * f)
        v = torch.where(up[:, None, None], torch.zeros_like(vel), mixed)
        grow = ~up & (n_pos > cfg["n_min"])
        dt_n = torch.where(grow, (dt * cfg["f_inc"]).clamp(max=cfg["dt_max"]), dt)
        alpha_n = torch.where(grow, alpha * cfg["f_alpha"], alpha)
        dt_n = torch.where(up, dt_n * cfg["f_dec"], dt_n)
        alpha_n = torch.where(up, torch.full_like(alpha_n, cfg["alpha_start"]), alpha_n)
        n_pos_n = torch.where(up, torch.zeros_like(n_pos), n_pos + 1)
        v = v + dt_n[:, None, None] * f
        dr = dt_n[:, None, None] * v
        scale = (cfg["max_step"] / _norm(dr).clamp(min=1e-30)).clamp(max=1.0)
        pos_n = pos + dr * scale[:, None, None] * free[..., None]
        f_n = forces(energy_of, pos_n, free)
        m = moving[:, None, None]
        pos, vel, f = torch.where(m, pos_n, pos), torch.where(m, v, vel), torch.where(m, f_n, f)
        dt, alpha = torch.where(moving, dt_n, dt), torch.where(moving, alpha_n, alpha)
        n_pos = torch.where(moving, n_pos_n, n_pos)
    return pos, torch.sqrt((f * f).sum(-1).amax(-1))
