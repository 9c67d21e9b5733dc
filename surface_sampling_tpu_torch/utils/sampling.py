"""Annealing schedules (host side, numpy).

The counterpart of ``surface_sampling_tpu/utils/sampling.py``: the
single-chain schedule of a run, and per-chain schedule matrices for chain
batches that anneal differently.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def create_anneal_schedule(
    start_temp: float = 1.0,
    total_sweeps: int = 1000,
    alpha: float = 0.99,
    multiple_anneal: bool = False,
    save_folder: str | Path | None = None,
    save_fig: bool = False,
    save_csv: bool = True,
    **kwargs,
) -> np.ndarray:
    """(total_sweeps,) temperatures: geometric (T <- T * alpha each sweep)
    or the multi-stage recipe (down to 0.10 over 100 sweeps, to 0.08 over
    200, hold 200, back up in 10, repeated). With ``save_folder`` the
    schedule is written to ``anneal_schedule.csv`` there (``save_csv``)
    and, with ``save_fig``, drawn to ``anneal_schedule.png`` when
    matplotlib is installed (one logged line names the figure otherwise)."""
    if not multiple_anneal:
        temps = [start_temp]
        t = start_temp
        while len(temps) < total_sweeps:
            t *= alpha
            temps.append(t)
    else:
        temps = [start_temp]
        while len(temps) < total_sweeps:
            temps.extend(np.linspace(temps[-1], 0.10, 100).tolist())
            temps.extend(np.linspace(0.10, 0.08, 200).tolist())
            temps.extend(np.repeat(0.08, 200).tolist())
            temps.extend(np.linspace(0.08, start_temp, 10).tolist())
    temps = np.asarray(temps[:total_sweeps])
    if save_folder is not None and save_csv:
        (Path(save_folder) / "anneal_schedule.csv").write_text(",".join(str(t) for t in temps))
    if save_folder is not None and save_fig:
        from surface_sampling_tpu_torch.utils.plot import plot_anneal_schedule

        plot_anneal_schedule(temps, save_folder=save_folder)
    return temps


def per_chain_schedules(
    n_chains: int,
    total_sweeps: int,
    start_temp: float = 1.0,
    alpha: float = 0.99,
    stagger: float = 0.0,
) -> np.ndarray:
    """(n_chains, total_sweeps) schedule matrix; ``stagger`` > 0 spreads the
    chains' start temperatures geometrically (ensemble annealing)."""
    base = create_anneal_schedule(start_temp, total_sweeps, alpha)
    if stagger <= 0:
        return np.broadcast_to(base, (n_chains, total_sweeps)).copy()
    factors = np.geomspace(1.0, 1.0 + stagger, n_chains)
    return factors[:, None] * base[None, :]
