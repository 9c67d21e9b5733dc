"""Sampling statistics: energy distributions and chain diagnostics (the
counterpart of ``surface_sampling_tpu/analysis/statistics.py``; numpy and
scipy on the host).

Distribution summaries and two-sample comparisons (Wasserstein,
Kolmogorov-Smirnov) for parity checks, and integrated autocorrelation
times for chain mixing and effective sample sizes.
"""

from __future__ import annotations

import numpy as np


def distribution_summary(energies) -> dict:
    """Mean, std, quantiles, min and max of an energy sample (any shape,
    flattened)."""
    e = np.asarray(energies, dtype=np.float64).ravel()
    qs = np.quantile(e, [0.05, 0.25, 0.5, 0.75, 0.95])
    return {
        "n": int(e.size),
        "mean": float(e.mean()),
        "std": float(e.std()),
        "min": float(e.min()),
        "max": float(e.max()),
        "q05": float(qs[0]),
        "q25": float(qs[1]),
        "median": float(qs[2]),
        "q75": float(qs[3]),
        "q95": float(qs[4]),
    }


def compare_distributions(a, b) -> dict:
    """Two-sample comparison of energy distributions: Wasserstein-1
    distance, Kolmogorov-Smirnov statistic and p-value, and the difference
    of means in units of the pooled std."""
    from scipy import stats

    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    ks = stats.ks_2samp(a, b)
    pooled = np.sqrt(0.5 * (a.var() + b.var()))
    return {
        "wasserstein": float(stats.wasserstein_distance(a, b)),
        "ks_stat": float(ks.statistic),
        "ks_pvalue": float(ks.pvalue),
        "mean_diff_sigma": float((a.mean() - b.mean()) / max(pooled, 1e-12)),
    }


def autocorrelation(series, max_lag: int | None = None) -> np.ndarray:
    """Normalized autocorrelation function of a 1-D chain observable
    (``[1.]`` for a constant series)."""
    x = np.asarray(series, dtype=np.float64).ravel()
    x = x - x.mean()
    n = len(x)
    max_lag = max_lag or n // 2
    var = np.dot(x, x) / n
    if var <= 0:
        return np.ones(1)
    return np.array([np.dot(x[: n - k], x[k:]) / ((n - k) * var) for k in range(max_lag)])


def integrated_autocorrelation_time(series, window_factor: float = 5.0) -> float:
    """Integrated autocorrelation time by Sokal's self-consistent window:
    tau = 1 + 2 sum_k acf(k), stopped at the first k >= window_factor * tau
    (at least 1)."""
    acf = autocorrelation(series)
    tau = 1.0
    s = 1.0
    for k in range(1, len(acf)):
        s += 2.0 * acf[k]
        tau = max(s, 1.0)
        if k >= window_factor * tau:
            break
    return float(tau)


def effective_sample_size(series) -> float:
    """ESS = n / tau_int of a per-chain observable series."""
    x = np.asarray(series).ravel()
    return float(len(x) / integrated_autocorrelation_time(x))


def pooled_chain_energies(rec_energy) -> np.ndarray:
    """A (chains, sweeps) record flattened into an equilibrium sample, the
    first half of each chain dropped as burn-in."""
    e = np.asarray(rec_energy)
    if e.ndim == 1:
        e = e[None]
    half = e.shape[1] // 2
    return e[:, half:].ravel()
