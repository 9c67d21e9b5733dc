"""LAMMPS-style cubic spline tables: host coefficients, device evaluation.

The counterpart of ``surface_sampling_tpu/ops/splines.py``. EAM energies
in the reference come from LAMMPS ``pair_style eam``, so the tables are
interpolated the way LAMMPS does (pair_eam.cpp ``interpolate()``): a local
cubic per interval with finite-difference end slopes and a 5-point
interior derivative stencil. Coefficients are built once on the host
(numpy, float64); evaluation is an index gather plus a Horner chain.

The JAX package has three evaluators of one function because a TPU gather
pads the 4 coefficients to a 128-lane tile: four scalar gathers in pair
loops (``spline_eval``), a row gather (``spline_eval_rows``) and a one-hot
matmul (``spline_eval_onehot``) for per-atom lookups. On the card all
three are the same direct row gather; the names stay so that each call
site finds its counterpart, and all three give bitwise the same values.
"""

from __future__ import annotations

import numpy as np
import torch


def lammps_spline_coeffs(f: np.ndarray) -> np.ndarray:
    """Per-interval cubic coefficients the way LAMMPS pair_eam builds them.

    Input ``f`` has n samples on a uniform grid x_j = j * delta (0-based).
    Returns (n, 4) coefficients [c3, c2, c1, c0] for the local coordinate
    t in [0, 1] of interval j: value = ((c3*t + c2)*t + c1)*t + c0.
    The last row duplicates the endpoint with zero curvature (LAMMPS sets
    the top-interval cubic/quadratic terms to 0).
    """
    f = np.asarray(f, dtype=np.float64)
    n = len(f)
    fp = np.empty(n)
    fp[0] = f[1] - f[0]
    fp[1] = 0.5 * (f[2] - f[0])
    fp[n - 2] = 0.5 * (f[n - 1] - f[n - 3])
    fp[n - 1] = f[n - 1] - f[n - 2]
    if n > 4:
        k = np.arange(2, n - 2)
        fp[k] = ((f[k - 2] - f[k + 2]) + 8.0 * (f[k + 1] - f[k - 1])) / 12.0
    coeffs = np.zeros((n, 4))
    df = f[1:] - f[:-1]
    coeffs[:-1, 3] = f[:-1]                                    # c0
    coeffs[:-1, 2] = fp[:-1]                                   # c1
    coeffs[:-1, 1] = 3.0 * df - 2.0 * fp[:-1] - fp[1:]         # c2
    coeffs[:-1, 0] = fp[:-1] + fp[1:] - 2.0 * df               # c3
    coeffs[-1, 3] = f[-1]
    coeffs[-1, 2] = fp[-1]
    return coeffs


def spline_eval_np(coeffs: np.ndarray, x: np.ndarray, delta: float) -> np.ndarray:
    """Host (float64) evaluation of one (n, 4) table at ``x`` (1-D)."""
    p = np.asarray(x) / delta
    idx = np.clip(p.astype(int), 0, coeffs.shape[0] - 2)
    t = np.minimum(p - idx, 1.0)
    c = coeffs[idx]
    return ((c[:, 0] * t + c[:, 1]) * t + c[:, 2]) * t + c[:, 3]


def _interval(x: torch.Tensor, inv_delta: float, n: int):
    p = x * inv_delta
    idx = torch.clamp(p.to(torch.int64), 0, n - 2)
    t = torch.clamp(p - idx.to(p.dtype), max=1.0)
    return idx, t


def _rows(coeffs: torch.Tensor, idx: torch.Tensor, table_idx, n: int) -> torch.Tensor:
    """(..., 4) coefficient rows of interval ``idx`` (of table ``table_idx``
    for stacked tables), one direct gather."""
    if coeffs.dim() == 2:
        return coeffs[idx]
    if table_idx is None:
        raise ValueError("stacked tables need table_idx")
    return coeffs.reshape(-1, 4)[table_idx * n + idx]


def spline_eval(coeffs: torch.Tensor, x: torch.Tensor, inv_delta: float,
                table_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate a spline table at ``x`` (the output has x's shape).

    Args:
        coeffs: (n, 4) single table, or (T, n, 4) stacked tables.
        x: query points, any shape.
        inv_delta: 1 / grid spacing.
        table_idx: int tensor broadcastable to x's shape selecting the table
            per query (required iff coeffs is stacked).
    """
    n = coeffs.shape[-2]
    idx, t = _interval(x, inv_delta, n)
    if table_idx is not None:
        table_idx = torch.broadcast_to(table_idx, idx.shape)
    cc = _rows(coeffs, idx, table_idx, n)
    return ((cc[..., 0] * t + cc[..., 1]) * t + cc[..., 2]) * t + cc[..., 3]


# the JAX package's per-atom forms (a padded row gather and a one-hot
# matmul on the TPU) are the same gather here
spline_eval_rows = spline_eval
spline_eval_onehot = spline_eval


def spline_eval_deriv(coeffs: torch.Tensor, x: torch.Tensor, inv_delta: float,
                      table_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Derivative of :func:`spline_eval` with respect to x."""
    n = coeffs.shape[-2]
    idx, t = _interval(x, inv_delta, n)
    if table_idx is not None:
        table_idx = torch.broadcast_to(table_idx, idx.shape)
    cc = _rows(coeffs, idx, table_idx, n)
    return ((3.0 * cc[..., 0] * t + 2.0 * cc[..., 1]) * t + cc[..., 2]) * inv_delta
