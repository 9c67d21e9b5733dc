"""Matplotlib figures (the counterpart of ``surface_sampling_tpu/utils/plot.py``,
Agg backend).

matplotlib is imported inside each function, never when this module is
imported: a machine without it (the card machine has none) runs every
path whose numbers need no figure. There each figure function logs one
line that names it and returns None, so callers call them directly.
"""

from __future__ import annotations

import functools
import logging
from pathlib import Path

import numpy as np


def have_matplotlib() -> bool:
    """True when matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _needs_matplotlib(fn):
    """Run the figure function ``fn`` where matplotlib is installed; log
    and return None where it is not."""

    @functools.wraps(fn)
    def draw(*args, **kwargs):
        if not have_matplotlib():
            logging.getLogger("sst").info("matplotlib is not installed: %s not drawn",
                                          fn.__name__)
            return None
        return fn(*args, **kwargs)

    return draw


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, save_folder, name):
    plt = _plt()
    if save_folder is not None:
        fig.savefig(Path(save_folder) / name, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig


@_needs_matplotlib
def plot_summary_stats(energy_hist, frac_accept_hist, adsorption_count_hist, num_sweeps: int,
                       save_folder=None):
    """Energy, acceptance rate and adsorbed-atom count against the sweep
    (``summary_stats.png``)."""
    plt = _plt()
    runs = np.arange(1, num_sweeps + 1)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].plot(runs, np.asarray(energy_hist))
    axes[0].set_xlabel("Sweep")
    axes[0].set_ylabel("Energy (eV)")
    axes[1].plot(runs, np.asarray(frac_accept_hist))
    axes[1].set_xlabel("Sweep")
    axes[1].set_ylabel("Acceptance rate")
    axes[2].plot(runs, np.asarray(adsorption_count_hist))
    axes[2].set_xlabel("Sweep")
    axes[2].set_ylabel("Adsorbed atoms")
    fig.tight_layout()
    return _save(fig, save_folder, "summary_stats.png")


@_needs_matplotlib
def plot_energy_analysis(energies, accept_rates, save_folder=None, bins: int = 40):
    """Energy trace and histogram (``energy_analysis.png``)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    e = np.asarray(energies).ravel()
    axes[0].plot(e)
    axes[0].set_xlabel("Sweep")
    axes[0].set_ylabel("Surface energy (eV)")
    axes[1].hist(e, bins=bins)
    axes[1].set_xlabel("Surface energy (eV)")
    axes[1].set_ylabel("Count")
    fig.tight_layout()
    return _save(fig, save_folder, "energy_analysis.png")


@_needs_matplotlib
def plot_anneal_schedule(temps, save_folder=None):
    """The temperature schedule (``anneal_schedule.png``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(np.asarray(temps))
    ax.set_xlabel("Sweep")
    ax.set_ylabel("Temperature (kB T)")
    return _save(fig, save_folder, "anneal_schedule.png")


@_needs_matplotlib
def plot_atom_type_histograms(counts_per_type: dict, save_folder=None):
    """Per-element adsorption-count histograms (``atom_type_histograms.png``)."""
    plt = _plt()
    n = len(counts_per_type)
    fig, axes = plt.subplots(1, max(n, 1), figsize=(3.2 * max(n, 1), 3.2))
    if n == 1:
        axes = [axes]
    for ax, (sym, counts) in zip(axes, counts_per_type.items()):
        ax.hist(np.asarray(counts), bins="auto")
        ax.set_xlabel(f"{sym} count")
        ax.set_ylabel("Frequency")
    fig.tight_layout()
    return _save(fig, save_folder, "atom_type_histograms.png")


@_needs_matplotlib
def plot_clustering_results(points, num_clusters, labels, selected=None, save_folder=None, **kw):
    """2-D scatter of clustered latent points (``clustering_results.png``)."""
    plt = _plt()
    pts = np.asarray(points)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    sc = ax.scatter(pts[:, 0], pts[:, 1], c=np.asarray(labels), cmap="tab20", s=18)
    if selected is not None:
        ax.scatter(pts[selected, 0], pts[selected, 1], marker="x", c="k", s=60)
    ax.set_xlabel("PC 1")
    ax.set_ylabel("PC 2")
    ax.set_title(f"{num_clusters} clusters")
    fig.colorbar(sc, ax=ax)
    return _save(fig, save_folder, "clustering_results.png")


@_needs_matplotlib
def plot_dendrogram(linkage_matrix, save_folder=None, save_prepend: str = ""):
    """Ward dendrogram (``<prepend>dendrogram.png``)."""
    from scipy.cluster.hierarchy import dendrogram

    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    dendrogram(linkage_matrix, ax=ax, no_labels=True)
    ax.set_ylabel("Ward distance")
    return _save(fig, save_folder, f"{save_prepend}dendrogram.png")


@_needs_matplotlib
def plot_distance_weight_matrix(dwm, save_folder=None):
    """The distance-decay weight matrix (``distance_weight_matrix.png``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4.5, 4))
    im = ax.imshow(np.asarray(dwm), cmap="viridis")
    ax.set_xlabel("Site j")
    ax.set_ylabel("Site i")
    fig.colorbar(im, ax=ax)
    return _save(fig, save_folder, "distance_weight_matrix.png")


@_needs_matplotlib
def plot_decay_curve(distances, weights, save_folder=None):
    """Weight against distance (``decay_curve.png``)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4.5, 3.5))
    order = np.argsort(np.asarray(distances))
    ax.plot(np.asarray(distances)[order], np.asarray(weights)[order], ".-")
    ax.set_xlabel("Distance (A)")
    ax.set_ylabel("Weight")
    return _save(fig, save_folder, "decay_curve.png")


@_needs_matplotlib
def plot_specific_weights(coords, weights, site_idx, save_folder=None, run_iter: int = 0):
    """Per-site selection weights around one site
    (``specific_weights_iter_<n>.png``)."""
    plt = _plt()
    c = np.asarray(coords)
    fig, ax = plt.subplots(figsize=(4.5, 4))
    sc = ax.scatter(c[:, 0], c[:, 1], c=np.asarray(weights), cmap="plasma", s=30)
    ax.scatter([c[site_idx, 0]], [c[site_idx, 1]], marker="*", c="r", s=120)
    ax.set_xlabel("x (A)")
    ax.set_ylabel("y (A)")
    fig.colorbar(sc, ax=ax)
    return _save(fig, save_folder, f"specific_weights_iter_{run_iter:04d}.png")


@_needs_matplotlib
def plot_surfaces(structures, save_folder=None, max_cols: int = 4, save_prepend: str = ""):
    """Top-view (x, y) grid of structures, sized by z and coloured by
    atomic number (``<prepend>surfaces.png``)."""
    plt = _plt()
    structures = list(structures)
    n = len(structures)
    cols = min(max_cols, max(n, 1))
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for k, st in enumerate(structures):
        ax = axes[k // cols][k % cols]
        z = st.positions[:, 2]
        zspan = max(z.max() - z.min(), 1e-6)
        size = 20 + 60 * (z - z.min()) / zspan
        ax.scatter(st.positions[:, 0], st.positions[:, 1], s=size, c=st.numbers,
                   cmap="viridis", edgecolors="k", linewidths=0.3)
        ax.set_title(st.formula, fontsize=8)
        ax.set_aspect("equal")
    for k in range(n, rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.tight_layout()
    return _save(fig, save_folder, f"{save_prepend}surfaces.png")
