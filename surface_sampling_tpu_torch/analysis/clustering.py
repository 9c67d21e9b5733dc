"""Latent-space clustering of sampled structures.

The counterpart of ``surface_sampling_tpu/analysis/clustering.py`` (a
re-design of mcmc/utils/clustering.py): PCA(32, whiten) -> Ward
hierarchical clustering on the first 3 PCs -> fcluster by distance or
maxclust, then per-cluster representative selection by force_std / energy
/ gmm / random. The embeddings come from the PaiNN forward on the card
(``cli.clustering``); the O(n^2) Ward linkage of <= 10^4 structures stays
on the host (numpy and scipy), as in the JAX package. Every function takes
numpy arrays or tensors; a tensor is moved to the host once.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Literal

import numpy as np
import torch
from scipy.cluster.hierarchy import fcluster, linkage

logger = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor is detached and copied to the host
    once, a list of tensors stacked on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
        return torch.stack(list(x)).detach().cpu().numpy()
    return np.asarray(x)


def pca_whiten(X, n_components: int = 32):
    """PCA with whitening (sklearn-equivalent); returns (X_r, evr)."""
    X = np.asarray(_host(X), dtype=np.float64)
    if not np.isfinite(X).all():
        bad = np.where(~np.isfinite(X).all(axis=1))[0]
        raise ValueError(
            f"embeddings contain non-finite values (rows {bad[:8].tolist()}"
            f"{'...' if len(bad) > 8 else ''}); the model likely diverged or "
            "produced overflow on these structures"
        )
    n_components = min(n_components, *X.shape)
    Xc = X - X.mean(axis=0)
    U, S, _ = np.linalg.svd(Xc, full_matrices=False)
    evr = (S**2) / max(np.sum(S**2), np.finfo(np.float64).tiny)  # all-identical rows -> evr 0
    X_r = U[:, :n_components] * np.sqrt(X.shape[0] - 1)
    return X_r, evr[:n_components]


def perform_clustering(
    embeddings,
    clustering_cutoff: float | int,
    cutoff_criterion: Literal["distance", "maxclust"] = "distance",
    n_components: int = 32,
    n_pcs_for_linkage: int = 3,
) -> np.ndarray:
    """PCA + Ward clustering (mcmc/utils/clustering.py:21-87).

    Returns 1-based cluster labels per structure.
    """
    X_r, evr = pca_whiten(_host(embeddings), n_components)
    logger.info("PCA explained ratios: %s", evr[:5])
    Z = linkage(X_r[:, :n_pcs_for_linkage], method="ward", metric="euclidean",
                optimal_ordering=True)
    if cutoff_criterion == "distance":
        y = fcluster(Z, t=clustering_cutoff, criterion="distance", depth=2)
    else:
        y = fcluster(Z, t=int(clustering_cutoff), criterion="maxclust", depth=2)
    logger.info("There are %s clusters", len(np.unique(y)))
    return y


def select_representatives(
    labels,
    metric_values,
    metric: Literal["force_std", "energy", "gmm", "random"] = "force_std",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Pick one structure index per cluster (clustering.py:88-158):
    the max-metric member, or a random member for metric='random' (drawn
    from ``rng``; an unseeded generator when None, as in the JAX package)."""
    labels = _host(labels)
    metric_values = _host(metric_values)
    rng = rng or np.random.default_rng()
    selected = []
    for c in np.unique(labels):
        members = np.where(labels == c)[0]
        if metric == "random":
            selected.append(int(rng.choice(members)))
        else:
            selected.append(int(members[np.argmax(metric_values[members])]))
    return np.array(selected, dtype=int)


def select_data_and_save(
    structures: list,
    labels,
    metric_values,
    metric: str = "force_std",
    save_folder: str | Path = ".",
    save_prepend: str = "",
) -> np.ndarray:
    """Select representatives and save them as ``<save_prepend>clustered.npz``
    (``structure.io.save_structures_npz``; the reference pickles ase.Atoms
    lists, clustering.py:141-158)."""
    from surface_sampling_tpu_torch.structure.io import save_structures_npz

    metric_values = _host(metric_values)
    idx = select_representatives(labels, metric_values, metric)
    path = Path(save_folder) / f"{save_prepend}clustered.npz"
    save_structures_npz(path, [structures[i] for i in idx],
                        energies=[metric_values[i] for i in idx])
    logger.info("Saved %d structures to %s", len(idx), path)
    return idx


def get_cluster_centers(points, n_clusters: int):
    """Ward clustering of site coordinates for even adsorption
    (clustering.py:160-199); returns (centers, labels)."""
    points = _host(points)
    Z = linkage(points, "ward")
    labels = fcluster(Z, n_clusters, criterion="maxclust")
    # fcluster may return fewer clusters than requested (ties); relabel to
    # contiguous 1..k over the clusters that exist
    uniq = np.unique(labels)
    remap = {old: new for new, old in enumerate(uniq, start=1)}
    labels = np.array([remap[v] for v in labels])
    centers = np.array([points[labels == i].mean(axis=0) for i in range(1, len(uniq) + 1)])
    return centers, labels


def find_closest_points_indices(points, centers, labels) -> np.ndarray:
    """Index of the member closest to its cluster center
    (clustering.py:201-245)."""
    points, centers, labels = _host(points), _host(centers), _host(labels)
    out = []
    for i in range(1, len(centers) + 1):
        members = np.where(labels == i)[0]
        d = np.linalg.norm(points[members] - centers[i - 1], axis=1)
        out.append(int(members[np.argmin(d)]))
    return np.array(out, dtype=int)
