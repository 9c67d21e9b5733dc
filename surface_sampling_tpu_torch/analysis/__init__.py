"""Analysis layer: uncertainty quantification, latent-space clustering and
the sampling statistics (ESS, autocorrelation, distribution comparisons)."""

from surface_sampling_tpu_torch.analysis.clustering import (
    find_closest_points_indices,
    get_cluster_centers,
    pca_whiten,
    perform_clustering,
    select_data_and_save,
    select_representatives,
)
from surface_sampling_tpu_torch.analysis.statistics import (
    autocorrelation,
    compare_distributions,
    distribution_summary,
    effective_sample_size,
    integrated_autocorrelation_time,
    pooled_chain_energies,
)
from surface_sampling_tpu_torch.analysis.uncertainty import (
    ConformalPrediction,
    EnsembleUncertainty,
    GMMUncertainty,
    Uncertainty,
    fit_gmm_em,
    get_unc_class,
    reduce_order,
)

__all__ = [
    "ConformalPrediction",
    "EnsembleUncertainty",
    "GMMUncertainty",
    "Uncertainty",
    "autocorrelation",
    "compare_distributions",
    "distribution_summary",
    "effective_sample_size",
    "find_closest_points_indices",
    "fit_gmm_em",
    "get_cluster_centers",
    "get_unc_class",
    "integrated_autocorrelation_time",
    "pca_whiten",
    "perform_clustering",
    "pooled_chain_energies",
    "reduce_order",
    "select_data_and_save",
    "select_representatives",
]
