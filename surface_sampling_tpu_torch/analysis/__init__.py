"""Analysis layer. Ported so far: the sampling statistics (ESS,
autocorrelation, distribution comparisons); clustering and uncertainty come
with a later slice."""

from surface_sampling_tpu_torch.analysis.statistics import (
    autocorrelation,
    compare_distributions,
    distribution_summary,
    effective_sample_size,
    integrated_autocorrelation_time,
    pooled_chain_energies,
)

__all__ = [
    "autocorrelation",
    "compare_distributions",
    "distribution_summary",
    "effective_sample_size",
    "integrated_autocorrelation_time",
    "pooled_chain_energies",
]
