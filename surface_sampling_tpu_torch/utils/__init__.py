"""Cross-cutting utilities (the ported part: annealing schedules)."""

from surface_sampling_tpu_torch.utils.sampling import create_anneal_schedule, per_chain_schedules

__all__ = ["create_anneal_schedule", "per_chain_schedules"]
