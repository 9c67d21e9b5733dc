"""Cross-cutting utilities: logging, run folders, annealing schedules,
figures, timing and workflow helpers."""

from surface_sampling_tpu_torch.utils.logging import SilenceLogger, setup_logger
from surface_sampling_tpu_torch.utils.sampling import create_anneal_schedule, per_chain_schedules
from surface_sampling_tpu_torch.utils.setup import setup_folders

__all__ = ["SilenceLogger", "create_anneal_schedule", "per_chain_schedules", "setup_folders",
           "setup_logger"]
