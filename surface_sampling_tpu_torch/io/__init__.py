"""Checkpoint and resume of MC runs."""

from surface_sampling_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
