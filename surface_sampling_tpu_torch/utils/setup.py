"""Timestamped run folders (the counterpart of
``surface_sampling_tpu/utils/setup.py``)."""

from __future__ import annotations

from datetime import datetime
from pathlib import Path


def setup_folders(
    surface_name: str,
    canonical: bool = False,
    total_sweeps: int = 0,
    start_temp: float = 1.0,
    alpha: float = 1.0,
    base_dir: str | Path | None = None,
    **kwargs,
) -> Path:
    """Create and return
    ``<base_dir or cwd>/<surface>/<ISO time>_sweeps_<n>_start_temp_<T>_alpha_<a>[_<key>_<value>...]_{semigrand|canonical}``."""
    stamp = datetime.now().isoformat(sep="-", timespec="milliseconds")
    base = Path(base_dir) if base_dir else Path.cwd()
    name = f"{stamp}_sweeps_{total_sweeps}_start_temp_{start_temp}_alpha_{alpha}"
    for key, value in kwargs.items():
        name += f"_{key}_{value}"
    name += "_canonical" if canonical else "_semigrand"
    run_folder = base / surface_name / name
    run_folder.mkdir(parents=True, exist_ok=False)
    return run_folder
