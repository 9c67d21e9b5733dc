"""The benchmark of surface_sampling_tpu_torch (``benchmark/README.md``)."""

import importlib


def family_module(package: str, model: str):
    """``benchmark.<package>.<model>``: what a model family brings as a file
    of its own (``reference/<model>.py``, ``work/<model>.py``), or None
    where it brings no such file."""
    name = f"benchmark.{package}.{model}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None
