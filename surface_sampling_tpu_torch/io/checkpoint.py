"""Checkpoint and exact resume of MC runs (the counterpart of
``surface_sampling_tpu/io/checkpoint.py``).

The whole state of a run is its chain states (site occupancies, energies,
relaxed positions), the sweep index, the temperature schedule and the
state of the one ``torch.Generator`` that draws every random number of the
run (steps, tempering swaps, resampling). A checkpoint is one npz with the
JAX package's keys, except that JAX's PRNG ``key`` is replaced by
``generator_state`` (``Generator.get_state()``, uint8) and
``generator_device`` (its device type): the CUDA and CPU generators'
states are different objects, so a checkpoint resumes only on the device
type that wrote it. Extras keep JAX's ``extra_`` prefix.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from surface_sampling_tpu_torch.core.state import MCState
from surface_sampling_tpu_torch.device import resolve_device


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(
    path: str | Path,
    state: MCState,
    sweep_index: int,
    temps: np.ndarray,
    generator: torch.Generator,
    extra: dict | None = None,
) -> None:
    """Write an exact-resume checkpoint of a chain batch. The file is
    written beside ``path`` and renamed over it, so a run killed while
    writing leaves the previous checkpoint whole."""
    path = Path(path)
    payload = {
        "site_state": _np(state.site_state).astype(np.int32),
        "energy": _np(state.energy),
        "relaxed_positions": _np(state.relaxed_positions),
        "generator_state": _np(generator.get_state()).astype(np.uint8),
        "generator_device": np.asarray(generator.device.type),
        "sweep_index": np.asarray(sweep_index),
        "temps": np.asarray(temps),
    }
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path.with_name(path.name + ".partial.npz")
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str | Path, device: str | torch.device = "cuda"):
    """Read a checkpoint onto ``device``. Returns (MCState, sweep_index,
    temps, extra, generator): the chain states as tensors there, the temps
    and extras as numpy arrays (extras without their prefix), and a
    ``torch.Generator`` on ``device`` in the saved state.

    Raises ValueError for a checkpoint of the JAX package (a PRNG key, no
    generator state) and for one whose generator is of another device type
    than ``device``, and RuntimeError where ``device`` names a card that is
    not there."""
    dev = resolve_device(device)
    with np.load(path) as d:
        files = set(d.files)
        if "generator_state" not in files:
            raise ValueError(
                f"{path} holds a JAX PRNG key and no torch.Generator state: it was written by "
                "the JAX package, whose random stream the port cannot continue; start a new "
                "run (or resume it with the JAX package)")
        saved = str(d["generator_device"])
        if saved != dev.type:
            raise ValueError(
                f"{path} was written on a {saved} device and its generator state is a "
                f"{saved} generator's; it resumes only on {saved} (got device {dev.type}): "
                f"pass --device {saved}")
        state = MCState(
            site_state=torch.as_tensor(d["site_state"].astype(np.int64), device=dev),
            energy=torch.as_tensor(d["energy"], device=dev),
            relaxed_positions=torch.as_tensor(d["relaxed_positions"], device=dev),
        )
        gen = torch.Generator(device=dev)
        gen.set_state(torch.as_tensor(d["generator_state"], dtype=torch.uint8))
        extra = {k[len("extra_"):]: d[k] for k in d.files if k.startswith("extra_")}
        return state, int(d["sweep_index"]), d["temps"], extra, gen
