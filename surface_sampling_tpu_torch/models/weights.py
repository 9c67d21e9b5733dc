"""Model weights: the npz checkpoints and the JAX package's parameter trees
as trees of torch tensors (PaiNN ensembles with a leading member axis, the
CHGNet and MACE models without one).

A checkpoint npz holds flat keys
``message.{l}.{dist_embed,inv_dense0,inv_dense1}.{w,b}``,
``update.{l}.{u_mat,v_mat,s_dense0,s_dense1}.{w[,b]}``,
``readout.{dense0,dense1}.{w,b}``, ``atom_embed`` and the configuration
as ``__cfg__<field>``. Weights are stored as ``x @ w`` matrices (inputs
first), the convention both packages compute with.
"""

from __future__ import annotations

import numpy as np
import torch

from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, tree_map


def _unflatten(flat: dict) -> dict:
    """Dotted keys -> nested dicts, with all-digit levels as lists."""
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts and lists -> dotted keys (list levels as digits)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flatten(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flatten(v, f"{prefix}{i}.").items()}
    x = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return {prefix[:-1]: x}


def load_painn_npz(path) -> tuple[dict, PaiNNConfig]:
    """One checkpoint as a tree of numpy arrays plus its configuration.

    ``max_neighbors`` is a runtime padding choice, not a property of the
    checkpoint: a stored value is dropped and the caller's default kept.
    The JAX package's TPU execution choices (``message_mode``,
    ``pallas_routing``: which Pallas routing its forward takes), which every
    checkpoint it writes carries, mean nothing here and are dropped too."""
    with np.load(path) as d:
        flat = {k: d[k] for k in d.files if not k.startswith("__cfg__")}
        cfg_kw = {k[len("__cfg__"):]: d[k].item() for k in d.files if k.startswith("__cfg__")}
    for runtime_key in ("max_neighbors", "message_mode", "pallas_routing"):
        cfg_kw.pop(runtime_key, None)
    for int_key in ("feat_dim", "n_rbf", "n_layers", "max_z", "readout_hidden"):
        if int_key in cfg_kw:
            cfg_kw[int_key] = int(cfg_kw[int_key])
    for float_key in ("cutoff", "power", "sigma"):
        if float_key in cfg_kw:
            cfg_kw[float_key] = float(cfg_kw[float_key])
    if "excl_vol" in cfg_kw:
        cfg_kw["excl_vol"] = bool(cfg_kw["excl_vol"])
    return _unflatten(flat), PaiNNConfig(**cfg_kw)


def save_painn_npz(path, params: dict, cfg: PaiNNConfig, member: int | None = None) -> None:
    """Write one model as a checkpoint: flat keys plus ``__cfg__<field>``,
    the layout the JAX package's ``load_params_npz`` reads (and
    :func:`load_painn_npz`). ``params`` is a tree of tensors or arrays;
    with ``member``, a stacked tree whose member ``member`` is written."""
    if member is not None:
        params = tree_map(lambda x: x[member], params)
    meta = {f"__cfg__{k}": np.asarray(v) for k, v in cfg.__dict__.items()}
    np.savez_compressed(path, **_flatten(params), **meta)


def load_painn_ensemble(paths, device) -> tuple[dict, PaiNNConfig]:
    """Checkpoints of an ensemble stacked along a leading member axis, as
    f32 tensors on ``device``. All members must share one configuration."""
    trees, cfgs = zip(*(load_painn_npz(p) for p in paths))
    if any(c != cfgs[0] for c in cfgs[1:]):
        raise ValueError("ensemble members have different configurations")
    stacked = tree_map(lambda *xs: np.stack(xs), *trees)
    return from_jax_params(stacked, device), cfgs[0]


def load_chgnet_npz(path) -> tuple[dict, CHGNetConfig]:
    """A CHGNet checkpoint (the JAX package's ``convert_chgnet`` output:
    the same flat keys and ``__cfg__<field>`` scheme) as a tree of numpy
    arrays plus its configuration. Conversions that stored a neighbour
    padding below 96 (too small for oxides at 6 A) get 96, as the JAX
    package's loader does; stored TPU execution choices are dropped."""
    with np.load(path) as d:
        flat = {k: d[k] for k in d.files if not k.startswith("__cfg__")}
        cfg_kw = {k[len("__cfg__"):]: d[k].item() if d[k].ndim == 0 else tuple(d[k])
                  for k in d.files if k.startswith("__cfg__")}
    for int_key in ("atom_fea_dim", "bond_fea_dim", "angle_fea_dim", "num_radial",
                    "num_angular", "n_conv", "cutoff_coeff", "max_z",
                    "max_neighbors", "max_bond_neighbors"):
        if int_key in cfg_kw:
            cfg_kw[int_key] = int(cfg_kw[int_key])
    if "is_intensive" in cfg_kw:
        cfg_kw["is_intensive"] = bool(cfg_kw["is_intensive"])
    if "mlp_hidden_dims" in cfg_kw:
        cfg_kw["mlp_hidden_dims"] = tuple(int(x) for x in np.atleast_1d(cfg_kw["mlp_hidden_dims"]))
    if cfg_kw.get("max_neighbors", 96) < 96:
        cfg_kw["max_neighbors"] = 96
    for tpu_key in ("conv_mode", "pallas_routing"):   # TPU execution choices
        cfg_kw.pop(tpu_key, None)
    return _unflatten(flat), CHGNetConfig(**cfg_kw)


def save_chgnet_npz(path, params: dict, cfg: CHGNetConfig) -> None:
    """Write a CHGNet model (a tree of tensors or arrays, no member axis) in
    the JAX package's flat npz scheme (dotted keys, ``__cfg__<field>``),
    which its ``load_chgnet_npz`` and :func:`load_chgnet_npz` read."""
    meta = {f"__cfg__{k}": np.asarray(v) for k, v in cfg.__dict__.items()}
    np.savez_compressed(path, **_flatten(params), **meta)


def from_jax_params(tree, device) -> dict:
    """A JAX parameter tree (leaves converted to numpy arrays: a stacked
    PaiNN ensemble with its leading member axis, or one CHGNet or MACE
    model, whose trees hold dicts and lists of layers) as f32 tensors on
    ``device``, in the same structure."""
    return tree_map(
        lambda x: torch.as_tensor(np.array(x, np.float32), device=device), tree)


def load_mace_npz(path):
    """A MACE checkpoint in the JAX package's flat npz scheme (written by
    either package's ``save_mace_npz``) as a tree of numpy arrays plus its
    ``MACEConfig`` (``models.mace.load_mace_npz``)."""
    from surface_sampling_tpu_torch.models.mace import load_mace_npz as load

    return load(path)
