"""MACE state-dict converter: the counterpart of
``surface_sampling_tpu/models/convert_mace.py``.

The reference ships no MACE weights, so what this module pins down is the
contract for loading externally trained weights into ``models/mace.py``:

  * :func:`export_mace_state_dict`: a parameter tree as a flat torch-style
    state dict (``layers.{t}.{name}.weight`` / ``.bias``; Linear weights in
    torch's (out, in) orientation).
  * :func:`convert_mace_state_dict`: the inverse, a flat name -> array
    mapping (tensors, numpy arrays, or an npz of the same) back to (params,
    MACEConfig) with the dims inferred from the shapes. The official
    ``mace`` package's names with an exact counterpart are aliased
    (``node_embedding.linear.weight`` -> atom_embed,
    ``atomic_energies_fn.atomic_energies`` -> atom_ref,
    ``readouts.{t}.linear.weight`` -> the layer's readout); any other key of
    a foreign checkpoint has no 1:1 counterpart (the model is a from-paper
    re-design) and the converter refuses it (``strict=True``) rather than
    silently mis-mapping it.

Parameters come back as trees of numpy arrays, as the JAX package's do;
``models.weights.from_jax_params`` makes the tensors.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from surface_sampling_tpu_torch.models.mace import MACEConfig, init_mace
from surface_sampling_tpu_torch.models.painn import tree_map
from surface_sampling_tpu_torch.models.prediction import _np

# the canonical flat naming <- aliases used by the official mace package
# where the semantics correspond 1:1
_ALIASES = {
    "node_embedding.linear.weight": "atom_embed",
    "atomic_energies_fn.atomic_energies": "atom_ref",
}
_ALIAS_LAYER = {
    # official per-interaction readouts: readouts.{t}.linear.weight/bias
    "readouts.{t}.linear.weight": "layers.{t}.readout.weight",
    "readouts.{t}.linear.bias": "layers.{t}.readout.bias",
}


def _iter_param_leaves(params):
    """Yield (flat_name, leaf, kind) over the params tree, torch-style:
    dense dicts {"w": (in, out)[, "b"]} become name.weight/name.bias."""
    yield "atom_embed", params["atom_embed"], "plain"
    yield "atom_ref", params["atom_ref"], "plain"
    for t, layer in enumerate(params["layers"]):
        for name, leaf in layer.items():
            yield f"layers.{t}.{name}.weight", leaf["w"], "linear_w"
            if "b" in leaf:
                yield f"layers.{t}.{name}.bias", leaf["b"], "plain"


def export_mace_state_dict(params) -> dict:
    """Flat torch-convention state dict (numpy arrays) of a MACE parameter
    tree of tensors or arrays (Linear weights transposed to torch's
    (out_features, in_features))."""
    sd = {}
    for name, leaf, kind in _iter_param_leaves(params):
        arr = _np(leaf)
        sd[name] = arr.T.copy() if kind == "linear_w" else arr.copy()
    return sd


def _infer_cfg(sd: dict) -> MACEConfig:
    max_z, F = sd["atom_embed"].shape
    n_layers = len({int(k.split(".")[1]) for k in sd if k.startswith("layers.")})
    R = sd["layers.0.rad0.weight"].shape[1]        # (F, R) in torch orientation
    n_inv = sd["layers.0.update0.weight"].shape[1] // F
    l_max = {5: 1, 9: 2, 13: 3}[n_inv]
    eq = "layers.0.v_upd.weight" in sd
    return MACEConfig(feat_dim=F, n_rbf=R, n_layers=n_layers, max_z=max_z,
                      l_max=l_max, equivariant_messages=eq)


def convert_mace_state_dict(sd: dict, cfg: MACEConfig | None = None, strict: bool = True):
    """Rebuild (params as a tree of numpy arrays, cfg) from a flat state
    dict (see the module docstring). Values may be tensors, numpy arrays or
    anything ``np.asarray`` accepts. Unknown keys raise when ``strict``: a
    foreign checkpoint's unmapped weights mean the architectures do not
    correspond, and dropping them would give a confidently wrong model."""
    sd = {k: _np(v) for k, v in sd.items()}
    for alias, canon in _ALIASES.items():
        if alias in sd and canon not in sd:
            sd[canon] = sd.pop(alias)
    t = 0
    while True:
        hit = False
        for alias_t, canon_t in _ALIAS_LAYER.items():
            a, c = alias_t.format(t=t), canon_t.format(t=t)
            if a in sd and c not in sd:
                sd[c] = sd.pop(a)
                hit = True
        if not hit and not any(f"readouts.{t}." in k for k in sd):
            break
        t += 1

    if cfg is None:
        cfg = _infer_cfg(sd)
    # the tree's skeleton (optional blocks included) from an initialisation,
    # then every leaf overwritten from the state dict
    params = tree_map(lambda x: x.numpy(), init_mace(torch.Generator().manual_seed(0), cfg))
    used = set()
    for name, leaf, kind in _iter_param_leaves(params):
        if name not in sd:
            raise KeyError(
                f"state dict is missing {name!r} (expected for "
                f"{cfg.n_layers}-layer l_max={cfg.l_max} "
                f"equivariant={cfg.equivariant_messages} MACE)")
        arr = sd[name].T if kind == "linear_w" else sd[name]
        if arr.shape != leaf.shape:
            raise ValueError(f"{name!r}: shape {arr.shape} does not match {leaf.shape}")
        parts = name.replace(".weight", ".w").replace(".bias", ".b").split(".")
        node = params
        for p in parts[:-1]:
            node = node[int(p)] if p.isdigit() else node[p]
        node[parts[-1]] = np.ascontiguousarray(arr)
        used.add(name)
    unknown = sorted(set(sd) - used)
    if unknown and strict:
        raise ValueError(
            "state dict has keys with no counterpart in the MACE model "
            f"(architectures differ — refusing to drop them): {unknown[:8]}"
            f"{' ...' if len(unknown) > 8 else ''}")
    return params, cfg


def load_mace_state_dict(path: str | Path, cfg: MACEConfig | None = None, strict: bool = True):
    """Load a state dict from a ``.npz`` (flat arrays) or a torch ``.pt``
    / ``.pth`` file (a pickled state dict, or an object exposing
    ``.state_dict()``) and convert it."""
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p) as d:
            sd = {k: d[k] for k in d.files}
    else:
        obj = torch.load(p, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return convert_mace_state_dict(sd, cfg, strict=strict)
