"""Convert reference nff PaiNN torch checkpoints to the port's parameter
tree and checkpoint npz.

The counterpart of ``surface_sampling_tpu/models/convert_nff.py``. The
reference ships trained ensembles as pickled ``nff.nn.models.painn.Painn``
torch modules (tutorials/data/SrTiO3_001/nff/model0*/best_model). The nff
package is not installed, so unpickling fabricates stub Module classes on
the fly: standard torch modules restore their parameter tree through their
``__dict__``, which is all the conversion needs. Torch Linear stores (out,
in); the port's dense layers compute x @ W, so weights are transposed. The
npz written is the scheme of ``models.weights.save_painn_npz``, which both
packages' loaders read:

    python -m surface_sampling_tpu_torch.models.convert_nff <best_model> <out.npz>
"""

from __future__ import annotations

import pickle
from pathlib import Path

import torch


class _StubUnpickler(pickle.Unpickler):
    """Classes of nff, chgnet, catkit and pymatgen become empty
    ``torch.nn.Module`` subclasses of the same name."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("nff", "chgnet", "catkit", "pymatgen"):
            return type(name, (torch.nn.Module,), {"__module__": module})
        return super().find_class(module, name)


class _PickleModule:
    Unpickler = _StubUnpickler

    @staticmethod
    def load(f, **kw):
        return _StubUnpickler(f).load()


def load_nff_painn(path: str | Path):
    """Load an nff PaiNN checkpoint; returns (state_dict of numpy arrays,
    the module's public attributes)."""
    m = torch.load(path, map_location="cpu", weights_only=False, pickle_module=_PickleModule)
    attrs = {k: v for k, v in m.__dict__.items() if not k.startswith("_")}
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    return sd, attrs


def nff_to_params(sd: dict, attrs: dict):
    """Map an nff PaiNN state dict onto the parameter tree (numpy leaves,
    one model; ``models.weights.from_jax_params`` makes the tensors) and
    its ``PaiNNConfig``."""
    from surface_sampling_tpu_torch.models.painn import PaiNNConfig

    def lin(prefix, bias=True):
        p = {"w": sd[f"{prefix}.weight"].T.copy()}
        if bias and f"{prefix}.bias" in sd:
            p["b"] = sd[f"{prefix}.bias"].copy()
        return p

    n_layers = len({k.split(".")[1] for k in sd if k.startswith("message_blocks.")})
    feat = sd["embed_block.atom_embed.weight"].shape[1]
    n_rbf = sd["message_blocks.0.inv_message.dist_embed.block.1.weight"].shape[1]
    readout_hidden = sd["readout_blocks.0.readoutdict.energy.0.weight"].shape[0]

    params = {"atom_embed": sd["embed_block.atom_embed.weight"].copy()}
    params["message"] = [
        {
            "inv_dense0": lin(f"message_blocks.{i}.inv_message.inv_dense.layers.0"),
            "inv_dense1": lin(f"message_blocks.{i}.inv_message.inv_dense.layers.1"),
            "dist_embed": lin(f"message_blocks.{i}.inv_message.dist_embed.block.1"),
        }
        for i in range(n_layers)
    ]
    params["update"] = [
        {
            "u_mat": lin(f"update_blocks.{i}.u_mat", bias=False),
            "v_mat": lin(f"update_blocks.{i}.v_mat", bias=False),
            "s_dense0": lin(f"update_blocks.{i}.s_dense.0"),
            "s_dense1": lin(f"update_blocks.{i}.s_dense.1"),
        }
        for i in range(n_layers)
    ]
    params["readout"] = {
        "dense0": lin("readout_blocks.0.readoutdict.energy.0"),
        "dense1": lin("readout_blocks.0.readoutdict.energy.1"),
    }
    cfg = PaiNNConfig(
        feat_dim=feat,
        n_rbf=n_rbf,
        cutoff=float(attrs.get("cutoff", 5.0)),
        n_layers=n_layers,
        max_z=params["atom_embed"].shape[0],
        excl_vol=bool(attrs.get("excl_vol", False)),
        power=float(attrs.get("power", 12)),
        sigma=float(attrs.get("sigma", 1.5)),
        readout_hidden=readout_hidden,
    )
    return params, cfg


def convert(path_in, path_out) -> None:
    """nff checkpoint -> checkpoint npz (``models.weights.save_painn_npz``)."""
    from surface_sampling_tpu_torch.models.weights import save_painn_npz

    sd, attrs = load_nff_painn(path_in)
    params, cfg = nff_to_params(sd, attrs)
    save_painn_npz(path_out, params, cfg)


if __name__ == "__main__":
    import sys

    convert(sys.argv[1], sys.argv[2])
