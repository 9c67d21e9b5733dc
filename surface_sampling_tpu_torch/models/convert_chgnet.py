"""Convert chgnet v0.3.0 torch checkpoints to the port's CHGNet parameter
tree and checkpoint npz.

The counterpart of ``surface_sampling_tpu/models/convert_chgnet.py``. Loads
either a raw chgnet checkpoint dict ({"model": {"state_dict",
"model_args"}}) or an nff-wrapped one (the reference's LaMnO3 fine-tuned
best_model), without the chgnet package installed (the stub unpickling of
``models.convert_nff``). Torch Linear weights (out, in) transpose to x @ W.
The npz written is the scheme of ``models.weights.save_chgnet_npz``, which
both packages' ``load_chgnet_npz`` read:

    python -m surface_sampling_tpu_torch.models.convert_chgnet <best_model> <out.npz>
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import torch

from surface_sampling_tpu_torch.models.convert_nff import _PickleModule


def load_chgnet_checkpoint(path: str | Path):
    """(state dict of numpy arrays, model arguments) of a chgnet checkpoint."""
    m = torch.load(path, map_location="cpu", weights_only=False, pickle_module=_PickleModule)
    if isinstance(m, dict) and "model" in m:
        inner = m["model"]
        sd = {k: np.asarray(v) for k, v in inner["state_dict"].items()}
        args = dict(inner.get("model_args", {}))
    else:  # a bare module
        sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
        args = {k: v for k, v in m.__dict__.items() if not k.startswith("_")}
    return sd, args


def chgnet_to_params(sd: dict, args: dict):
    """Map a chgnet state dict onto the parameter tree (numpy leaves) and
    its ``CHGNetConfig``."""
    from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig

    def lin(prefix, bias=True):
        p = {"w": sd[f"{prefix}.weight"].T.copy()}
        if bias and f"{prefix}.bias" in sd:
            p["b"] = sd[f"{prefix}.bias"].copy()
        return p

    def ln(prefix):
        return {"g": sd[f"{prefix}.weight"].copy(), "b": sd[f"{prefix}.bias"].copy()}

    def gated(prefix, core_idx=(0, 3), single=False):
        out = {"ln_core": ln(f"{prefix}.bn1"), "ln_gate": ln(f"{prefix}.bn2")}
        if single:
            out["core0"] = lin(f"{prefix}.mlp_core.layers.1")
            out["gate0"] = lin(f"{prefix}.mlp_gate.layers.1")
        else:
            out["core0"] = lin(f"{prefix}.mlp_core.layers.{core_idx[0]}")
            out["core1"] = lin(f"{prefix}.mlp_core.layers.{core_idx[1]}")
            out["gate0"] = lin(f"{prefix}.mlp_gate.layers.{core_idx[0]}")
            out["gate1"] = lin(f"{prefix}.mlp_gate.layers.{core_idx[1]}")
        return out

    n_conv = int(args.get("n_conv", 4))
    params = {
        "composition": sd["composition_model.fc.weight"].reshape(-1).copy(),
        "atom_embedding": sd["atom_embedding.embedding.weight"].copy(),
        "rbf_freq_ag": sd["bond_basis_expansion.rbf_expansion_ag.frequencies"].copy(),
        "rbf_freq_bg": sd["bond_basis_expansion.rbf_expansion_bg.frequencies"].copy(),
        "angle_freq": sd["angle_basis_expansion.fourier_expansion.frequencies"].copy(),
        "bond_embedding": lin("bond_embedding", bias=False),
        "bond_weights_ag": lin("bond_weights_ag", bias=False),
        "bond_weights_bg": lin("bond_weights_bg", bias=False),
        "angle_embedding": lin("angle_embedding", bias=False),
        "atom_convs": [
            {
                "gmlp": gated(f"atom_conv_layers.{i}.twoBody_atom"),
                "out": lin(f"atom_conv_layers.{i}.mlp_out.layers.1", bias=False),
            }
            for i in range(n_conv)
        ],
        "bond_convs": [
            {
                "gmlp": gated(f"bond_conv_layers.{i}.twoBody_bond"),
                "out": lin(f"bond_conv_layers.{i}.mlp_out.layers.1", bias=False),
            }
            for i in range(n_conv - 1)
        ],
        "angle_layers": [
            gated(f"angle_layers.{i}.twoBody_bond", single=True) for i in range(n_conv - 1)
        ],
        "site_wise": lin("site_wise"),
        "readout_norm": ln("readout_norm"),
        "mlp": [lin("mlp.layers.0"), lin("mlp.layers.2"), lin("mlp.layers.4"),
                lin("mlp.layers.7")],
    }
    hidden = args.get("mlp_hidden_dims", (64, 64, 64))
    if isinstance(hidden, str):        # serialized as "[64, 64, 64]"
        hidden = ast.literal_eval(hidden)
    cfg = CHGNetConfig(
        atom_fea_dim=int(args.get("atom_fea_dim", 64)),
        num_radial=int(args.get("num_radial", 31)),
        num_angular=int(args.get("num_angular", 31)),
        n_conv=n_conv,
        atom_graph_cutoff=float(args.get("atom_graph_cutoff", 6.0)),
        bond_graph_cutoff=float(args.get("bond_graph_cutoff", 3.0)),
        cutoff_coeff=int(args.get("cutoff_coeff", 8)),
        max_z=sd["atom_embedding.embedding.weight"].shape[0],
        mlp_hidden_dims=tuple(hidden),
    )
    return params, cfg


def convert(path_in, path_out) -> None:
    """chgnet checkpoint -> checkpoint npz (``models.weights.save_chgnet_npz``)."""
    from surface_sampling_tpu_torch.models.weights import save_chgnet_npz

    sd, args = load_chgnet_checkpoint(path_in)
    params, cfg = chgnet_to_params(sd, args)
    save_chgnet_npz(path_out, params, cfg)


if __name__ == "__main__":
    import sys

    convert(sys.argv[1], sys.argv[2])
