"""Weight carry-over: the port's npz loader and ``from_jax_params`` on the
JAX package's own loaded and stacked parameters give identical tensors,
and the same configuration."""

import dataclasses

import jax
import numpy as np
import torch

from surface_sampling_tpu.models.convert_nff import load_params_npz
from surface_sampling_tpu.models.ensemble import stack_params
from surface_sampling_tpu_torch.models.painn import tree_map
from surface_sampling_tpu_torch.models.weights import from_jax_params, load_painn_ensemble
from surface_sampling_tpu_torch.systems import MODEL_DATA

PATHS = [MODEL_DATA / f"srtio3_painn_{i:02d}.npz" for i in range(1, 4)]


def test_npz_loader_matches_from_jax_params():
    loaded, cfg = load_painn_ensemble(PATHS, "cpu")
    jlist, jcfg = zip(*(load_params_npz(p) for p in PATHS))
    carried = from_jax_params(jax.tree.map(np.asarray, stack_params(list(jlist))), "cpu")

    leaves = []

    def same(a, b):
        assert a.dtype == b.dtype == torch.float32 and a.shape[0] == 3
        assert torch.equal(a, b)
        leaves.append(a)

    tree_map(same, loaded, carried)
    assert len(leaves) == 1 + 3 * 6 + 3 * 6 + 4       # embed, message, update, readout
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg[0], f.name), f.name
    assert cfg.max_neighbors == 64                       # checkpoint's 48 dropped
    assert cfg.excl_vol and cfg.n_rbf == 20 and cfg.feat_dim == 128
