"""The port's checkpoint converters (``models/convert_nff.py``,
``convert_chgnet.py``, ``convert_mace.py``) against the JAX package's on
the CPU.

No upstream checkpoint is in the repository, so the state dicts are built
from a seed in the upstream key layout (nff PaiNN, chgnet v0.3.0, the MACE
export naming), pickled the way upstream pickles them where the loader
unpickles, and put through both packages' converters: the trees are equal
leaf by leaf (exact), a port-written npz is read by the JAX package's
loader to the same leaves and configuration, and the MACE round trip,
aliases and refusals of ``tests/test_training.py`` hold, with the
converted MACE's energy equal to the original's (exact).
"""

import sys
import types

import jax
import numpy as np
import pytest
import torch

from surface_sampling_tpu.models import convert_chgnet as jchg
from surface_sampling_tpu.models import convert_mace as jmace
from surface_sampling_tpu.models import convert_nff as jnff
from surface_sampling_tpu_torch.models import convert_chgnet, convert_mace, convert_nff
from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig, init_chgnet
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, init_painn, tree_leaves, tree_map


def _random_tree(tree, seed):
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: rng.normal(size=tuple(x.shape)).astype(np.float32), tree)


def _assert_trees_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (list(a), list(b))
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["w"].T.copy()
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"].copy()


def _nff_state_dict(params) -> dict:
    """An nff PaiNN state dict (torch (out, in) weights) of a port tree."""
    sd = {"embed_block.atom_embed.weight": params["atom_embed"]}
    for i, (m, u) in enumerate(zip(params["message"], params["update"])):
        pre = f"message_blocks.{i}.inv_message"
        _lin(sd, f"{pre}.inv_dense.layers.0", m["inv_dense0"])
        _lin(sd, f"{pre}.inv_dense.layers.1", m["inv_dense1"])
        _lin(sd, f"{pre}.dist_embed.block.1", m["dist_embed"])
        for name in ("u_mat", "v_mat"):
            _lin(sd, f"update_blocks.{i}.{name}", u[name])
        _lin(sd, f"update_blocks.{i}.s_dense.0", u["s_dense0"])
        _lin(sd, f"update_blocks.{i}.s_dense.1", u["s_dense1"])
    _lin(sd, "readout_blocks.0.readoutdict.energy.0", params["readout"]["dense0"])
    _lin(sd, "readout_blocks.0.readoutdict.energy.1", params["readout"]["dense1"])
    return sd


def _chgnet_state_dict(params) -> dict:
    """A chgnet v0.3.0 state dict of a port tree."""
    sd = {"composition_model.fc.weight": params["composition"][None],
          "atom_embedding.embedding.weight": params["atom_embedding"],
          "bond_basis_expansion.rbf_expansion_ag.frequencies": params["rbf_freq_ag"],
          "bond_basis_expansion.rbf_expansion_bg.frequencies": params["rbf_freq_bg"],
          "angle_basis_expansion.fourier_expansion.frequencies": params["angle_freq"]}
    for name in ("bond_embedding", "bond_weights_ag", "bond_weights_bg", "angle_embedding",
                 "site_wise"):
        _lin(sd, name, params[name])

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["g"], p["b"]

    def gated(prefix, g, single=False):
        ln(f"{prefix}.bn1", g["ln_core"])
        ln(f"{prefix}.bn2", g["ln_gate"])
        idx = (1,) if single else (0, 3)
        for j, k in enumerate(idx):
            _lin(sd, f"{prefix}.mlp_core.layers.{k}", g[f"core{j}"])
            _lin(sd, f"{prefix}.mlp_gate.layers.{k}", g[f"gate{j}"])

    for i, c in enumerate(params["atom_convs"]):
        gated(f"atom_conv_layers.{i}.twoBody_atom", c["gmlp"])
        _lin(sd, f"atom_conv_layers.{i}.mlp_out.layers.1", c["out"])
    for i, c in enumerate(params["bond_convs"]):
        gated(f"bond_conv_layers.{i}.twoBody_bond", c["gmlp"])
        _lin(sd, f"bond_conv_layers.{i}.mlp_out.layers.1", c["out"])
    for i, g in enumerate(params["angle_layers"]):
        gated(f"angle_layers.{i}.twoBody_bond", g, single=True)
    ln("readout_norm", params["readout_norm"])
    for j, k in enumerate((0, 2, 4, 7)):
        _lin(sd, f"mlp.layers.{k}", params["mlp"][j])
    return sd


def _module_of(sd: dict, cls_module: str, cls_name: str, attrs: dict) -> torch.nn.Module:
    """A torch module whose state dict is ``sd``, of a class that claims to
    live in ``cls_module`` (an upstream package that is not installed)."""
    cls = type(cls_name, (torch.nn.Module,), {"__module__": cls_module})
    root = cls()
    for key, val in sd.items():
        *path, leaf = key.split(".")
        node = root
        for part in path:
            if part not in node._modules:
                node.add_module(part, torch.nn.Module())
            node = node._modules[part]
        node.register_parameter(leaf, torch.nn.Parameter(torch.as_tensor(val)))
    for k, v in attrs.items():
        setattr(root, k, v)
    return root


def _save_upstream(obj, path, cls_module: str) -> None:
    """torch.save ``obj`` with ``cls_module`` importable only while saving."""
    parts = cls_module.split(".")
    names = [".".join(parts[:i + 1]) for i in range(len(parts))]
    for n in names:
        sys.modules[n] = types.ModuleType(n)
    try:
        for n in names[1:]:
            setattr(sys.modules[n.rsplit(".", 1)[0]], n.rsplit(".", 1)[1], sys.modules[n])
        cls = obj.__class__ if isinstance(obj, torch.nn.Module) else None
        if cls is not None:
            setattr(sys.modules[cls_module], cls.__name__, cls)
        torch.save(obj, path)
    finally:
        for n in names:
            sys.modules.pop(n, None)


@pytest.fixture(scope="module")
def nff_checkpoint():
    cfg = PaiNNConfig(feat_dim=16, n_rbf=8, cutoff=4.5, n_layers=2, max_z=30,
                      readout_hidden=8)
    tree = _random_tree(init_painn(torch.Generator().manual_seed(0), cfg), 1)
    attrs = {"cutoff": 4.5, "excl_vol": True, "power": 10, "sigma": 1.25}
    return tree, cfg, _nff_state_dict(tree), attrs


def test_nff_converter_matches_jax(nff_checkpoint, tmp_path):
    tree, cfg, sd, attrs = nff_checkpoint
    params, pcfg = convert_nff.nff_to_params(sd, attrs)
    jparams, jcfg = jnff.nff_to_params(sd, attrs)
    _assert_trees_equal(params, jparams)
    _assert_trees_equal(params, tree)
    assert pcfg == PaiNNConfig(feat_dim=16, n_rbf=8, cutoff=4.5, n_layers=2, max_z=30,
                               excl_vol=True, power=10.0, sigma=1.25, readout_hidden=8)
    assert {k: getattr(jcfg, k) for k in pcfg.__dict__} == pcfg.__dict__

    # the pickled module through both loaders (stub classes for nff)
    mod = _module_of(sd, "nff.nn.models.painn", "Painn", attrs)
    _save_upstream(mod, tmp_path / "best_model", "nff.nn.models.painn")
    assert "nff" not in sys.modules
    sd2, attrs2 = convert_nff.load_nff_painn(tmp_path / "best_model")
    jsd2, jattrs2 = jnff.load_nff_painn(tmp_path / "best_model")
    assert sorted(sd2) == sorted(jsd2) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(sd2[k], jsd2[k])
    assert {k: attrs2[k] for k in attrs} == {k: jattrs2[k] for k in attrs} == attrs

    # convert -> npz: the JAX package's loader reads it to the same leaves
    convert_nff.convert(tmp_path / "best_model", tmp_path / "painn.npz")
    jnff.convert(tmp_path / "best_model", tmp_path / "painn_jax.npz")
    jtree, jcfg2 = jnff.load_params_npz(tmp_path / "painn.npz")
    _assert_trees_equal(jtree, jnff.load_params_npz(tmp_path / "painn_jax.npz")[0])
    _assert_trees_equal(jtree, tree)
    assert {k: getattr(jcfg2, k) for k in pcfg.__dict__ if k != "max_neighbors"} == \
        {k: v for k, v in pcfg.__dict__.items() if k != "max_neighbors"}


@pytest.fixture(scope="module")
def chgnet_checkpoint():
    cfg = CHGNetConfig(atom_fea_dim=64, num_radial=9, num_angular=9, n_conv=3, max_z=30,
                       mlp_hidden_dims=(32, 16, 8))
    tree = _random_tree(init_chgnet(torch.Generator().manual_seed(0), cfg), 2)
    args = {"n_conv": 3, "atom_fea_dim": 64, "num_radial": 9, "num_angular": 9,
            "atom_graph_cutoff": 5.0, "bond_graph_cutoff": 2.5, "cutoff_coeff": 6,
            "mlp_hidden_dims": "[32, 16, 8]"}
    return tree, _chgnet_state_dict(tree), args


def test_chgnet_converter_matches_jax(chgnet_checkpoint, tmp_path):
    from surface_sampling_tpu_torch.models.weights import load_chgnet_npz

    tree, sd, args = chgnet_checkpoint
    params, cfg = convert_chgnet.chgnet_to_params(sd, args)
    jparams, jcfg = jchg.chgnet_to_params(sd, args)
    _assert_trees_equal(params, jparams)
    _assert_trees_equal(params, tree)
    assert cfg.mlp_hidden_dims == (32, 16, 8) and cfg.n_conv == 3 and cfg.max_z == 30
    assert {k: getattr(jcfg, k) for k in cfg.__dict__} == cfg.__dict__

    # a raw chgnet checkpoint dict, and an nff-wrapped module, as upstream saves them
    torch.save({"model": {"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()},
                          "model_args": args}}, tmp_path / "raw.pth.tar")
    wrapped = _module_of(sd, "chgnet.model.model", "CHGNet", args)
    _save_upstream(wrapped, tmp_path / "best_model", "chgnet.model.model")
    for path in (tmp_path / "raw.pth.tar", tmp_path / "best_model"):
        sd2, args2 = convert_chgnet.load_chgnet_checkpoint(path)
        jsd2, jargs2 = jchg.load_chgnet_checkpoint(path)
        assert sorted(sd2) == sorted(jsd2) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(sd2[k], jsd2[k])
        assert {k: args2[k] for k in args} == {k: jargs2[k] for k in args} == args
        convert_chgnet.convert(path, tmp_path / "chg.npz")
        jtree, jcfg2 = jchg.load_chgnet_npz(tmp_path / "chg.npz")
        _assert_trees_equal(jtree, tree)
        assert {k: getattr(jcfg2, k) for k in cfg.__dict__} == cfg.__dict__
        ptree, pcfg = load_chgnet_npz(tmp_path / "chg.npz")
        _assert_trees_equal(ptree, tree)
        assert pcfg == cfg


@pytest.mark.parametrize("eq", [False, True])
def test_mace_converter_matches_jax(eq, tmp_path):
    """Round trip, npz and .pt loading, official aliases, refusals (the
    cases of tests/test_training.py), each against the JAX converter."""
    from surface_sampling_tpu.models.mace import MACEConfig as JMACEConfig
    from surface_sampling_tpu.models.mace import init_mace as j_init_mace
    from surface_sampling_tpu_torch.models.mace import MACEConfig, mace_apply
    from surface_sampling_tpu_torch.models.weights import from_jax_params
    from surface_sampling_tpu_torch.ops.neighbors import image_search_edges

    kw = dict(feat_dim=8, n_rbf=4, cutoff=4.0, n_layers=2, max_neighbors=8, l_max=2,
              equivariant_messages=eq)
    cfg = MACEConfig(**kw)
    jtree = jax.tree.map(np.asarray, j_init_mace(jax.random.PRNGKey(7), JMACEConfig(**kw)))
    sd = convert_mace.export_mace_state_dict(from_jax_params(jtree, "cpu"))
    jsd = jmace.export_mace_state_dict(jtree)
    assert list(sd) == list(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    assert sd["layers.0.rad0.weight"].shape == (8, 4)

    params2, cfg2 = convert_mace.convert_mace_state_dict(sd)
    jparams2, jcfg2 = jmace.convert_mace_state_dict(jsd)
    assert (cfg2.feat_dim, cfg2.n_rbf, cfg2.n_layers, cfg2.l_max,
            cfg2.equivariant_messages) == (8, 4, 2, 2, eq)
    assert {k: getattr(jcfg2, k) for k in cfg2.__dict__} == cfg2.__dict__
    _assert_trees_equal(params2, jparams2)
    _assert_trees_equal(params2, jtree)

    # the same energy through the converted parameters
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(0, 4, (1, 6, 3)), dtype=torch.float32)
    nums = torch.full((1, 6), 29)
    alive = torch.ones(1, 6, dtype=torch.bool)
    edges = image_search_edges(pos, alive, torch.zeros(1, 3), cfg.cutoff, cfg.max_neighbors)
    e1 = mace_apply(from_jax_params(jtree, "cpu"), cfg, pos, nums, alive, edges=edges)["energy"]
    e2 = mace_apply(from_jax_params(params2, "cpu"), cfg, pos, nums, alive, edges=edges)["energy"]
    assert torch.equal(e1, e2)

    # npz and torch .pt loading paths
    np.savez(tmp_path / "sd.npz", **sd)
    _assert_trees_equal(convert_mace.load_mace_state_dict(tmp_path / "sd.npz", cfg)[0], jtree)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "sd.pt")
    _assert_trees_equal(convert_mace.load_mace_state_dict(tmp_path / "sd.pt", cfg)[0], jtree)
    _assert_trees_equal(jmace.load_mace_state_dict(tmp_path / "sd.pt", JMACEConfig(**kw))[0],
                        jtree)

    # official mace-package alias names for the 1:1 pieces
    sd_alias = dict(sd)
    sd_alias["node_embedding.linear.weight"] = sd_alias.pop("atom_embed")
    sd_alias["atomic_energies_fn.atomic_energies"] = sd_alias.pop("atom_ref")
    for t in range(cfg.n_layers):
        sd_alias[f"readouts.{t}.linear.weight"] = sd_alias.pop(f"layers.{t}.readout.weight")
        sd_alias[f"readouts.{t}.linear.bias"] = sd_alias.pop(f"layers.{t}.readout.bias")
    _assert_trees_equal(convert_mace.convert_mace_state_dict(sd_alias, cfg)[0], jtree)

    # foreign keys are refused, missing keys and wrong shapes raise
    sd_bad = dict(sd)
    sd_bad["interactions.0.conv_tp.weight"] = np.zeros((2, 2))
    with pytest.raises(ValueError, match="no counterpart"):
        convert_mace.convert_mace_state_dict(sd_bad, cfg)
    with pytest.raises(ValueError, match="no counterpart"):
        jmace.convert_mace_state_dict(sd_bad, JMACEConfig(**kw))
    assert len(tree_leaves(convert_mace.convert_mace_state_dict(sd_bad, cfg,
                                                                strict=False)[0])) == \
        len(tree_leaves(jtree))
    sd_missing = dict(sd)
    sd_missing.pop("layers.1.w0.weight")
    with pytest.raises(KeyError, match="layers.1.w0.weight"):
        convert_mace.convert_mace_state_dict(sd_missing, cfg)
    sd_shape = dict(sd)
    sd_shape["layers.0.w0.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        convert_mace.convert_mace_state_dict(sd_shape, cfg)
