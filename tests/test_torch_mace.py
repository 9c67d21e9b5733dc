"""The port's MACE family (``models/mace.py``) against the JAX package on
the CPU: the analogs of ``tests/test_training.py``'s MACE tests, without
training and the converter.

Inputs are made from a seed with numpy; JAX parameters are carried across
(``from_jax_params``). ``mace_apply`` against JAX for l_max 1 / 2 / 3 with
and without equivariant messages (JAX in its "gather" mode) and against
JAX's "dense" mode: energy rtol 1e-5 / atol 1e-5, per-atom energies and
forces atol 1e-5 (f32 sums in another order). The invariance limits are
tighter than the JAX tests' (2e-3 eV, 5e-3 eV/A): 1e-5 eV and 1e-5 eV/A,
f32 rounding of a rotated input, beside forces of 1e-3 eV/A and more at
the initial weights. The static table against the image search: the JAX
test's rtol 1e-6 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.models import mace as jmace
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import EngineConfig, MCMCRun
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import (
    device_spec,
    realize_alive,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models import MACEConfig, init_mace, mace_apply, make_mace_potential
from surface_sampling_tpu_torch.models.mace import _y3_tensor, load_mace_npz, save_mace_npz
from surface_sampling_tpu_torch.models.painn import tree_leaves, tree_map
from surface_sampling_tpu_torch.models.weights import from_jax_params
from surface_sampling_tpu_torch.models.weights import load_mace_npz as weights_load_mace_npz
from surface_sampling_tpu_torch.structure.sites import find_adsorption_sites
from surface_sampling_tpu_torch.structure.slabs import fcc100

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(feat_dim=12, n_rbf=5, cutoff=5.0, n_layers=2, max_neighbors=12, readout_hidden=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg) -> MACEConfig:
    return MACEConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(MACEConfig)})


def _carry(jparams) -> dict:
    return from_jax_params(jax.tree.map(np.asarray, jparams), CPU)


@pytest.fixture(scope="module")
def cluster():
    """The structure of the JAX package's dense-routing test: 14 atoms in a
    7.5 A cell, some dead, image shifts along two axes."""
    rng = np.random.default_rng(4)
    n = 14
    cell = np.eye(3) * 7.5
    pos = rng.uniform(1.0, 6.5, (n, 3)).astype(np.float32)
    nums = rng.integers(1, 30, n).astype(np.int32)
    alive = rng.uniform(size=n) > 0.15
    shifts = np.concatenate([np.zeros((1, 3))] + [cell[None, i] * s for i in range(2)
                                                  for s in (1, -1)]).astype(np.float32)
    return pos, nums, alive, shifts


def _port(params, cfg, pos, nums, alive, shifts):
    """Energy, per-atom energies and forces of one structure."""
    p = torch.as_tensor(pos)[None].requires_grad_(True)
    out = mace_apply(params, cfg, p, torch.as_tensor(nums, dtype=torch.int64)[None],
                     torch.as_tensor(alive)[None], torch.as_tensor(shifts))
    (g,) = torch.autograd.grad(out["energy"].sum(), p)
    return (float(out["energy"][0].detach()), out["per_atom_energy"][0].detach().numpy(),
            -g[0].numpy())


def _jax(jparams, jcfg, pos, nums, alive, shifts):
    def e_of(p):
        out = jmace.mace_apply(jparams, jcfg, p, jnp.asarray(nums), jnp.asarray(alive),
                               jnp.asarray(shifts))
        return out["energy"], out["per_atom_energy"]

    (e, pa), g = jax.value_and_grad(e_of, has_aux=True)(jnp.asarray(pos))
    return float(e), np.asarray(pa), -np.asarray(g)


@pytest.mark.parametrize("l_max,eq,mode", [
    (1, False, "gather"), (1, True, "gather"), (2, False, "gather"), (2, True, "gather"),
    (3, False, "gather"), (3, True, "gather"), (3, True, "dense")])
def test_mace_apply_matches_jax(cluster, l_max, eq, mode):
    """Carried-across parameters: energy, per-atom energies and forces
    against JAX's "gather" mode, and against its "dense" mode in the
    fullest configuration (the one-hot routing selects rows, so it is the
    port's gather too)."""
    jcfg = jmace.MACEConfig(**SMALL, l_max=l_max, equivariant_messages=eq, message_mode=mode)
    jparams = jmace.init_mace(jax.random.PRNGKey(7 + l_max), jcfg)
    je, jpa, jf = _jax(jparams, jcfg, *cluster)
    e, pa, f = _port(_carry(jparams), _tcfg(jcfg), *cluster)
    np.testing.assert_allclose(e, je, **TOL)
    np.testing.assert_allclose(pa, jpa, rtol=0, atol=TOL["atol"])
    np.testing.assert_allclose(f, jf, rtol=0, atol=TOL["atol"])
    assert np.abs(jf).max() > 1e-3


def _rotation(a, b):
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    rx = np.array([[1.0, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    return (rx @ rz).astype(np.float32)


@pytest.mark.parametrize("l_max,eq", [(2, True), (3, False)])
def test_rotation_and_mirror_invariance(l_max, eq):
    """An open cluster: the energy is unchanged by a general rotation and a
    mirror (every contraction is parity-even) and forces rotate with it."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.0, 3.5, (7, 3)).astype(np.float32)
    nums = rng.integers(1, 30, 7).astype(np.int32)
    alive = np.ones(7, bool)
    shifts = np.zeros((1, 3), np.float32)
    cfg = MACEConfig(**{**SMALL, "cutoff": 6.0}, l_max=l_max, equivariant_messages=eq)
    params = init_mace(torch.Generator().manual_seed(5), cfg)
    e0, _, f0 = _port(params, cfg, pos, nums, alive, shifts)
    rot = _rotation(0.7, 1.1)
    e_r, _, f_r = _port(params, cfg, pos @ rot.T, nums, alive, shifts)
    e_m, _, _ = _port(params, cfg, pos * np.float32([-1.0, 1.0, 1.0]), nums, alive, shifts)
    assert abs(e0 - e_r) < 1e-5 and abs(e0 - e_m) < 1e-5, (e0, e_r, e_m)
    np.testing.assert_allclose(f_r, f0 @ rot.T, rtol=0, atol=1e-5)
    assert np.abs(f0).max() > 1e-3


def test_l3_liveness_and_traceless_y3():
    """Boosting the l = 3 projection changes the energy; Y3 is traceless
    on every index pair."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.0, 5.0, (6, 3)).astype(np.float32)
    args = (np.full(6, 18, np.int32), np.ones(6, bool), np.zeros((1, 3), np.float32))
    cfg = MACEConfig(**{**SMALL, "cutoff": 6.0}, l_max=3)
    params = init_mace(torch.Generator().manual_seed(3), cfg)
    e0 = _port(params, cfg, pos, *args)[0]
    boost = tree_map(lambda x: x, params)
    for layer in boost["layers"]:
        layer["w3"] = {"w": 10.0 * layer["w3"]["w"]}
    assert abs(e0 - _port(boost, cfg, pos, *args)[0]) > 1e-5, "l=3 path is dead"
    u = torch.as_tensor(rng.normal(size=(7, 3)), dtype=torch.float32)
    y3 = _y3_tensor(u / u.norm(dim=-1, keepdim=True))
    for eq in ("naab->nb", "naba->nb", "nbaa->nb"):
        assert float(torch.einsum(eq, y3).abs().max()) < 1e-6


@pytest.fixture(scope="module")
def cu_spec():
    slab = fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=10.0)
    sites = find_adsorption_sites(slab, planar_distance=1.8)["all"]
    return make_spec(slab, sites, ["Cu"], potential_numbers=[29], cutoff=5.0,
                     surface_name="cu_mace")


def test_static_table_matches_image_search(cu_spec):
    """make_mace_potential over the spec's static table against image
    search on realized slot geometries; the rebuild hook."""
    cfg = MACEConfig(feat_dim=16, n_rbf=6, cutoff=5.0, n_layers=2, max_neighbors=24)
    params = init_mace(torch.Generator().manual_seed(2), cfg)
    tbl = build_static_neighbor_table(cu_spec, cfg.cutoff, relax_slack=0.05)
    pot_dyn = make_mace_potential(params, cfg, [29])
    pot_tbl = make_mace_potential(**pot_dyn.mace_args, static_nbr=tbl)
    assert set(pot_dyn.mace_args) == {"params", "cfg", "type_numbers", "units"}
    assert not hasattr(pot_tbl, "mace_args") and hasattr(pot_tbl, "edge_topology")
    assert not hasattr(pot_dyn, "edge_topology")
    d = device_spec(cu_spec, CPU)
    ss = torch.as_tensor(np.random.default_rng(0).integers(0, 2, (3, cu_spec.n_sites)))
    pos, ti, alive = realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss)
    np.testing.assert_allclose(pot_tbl.energy(pos, ti, alive).numpy(),
                               pot_dyn.energy(pos, ti, alive, d.shifts).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_npz_round_trips_both_ways(tmp_path, cluster):
    """The JAX package writes, the port reads (same tree, configuration and
    energy), and back."""
    jcfg = jmace.MACEConfig(**SMALL, l_max=2, equivariant_messages=True, message_mode="gather")
    jparams = jmace.init_mace(jax.random.PRNGKey(1), jcfg)
    jmace.save_mace_npz(tmp_path / "jax.npz", jparams, jcfg)
    tree, cfg = load_mace_npz(tmp_path / "jax.npz")
    assert cfg == _tcfg(jcfg) and weights_load_mace_npz(tmp_path / "jax.npz")[1] == cfg
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    params = from_jax_params(tree, CPU)
    np.testing.assert_allclose(_port(params, cfg, *cluster)[0], _jax(jparams, jcfg, *cluster)[0],
                               **TOL)

    save_mace_npz(tmp_path / "port.npz", params, cfg)
    jtree, jcfg2 = jmace.load_mace_npz(tmp_path / "port.npz")
    assert jcfg2 == jcfg
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_mace_potential_mc_smoke(cu_spec):
    """A MACE potential by image search drives rigid and FIRE-relaxed
    semigrand runs (MCMCRun) to finite energies."""
    cfg = MACEConfig(feat_dim=8, n_rbf=4, cutoff=4.0, n_layers=1, max_neighbors=16)
    pot = make_mace_potential(init_mace(torch.Generator().manual_seed(1), cfg), cfg, [29])
    ecfg = EngineConfig(sweep_size=3, record_positions=False)
    for relax in (None, RelaxConfig(steps=3)):
        run = MCMCRun(cu_spec, pot, device=CPU, relax=relax)
        state, rec = run.run(0, np.ones(1), cfg=ecfg, n_chains=2)
        assert torch.isfinite(rec.energy).all() and rec.energy.shape == (2, 1)


def test_forces_repeat_bitwise(cluster):
    """Two force evaluations give the same bits (the neighbour gather's
    backward is a fixed-order sum)."""
    cfg = MACEConfig(**SMALL, l_max=2, equivariant_messages=True)
    params = init_mace(torch.Generator().manual_seed(9), cfg)
    f1 = _port(params, cfg, *cluster)[2]
    f2 = _port(params, cfg, *cluster)[2]
    assert np.array_equal(f1, f2)
    assert len(tree_leaves(params)) == len(jax.tree.leaves(jmace.init_mace(
        jax.random.PRNGKey(0), jmace.MACEConfig(**SMALL, l_max=2, equivariant_messages=True))))
