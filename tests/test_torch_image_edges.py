"""The image-search edge path of the port's PaiNN and CHGNet potentials
(``static_nbr=None``), its rebuild hooks, the ``ensemble=`` argument, the
code-dependent slot geometry of ``make_painn_potential``,
``ensemble_forces_std`` and the random initialisers, against the JAX
package on the CPU.

Inputs are made from a seed with numpy; JAX parameters are carried across
(``from_jax_params``). Tolerances:

* image search against the JAX potentials built with ``static_nbr=None``
  on the same positions: 1e-4 eV in energy, 1e-4 eV/A in forces (the same
  edges; f32 sums in another order);
* image search against the port's static-table path: 5e-3 eV, the JAX
  package's rule for its two edge modes (``static_edges.py:23-26``);
* a code-dependent spec (LaMnO3(001), OH and H2O groups) against JAX's
  potential with its table: 1e-4 eV.

The JAX references run under one small jit each, on one torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu import systems as jsystems
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.models import chgnet as jchgnet
from surface_sampling_tpu.models import ensemble as jensemble
from surface_sampling_tpu.models import painn as jpainn
from surface_sampling_tpu.models import train as jtrain
from surface_sampling_tpu.models.nn_calculator import (
    make_chgnet_potential as j_make_chgnet_potential,
)
from surface_sampling_tpu.models.nn_calculator import make_painn_potential as j_make_painn_potential
from surface_sampling_tpu.ops.neighbors import pair_shifts
from surface_sampling_tpu_torch.core.energy import RelaxConfig, relax_settings
from surface_sampling_tpu_torch.core.state import (
    device_spec,
    realize_alive,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.models import (
    CHGNetConfig,
    PaiNNConfig,
    ensemble_forces_std,
    init_chgnet,
    make_chgnet_potential,
    make_painn_potential,
    stack_params,
)
from surface_sampling_tpu_torch.models.painn import tree_leaves, tree_map
from surface_sampling_tpu_torch.models.train import init_ensemble, train_model, train_painn
from surface_sampling_tpu_torch.models.weights import from_jax_params
from surface_sampling_tpu_torch.systems import lamno3_001_chgnet

CPU = torch.device("cpu")
E_TOL = 1e-4          # eV, image search: port vs JAX
F_TOL = 1e-4          # eV/A
MODE_TOL = 5e-3       # eV, image search vs static table
PAINN = dict(feat_dim=16, n_rbf=8, cutoff=4.0, n_layers=2, readout_hidden=8, max_neighbors=32)
CHGNET = dict(atom_fea_dim=16, num_radial=9, num_angular=9, n_conv=2, max_neighbors=48,
              max_bond_neighbors=8, mlp_hidden_dims=(16, 16, 16))
TYPES = [8, 22, 38, 1]
SCALE = 2.0           # PaiNN weights x 2: forces ~1.6 eV/A on the frames


def _painn_init(seed, jcfg):
    return jax.tree.map(lambda x: SCALE * x, jpainn.init_painn(jax.random.PRNGKey(seed), jcfg))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def frames():
    """Two periodic frames of 12 atoms in a 7 x 7.5 x 8 A box (two dead),
    their types and the box's image shifts at 4 A."""
    rng = np.random.default_rng(0)
    box = np.diag([7.0, 7.5, 8.0])
    pos = (rng.uniform(0, 1, (2, 12, 3)) @ box).astype(np.float32)
    type_idx = rng.integers(0, len(TYPES), (2, 12))
    alive = np.ones((2, 12), bool)
    alive[0, 3] = alive[1, 7] = False
    return pos, type_idx, alive, pair_shifts(box, 4.0).astype(np.float32)


def _jax_energy_forces(pot, pos, type_idx, alive, shifts):
    fn = jax.jit(jax.vmap(lambda p, t, a: pot.energy_and_forces(p, t, a, jnp.asarray(shifts))))
    e, f = fn(jnp.asarray(pos), jnp.asarray(type_idx), jnp.asarray(alive))
    return np.asarray(e), np.asarray(f)


def _port_energy_forces(pot, pos, type_idx, alive, shifts):
    e, f = pot.energy_and_forces(torch.as_tensor(pos), torch.as_tensor(type_idx),
                                 torch.as_tensor(alive), torch.as_tensor(shifts))
    return e.numpy(), f.numpy()


@pytest.mark.parametrize("ensemble", [False, True])
def test_painn_image_search_matches_jax(frames, ensemble):
    """make_painn_potential(static_nbr=None) against JAX's on the same
    positions: one model (ensemble=False) and a stacked pair of members;
    energies and forces, the rebuild hook and no topology hook."""
    jcfg = jpainn.PaiNNConfig(**PAINN)
    if ensemble:
        jparams = jensemble.stack_params([_painn_init(s, jcfg) for s in (0, 1)])
    else:
        jparams = _painn_init(0, jcfg)
    stoidict = {"O": -0.5, "Ti": -1.0, "H": -0.2, "offset": 0.1}
    jpot = j_make_painn_potential(jparams, jcfg, TYPES, units="eV", ensemble=ensemble,
                                  stoidict=stoidict)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), CPU)
    cfg = _tcfg(PaiNNConfig, jcfg)
    pot = make_painn_potential(params, cfg, TYPES, units="eV", stoidict=stoidict,
                               ensemble=ensemble)
    je, jf = _jax_energy_forces(jpot, *frames)
    e, f = _port_energy_forces(pot, *frames)
    np.testing.assert_allclose(e, je, rtol=0, atol=E_TOL)
    np.testing.assert_allclose(f, jf, rtol=0, atol=F_TOL)
    assert np.abs(jf).max() > 0.5
    assert set(pot.painn_args) == set(jpot.painn_args)
    assert pot.painn_args["ensemble"] is ensemble and pot.painn_args["params"] is params
    for hook in ("edge_topology", "edges_of", "energy_with_edges", "rigid_energy"):
        assert not hasattr(pot, hook) and not hasattr(jpot, hook)
    assert relax_settings(RelaxConfig(), pot)[1] is False     # edges refreshed every call


def test_ensemble_false_equals_one_member_stack(frames):
    """ensemble=False takes one model's tree and stacks it to K = 1: the
    same energies, bitwise, as the stacked tree."""
    params = tree_map(lambda x: x[0], from_jax_params(jax.tree.map(
        np.asarray, jensemble.stack_params([jpainn.init_painn(jax.random.PRNGKey(3),
                                                              jpainn.PaiNNConfig(**PAINN))])),
        CPU))
    cfg = PaiNNConfig(**PAINN)
    one = make_painn_potential(params, cfg, TYPES, units="eV", ensemble=False)
    stacked = make_painn_potential(stack_params([params]), cfg, TYPES, units="eV")
    e1, f1 = _port_energy_forces(one, *frames)
    e2, f2 = _port_energy_forces(stacked, *frames)
    assert np.array_equal(e1, e2) and np.array_equal(f1, f2)
    with pytest.raises(ValueError, match="ensemble=True"):
        make_painn_potential(params, cfg, TYPES, ensemble=True)


def test_chgnet_image_search_matches_jax(frames):
    """make_chgnet_potential(static_nbr=None) with a JAX-initialised tree
    carried across against JAX's (gather conv): energies and forces, the
    rebuild hook."""
    jcfg = jchgnet.CHGNetConfig(**CHGNET, conv_mode="gather")
    jparams = jchgnet.init_chgnet(jax.random.PRNGKey(2), jcfg)
    jpot = j_make_chgnet_potential(jparams, jcfg, TYPES)
    cfg = _tcfg(CHGNetConfig, jcfg)
    pot = make_chgnet_potential(from_jax_params(jax.tree.map(np.asarray, jparams), CPU), cfg,
                                TYPES)
    je, jf = _jax_energy_forces(jpot, *frames)
    e, f = _port_energy_forces(pot, *frames)
    np.testing.assert_allclose(e, je, rtol=0, atol=E_TOL)
    np.testing.assert_allclose(f, jf, rtol=0, atol=F_TOL)
    assert set(pot.chgnet_args) == set(jpot.chgnet_args)
    assert not hasattr(pot, "edge_topology") and relax_settings(RelaxConfig(), pot)[1] is False


# ----------------------------------------------------------------------
# LaMnO3(001): code-dependent slot geometry, image search vs the table
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def lamno3():
    """The port's LaMnO3(001) system (spec and static table) and states:
    the pristine slab and two with O / OH / H2O on a few sites."""
    sys_ = lamno3_001_chgnet(device=CPU)
    rng = np.random.default_rng(5)
    S = sys_.spec.n_sites
    ss = np.zeros((3, S), np.int64)
    for c in (1, 2):
        sites = rng.choice(S, 4, replace=False)
        ss[c, sites] = rng.integers(1, sys_.spec.n_codes, 4)
    d = device_spec(sys_.spec, CPU)
    st = torch.as_tensor(ss)
    return sys_, d, (realize_positions(d, st), realize_type_idx(d, st), realize_alive(d, st))


def _lamno3_painn(seed):
    jcfg = jpainn.PaiNNConfig(**{**PAINN, "cutoff": 5.0, "max_neighbors": 64})
    jparams = _painn_init(seed, jcfg)
    return jcfg, jparams, stack_params([from_jax_params(jax.tree.map(np.asarray, jparams), CPU)])


def test_code_dependent_spec_scores_through_energy(lamno3):
    """A spec with mixed-offset adsorbate groups has no rigid static-edge
    path: make_painn_potential leaves out rigid_energy and scores through
    energy(), as the JAX package does, with JAX's energies on the same
    states; the state evaluation of an MC run takes that path."""
    sys_, d, (pos, type_idx, alive) = lamno3
    jcfg, jparams, params = _lamno3_painn(4)
    types = [57, 25, 8, 1]
    pot = make_painn_potential(params, _tcfg(PaiNNConfig, jcfg), types, units="eV",
                               static_nbr=sys_.static_nbr, spec=sys_.spec, device=CPU)
    assert not hasattr(pot, "rigid_energy") and hasattr(pot, "edge_topology")
    jspec = jsystems.lamno3_001_chgnet().spec
    jpot = j_make_painn_potential(jparams, jcfg, types, units="eV",
                                  static_nbr=j_build_table(jspec, 6.0, relax_slack=0.1),
                                  spec=jspec)
    assert not hasattr(jpot, "rigid_energy")
    je = jax.jit(jax.vmap(lambda p, t, a: jpot.energy(p, t, a, jnp.asarray(jspec.shifts))))(
        jnp.asarray(pos.numpy()), jnp.asarray(type_idx.numpy()), jnp.asarray(alive.numpy()))
    e = pot.energy(pos, type_idx, alive)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0, atol=E_TOL)
    from surface_sampling_tpu_torch.core.energy import make_state_energy_fn

    state_e = make_state_energy_fn(d, pot)(torch.zeros((1, sys_.spec.n_sites), dtype=torch.int64))
    np.testing.assert_allclose(state_e.potential_energy.numpy(), e[:1].numpy(), rtol=1e-6)


def test_image_search_matches_static_table(lamno3):
    """PaiNN and CHGNet by image search over the spec's shifts against the
    same models over the static table, within the JAX package's rule for
    its two edge modes; the PaiNN rebuild hook gives the table potential."""
    sys_, d, (pos, type_idx, alive) = lamno3
    jcfg, _, params = _lamno3_painn(6)
    cfg = _tcfg(PaiNNConfig, jcfg)
    types = [57, 25, 8, 1]
    image = make_painn_potential(params, cfg, types, units="eV")
    rebuilt = make_painn_potential(**image.painn_args, static_nbr=sys_.static_nbr,
                                   spec=sys_.spec)
    e_img = image.energy(pos, type_idx, alive, d.shifts)
    e_tab = rebuilt.energy(pos, type_idx, alive)
    assert not bool(torch.isnan(e_img).any()) and float(e_img.abs().max()) < 1e5
    np.testing.assert_allclose(e_img.numpy(), e_tab.numpy(), rtol=0, atol=MODE_TOL)

    ccfg = CHGNetConfig(**{**CHGNET, "max_neighbors": 96, "max_bond_neighbors": 12})
    cparams = init_chgnet(torch.Generator().manual_seed(1), ccfg)
    cimage = make_chgnet_potential(cparams, ccfg, types)
    ctab = make_chgnet_potential(**cimage.chgnet_args, static_nbr=sys_.static_nbr)
    c_img = cimage.energy(pos, type_idx, alive, d.shifts)
    c_tab = ctab.energy(pos, type_idx, alive)
    assert float(c_img.abs().max()) < 1e5
    np.testing.assert_allclose(c_img.numpy(), c_tab.numpy(), rtol=0, atol=MODE_TOL)


# ----------------------------------------------------------------------
# ensemble_forces_std and the initialisers
# ----------------------------------------------------------------------
def test_ensemble_forces_std_matches_jax(frames):
    pos, type_idx, alive, shifts = frames
    jcfg = jpainn.PaiNNConfig(**PAINN)
    jparams = jensemble.stack_params([_painn_init(s, jcfg) for s in (7, 8, 9)])
    numbers = np.asarray(TYPES)[type_idx] * alive
    fn = jax.jit(jax.vmap(lambda p, n, a: jensemble.ensemble_forces_std(
        jparams, jcfg, p, n, a, jnp.asarray(shifts))))
    want = np.asarray(fn(jnp.asarray(pos), jnp.asarray(numbers), jnp.asarray(alive)))
    got = ensemble_forces_std(from_jax_params(jax.tree.map(np.asarray, jparams), CPU),
                              _tcfg(PaiNNConfig, jcfg), torch.as_tensor(pos),
                              torch.as_tensor(numbers), torch.as_tensor(alive),
                              torch.as_tensor(shifts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F_TOL)
    assert not got[~torch.as_tensor(alive)].any() and float(got.max()) > 0.1


def _same_tree(got, want, n_leaves):
    seen = []

    def check(g, w):
        assert tuple(g.shape) == np.shape(w)
        seen.append(1)

    tree_map(check, got, jax.tree.map(np.asarray, want))
    assert len(seen) == n_leaves


def test_initialisers_have_jax_trees():
    """init_chgnet and init_ensemble draw the JAX package's trees and shapes
    (the values differ: another generator), with its laws; train_model is
    train_painn."""
    jcfg = jchgnet.CHGNetConfig(**CHGNET)
    want = jchgnet.init_chgnet(jax.random.PRNGKey(0), jcfg)
    got = init_chgnet(torch.Generator().manual_seed(0), _tcfg(CHGNetConfig, jcfg))
    _same_tree(got, want, len(jax.tree.leaves(want)))
    assert torch.equal(got["rbf_freq_ag"], torch.as_tensor(np.array(want["rbf_freq_ag"])))
    assert torch.equal(got["angle_freq"], torch.as_tensor(np.array(want["angle_freq"])))
    emb = got["atom_embedding"]
    assert abs(float(emb.std()) - 0.1) < 0.01
    w = got["atom_convs"][0]["gmlp"]["core0"]["w"]
    assert float(w.abs().max()) <= 1.0 / np.sqrt(w.shape[0])
    assert not bool(got["composition"].any())

    pcfg = jpainn.PaiNNConfig(**PAINN)
    jens = jtrain.init_ensemble(jax.random.PRNGKey(1), pcfg, 3)
    ens = init_ensemble(torch.Generator().manual_seed(1), _tcfg(PaiNNConfig, pcfg), 3)
    _same_tree(ens, jens, len(jax.tree.leaves(jens)))
    assert len(tree_leaves(ens)) == len(jax.tree.leaves(jens))
    assert not torch.equal(ens["atom_embed"][0], ens["atom_embed"][1])
    assert train_model is train_painn
