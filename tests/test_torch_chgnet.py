"""The port's CHGNet path (``models/chgnet.py``, ``lamno3_001_chgnet``)
against the JAX package on the CPU, on the same seeded numpy inputs.

* a tiny configuration (the one of ``tests/test_chgnet.py``'s conv-mode
  test) with dead slots: energy, per-atom energy, magmom and forces against
  ``chgnet_apply(conv_mode="gather")``;
* ``load_chgnet_npz``: tree and configuration equal to the JAX loader's;
* the flagship checkpoint at full width: the committed golden cases
  (``tests/data/chgnet_golden.json``, at the JAX test's tolerances), the
  pristine 2x2x3 system's potential and surface energy against JAX, and the
  surface-energy shift of one O adsorption;
* a semigrand step replayed with the JAX step's own draws and a 3-step
  FIRE relaxation against JAX, both on the 4-site ontop spec of
  ``tests/test_chgnet.py``;
* a banded model against the unbanded one on a toy band.

The JAX references run eagerly or under one small jit each: the module
stays within a minute on one torch thread.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu import systems as jsystems
from surface_sampling_tpu.core import MCMCRun as JMCMCRun
from surface_sampling_tpu.core import RelaxConfig as JRelaxConfig
from surface_sampling_tpu.core import make_spec as j_make_spec
from surface_sampling_tpu.core import state as jstate
from surface_sampling_tpu.core.energy import make_chem_pot_surface_energy as j_chem_se
from surface_sampling_tpu.core.events import make_semigrand_step as j_make_step
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.models import chgnet as jchgnet
from surface_sampling_tpu.models.convert_chgnet import load_chgnet_npz as j_load_chgnet_npz
from surface_sampling_tpu.models.nn_calculator import make_chgnet_potential as j_make_potential
from surface_sampling_tpu.structure import Structure as JStructure
from surface_sampling_tpu.structure import find_adsorption_sites as j_find_sites
from surface_sampling_tpu_torch.core import state as tstate
from surface_sampling_tpu_torch.core.energy import RelaxConfig, make_chem_pot_surface_energy
from surface_sampling_tpu_torch.core.engine import MCMCRun
from surface_sampling_tpu_torch.core.events import make_semigrand_step
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.static_neighbors import (
    StaticNeighborTable,
    build_static_neighbor_table,
)
from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig, chgnet_apply
from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential
from surface_sampling_tpu_torch.models.weights import from_jax_params, load_chgnet_npz
from surface_sampling_tpu_torch.ops.banding import build_routing_band, stage_band
from surface_sampling_tpu_torch.ops.neighbors import (
    neighbor_list_from_table,
    padded_rows,
    stage_candidate_table,
)
from surface_sampling_tpu_torch.structure import Structure, find_adsorption_sites
from surface_sampling_tpu_torch.systems import MODEL_DATA, SYSTEMS_DATA, lamno3_001_chgnet

CPU = torch.device("cpu")
E_TOL = 1e-3            # eV, port vs JAX, unrelaxed
E_TOL_RELAXED = 5e-3    # eV, port vs JAX after FIRE
POS_TOL_RELAXED = 1e-3  # A
TINY = CHGNetConfig(atom_fea_dim=32, num_radial=9, num_angular=9, n_conv=3, max_neighbors=16,
                    max_bond_neighbors=6, mlp_hidden_dims=(32, 32, 32))
TYPES = [57, 25, 8]     # La, Mn, O: the 4-site spec's potential types


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint():
    tree, cfg = load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    return from_jax_params(tree, CPU), cfg


@pytest.fixture(scope="module")
def slab_data():
    return np.load(SYSTEMS_DATA / "LaMnO3_001_2x2x3.npz")


def _nearest_first_table(pos: np.ndarray) -> StaticNeighborTable:
    """Candidate table of an open cluster: every other atom, nearest first
    (so a rank-select keeps the nearest M, as the JAX search does)."""
    n = len(pos)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1) + np.eye(n) * 1e9
    slot_j = np.argsort(d, axis=1, kind="stable")[:, :n - 1].astype(np.int32)
    return StaticNeighborTable(slot_j, np.zeros((n, n - 1, 3)), np.ones((n, n - 1), bool), n - 1)


def _tiny_case():
    """18 atoms in an open 9 A box, four of them dead: positions, atomic
    numbers, the alive mask and the JAX gather configuration of TINY."""
    rng = np.random.default_rng(1)
    N = 18
    pos = rng.uniform(0.0, 9.0, (N, 3)).astype(np.float32)
    numbers = rng.integers(1, 20, N).astype(np.int32)
    alive = rng.random(N) > 0.2
    alive[:2] = True
    jcfg = jchgnet.CHGNetConfig(**{**dataclasses.asdict(TINY), "conv_mode": "gather"})
    return pos, numbers, alive, jcfg


def _jax_tiny(jparams, jcfg, pos, numbers, alive):
    """The JAX outputs and forces of the tiny case, compiled."""

    def jenergy(p):
        out = jchgnet.chgnet_apply(jparams, jcfg, p, jnp.asarray(numbers), jnp.asarray(alive),
                                   jnp.zeros((1, 3)))
        return out["energy"], out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jenergy, has_aux=True))(jnp.asarray(pos))
    return jout, -np.asarray(jgrad)


def _port_tiny(params, pos, numbers, alive):
    """The port's outputs and forces of the tiny case, on edges ranked over
    the open cluster's nearest-first table."""
    table = stage_candidate_table(_nearest_first_table(pos), TINY.atom_graph_cutoff,
                                  TINY.max_neighbors, CPU)
    p = torch.as_tensor(pos)[None].requires_grad_(True)
    al = torch.as_tensor(alive)[None]
    edges = neighbor_list_from_table(p, al, table)
    assert not bool(edges.overflow[0])
    out = chgnet_apply(params, TINY, torch.as_tensor(numbers, dtype=torch.int64)[None], al, edges)
    (g,) = torch.autograd.grad(out["energy"].sum(), p)
    return out, -g[0].numpy()


def _assert_port_matches_jax(out, force, jout, jforce):
    tol = dict(rtol=1e-4, atol=1e-5)
    for key in ("energy", "per_atom_energy", "magmom"):
        np.testing.assert_allclose(out[key][0].detach().numpy(), np.asarray(jout[key]),
                                   err_msg=key, **tol)
    np.testing.assert_allclose(force, jforce, err_msg="forces", **tol)


def test_tiny_config_matches_jax_gather_with_forces():
    """18 atoms in an open 9 A box, four of them dead: the port (fused conv,
    plain on the CPU) against the JAX gather formulation."""
    pos, numbers, alive, jcfg = _tiny_case()
    jparams = jchgnet.init_chgnet(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), CPU)
    jout, jforce = _jax_tiny(jparams, jcfg, pos, numbers, alive)
    out, force = _port_tiny(params, pos, numbers, alive)
    _assert_port_matches_jax(out, force, jout, jforce)
    assert np.abs(jforce[alive]).max() > 0.01


def test_bond_and_angle_parameters_reach_no_output():
    """The premise of the port's forward, which computes no bond graph and
    no bond or angle update: in the JAX package, the bond convs, angle
    layers and bond-graph embeddings redrawn under another key leave every
    output and the forces bitwise unchanged, and the port matches JAX on
    both parameter sets."""
    pos, numbers, alive, jcfg = _tiny_case()
    jparams = jchgnet.init_chgnet(jax.random.PRNGKey(0), jcfg)
    other = jchgnet.init_chgnet(jax.random.PRNGKey(7), jcfg)
    dead = ("bond_convs", "angle_layers", "bond_weights_bg", "angle_embedding")
    redrawn = {**jparams, **{k: other[k] for k in dead}}
    for k in dead:
        assert not all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(jparams[k]), jax.tree.leaves(redrawn[k]), strict=True)), k
    jout, jforce = _jax_tiny(jparams, jcfg, pos, numbers, alive)
    jout2, jforce2 = _jax_tiny(redrawn, jcfg, pos, numbers, alive)
    for key in ("energy", "per_atom_energy", "energy_per_atom", "magmom", "embedding"):
        np.testing.assert_array_equal(np.asarray(jout2[key]), np.asarray(jout[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(jforce2, jforce, err_msg="forces")
    for tree in (jparams, redrawn):
        params = from_jax_params(jax.tree.map(np.asarray, tree), CPU)
        out, force = _port_tiny(params, pos, numbers, alive)
        _assert_port_matches_jax(out, force, jout, jforce)


def test_load_chgnet_npz_matches_jax():
    tree, cfg = load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    jtree, jcfg = j_load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    jfields = dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg) == {k: jfields[k] for k in dataclasses.asdict(cfg)}
    assert set(jfields) - set(dataclasses.asdict(cfg)) == {"conv_mode", "pallas_routing"}
    assert cfg.max_neighbors == 96          # the stored 48 is raised, as in JAX
    leaves, jleaves = jax.tree.leaves(tree), jax.tree.leaves(jtree)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_array_equal(a, np.asarray(b))


# ----------------------------------------------------------------------
# The flagship checkpoint at full width
# ----------------------------------------------------------------------
GOLDEN = json.loads((Path(__file__).parent / "data" / "chgnet_golden.json").read_text())


@pytest.fixture(scope="module")
def golden_outputs(checkpoint, slab_data):
    """The port's outputs for the golden cases: the bare slab (no sites),
    edges ranked over its static table (0.5 A of slack covers the
    rattles), the rattles drawn in the JAX test's order."""
    params, cfg = checkpoint
    slab = Structure(slab_data["numbers"], slab_data["positions"], slab_data["cell"])
    spec = make_spec(slab, np.zeros((0, 3)), [], potential_numbers=TYPES,
                     cutoff=cfg.atom_graph_cutoff)
    pot = make_chgnet_potential(params, cfg, TYPES, static_nbr=build_static_neighbor_table(
        spec, cfg.atom_graph_cutoff, relax_slack=0.5), device=CPU)
    numbers = slab_data["numbers"]
    type_idx = torch.as_tensor(spec.type_of_z[numbers])[None]
    alive = torch.ones((1, len(numbers)), dtype=torch.bool)
    rng = np.random.default_rng(12345)
    outs = []
    for case in GOLDEN["cases"]:
        p = slab_data["positions"] + case["perturbation_scale"] * rng.standard_normal(
            slab_data["positions"].shape)
        out = pot.outputs(torch.as_tensor(p, dtype=torch.float32)[None], type_idx, alive)
        outs.append({k: v[0].numpy() for k, v in out.items()})
    return outs


@pytest.mark.parametrize("case", range(len(GOLDEN["cases"])))
def test_golden_cases(golden_outputs, slab_data, case):
    """The committed goldens at the JAX test's own tolerances."""
    want, out = GOLDEN["cases"][case], golden_outputs[case]
    np.testing.assert_allclose(float(out["energy"]), want["energy"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(float(out["energy_per_atom"]), want["energy_per_atom"], rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(out["per_atom_energy"][:8], want["per_atom_energy_first8"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(out["magmom"][:8], want["magmom_first8"], rtol=0, atol=1e-3)
    mn = slab_data["numbers"] == 25
    np.testing.assert_allclose(float(out["magmom"][mn].mean()), want["magmom_mn_mean"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(float(np.linalg.norm(out["embedding"])), want["embedding_norm"],
                               rtol=1e-4, atol=0)


@pytest.fixture(scope="module")
def tsys():
    return lamno3_001_chgnet(device="cpu")


def test_pristine_system_matches_jax(tsys):
    """lamno3_001_chgnet pristine: potential energy (the golden -405.206 eV)
    and chem-pot surface energy against the JAX system."""
    jsys = jsystems.lamno3_001_chgnet()
    assert (tsys.spec.n_sites, tsys.spec.n_slots) == (jsys.spec.n_sites, jsys.spec.n_slots)
    assert tsys.routing_band is None
    jd = jsys.run.d
    ss = jnp.zeros(jsys.spec.n_sites, jnp.int32)
    je = float(jax.jit(jsys.potential.energy)(
        jstate.realize_positions(jd, ss), jstate.realize_type_idx(jd, ss),
        jstate.realize_alive(jd, ss), jd.shifts))
    jse = float(jsys.run.surface_energy_fn(je, jstate.element_counts(jd, ss, jnp.float32)))
    out = tsys.run.state_energy_fn(torch.zeros((1, tsys.spec.n_sites), dtype=torch.int64))
    assert abs(float(out.potential_energy[0]) - je) <= E_TOL
    assert abs(float(out.surface_energy[0]) - jse) <= E_TOL
    assert abs(float(out.potential_energy[0]) - GOLDEN["cases"][0]["energy"]) <= E_TOL


def test_o_adsorption_shifts_surface_energy_by_mu(tsys):
    """One O (code 1) on site 0: dSE = dE + 5.0 exactly (mu_O = -5 eV)."""
    ss = torch.zeros((2, tsys.spec.n_sites), dtype=torch.int64)
    ss[1, 0] = 1
    out = tsys.run.state_energy_fn(ss)
    d_se = float(out.surface_energy[1] - out.surface_energy[0])
    d_e = float(out.potential_energy[1] - out.potential_energy[0])
    assert np.isfinite(d_e) and abs(d_se - (d_e + 5.0)) <= 1e-4


# ----------------------------------------------------------------------
# The 4-site ontop spec: a replayed step and a short relaxation
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ontop(checkpoint, slab_data):
    """The 4 ontop sites with O adsorption of tests/test_chgnet.py, in both
    packages: (port spec, JAX spec, JAX params, JAX cfg)."""
    jslab = JStructure(slab_data["numbers"], slab_data["positions"], slab_data["cell"])
    jsites = j_find_sites(jslab, planar_distance=1.6)["ontop"][:4]
    slab = Structure(slab_data["numbers"], slab_data["positions"], slab_data["cell"])
    sites = find_adsorption_sites(slab, planar_distance=1.6)["ontop"][:4]
    np.testing.assert_allclose(sites, jsites)
    kw = dict(potential_numbers=TYPES, cutoff=6.0, surface_name="LaMnO3_001", surface_depth=1)
    jparams, jcfg = j_load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    return make_spec(slab, sites, ["O"], **kw), j_make_spec(jslab, jsites, ["O"], **kw), \
        jparams, jcfg


def _runs(checkpoint, ontop, slack, relax):
    spec, jspec, jparams, jcfg = ontop
    params, cfg = checkpoint
    chem = {"O": -5.0}
    pot = make_chgnet_potential(params, cfg, TYPES, static_nbr=build_static_neighbor_table(
        spec, 6.0, relax_slack=slack), device=CPU)
    run = MCMCRun(spec, pot, surface_energy_fn=make_chem_pot_surface_energy(spec, chem, CPU),
                  device=CPU, relax=relax)
    jpot = j_make_potential(jparams, jcfg, TYPES,
                            static_nbr=j_build_table(jspec, 6.0, relax_slack=slack))
    jrun = JMCMCRun(jspec, jpot, surface_energy_fn=j_chem_se(jspec, chem),
                    relax=None if relax is None else JRelaxConfig(steps=relax.steps))
    return run, jrun


def test_step_replays_jax_draws(checkpoint, ontop):
    """Four chains (one pristine, three with one O) take one semigrand step
    from the same current energies (the port's): fed the JAX step's own
    draws (site, code, acceptance uniform), the port accepts the same moves
    and reaches the same occupancies and energies."""
    run, jrun = _runs(checkpoint, ontop, 0.1, None)
    S, n_codes = run.spec.n_sites, run.spec.n_codes
    ss0 = np.zeros((4, S), np.int64)
    ss0[np.arange(4), [0, 1, 2, 3]] = 1
    ss0[1] = 0
    tst = tstate.initial_state(run.d, torch.as_tensor(ss0))
    tst = tst._replace(energy=run.state_energy_fn(tst.site_state).surface_energy)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    jss = jnp.asarray(ss0, jnp.int32)
    jst = jax.vmap(lambda s, k: jstate.initial_state(jrun.d, k, s))(jss, keys)
    jst = jst._replace(energy=jnp.asarray(tst.energy.numpy()))

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    site, u_code, u_acc = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
    jst2, jinfo = jax.jit(jax.vmap(j_make_step(jrun.d, jrun.state_energy_fn),
                                   in_axes=(0, None)))(jst, jnp.asarray(0.5, jnp.float32))
    tst2, tinfo = make_semigrand_step(run.d, run.state_energy_fn)(
        tst, 0.5, site.long(), u_code.long(), u_acc)
    np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
    assert tinfo.accepted.any() and not tinfo.accepted.all()   # both branches replayed
    np.testing.assert_array_equal(tst2.site_state.numpy(), np.asarray(jst2.site_state))
    np.testing.assert_allclose(tst2.energy.numpy(), np.asarray(jst2.energy), atol=E_TOL)


def test_relaxed_energy_and_positions_match_jax(checkpoint, ontop):
    """One O on site 0, FIRE-relaxed for 3 steps on the relax table
    (0.6 A slack, topology fixed per relaxation) in both packages."""
    run, jrun = _runs(checkpoint, ontop, 0.6, RelaxConfig(steps=3))
    ss = np.zeros((1, run.spec.n_sites), np.int64)
    ss[0, 0] = 1
    want = jax.jit(jrun.state_energy_fn)(jnp.asarray(ss[0], jnp.int32))
    got = run.state_energy_fn(torch.as_tensor(ss))
    assert abs(float(got.potential_energy[0]) - float(want.potential_energy)) <= E_TOL_RELAXED
    assert abs(float(got.surface_energy[0]) - float(want.surface_energy)) <= E_TOL_RELAXED
    ideal = tstate.realize_positions(run.d, torch.as_tensor(ss))[0].numpy()
    assert np.abs(np.asarray(want.positions) - ideal).max() > 1e-3
    np.testing.assert_allclose(got.positions[0].numpy(), np.asarray(want.positions),
                               atol=POS_TOL_RELAXED, rtol=0)


# ----------------------------------------------------------------------
# A banded model on a toy band
# ----------------------------------------------------------------------
def test_banded_model_matches_unbanded_on_a_toy_band():
    """42 atoms on a periodic 42 A line (jittered across it), each with its
    12 nearest images as candidates: n_pad 48 in blocks of 8, a band whose
    windows are narrower than the cell. The tiny model's energies through
    the banded conv equal the unbanded ones."""
    rng = np.random.default_rng(5)
    n, L = 42, 42.0
    x = np.arange(n, dtype=np.float64)
    diff = (x[None, :] - x[:, None] + n / 2) % n - n / 2
    slot_j = np.argsort(np.abs(diff) + np.eye(n) * 1e9, axis=1, kind="stable")[:, :12]
    shift = np.zeros((n, 12, 3))
    raw = x[slot_j] - x[:, None]
    shift[..., 0] = np.where(raw > n / 2, -L, np.where(raw < -n / 2, L, 0.0))
    table = StaticNeighborTable(slot_j.astype(np.int32), shift, np.ones((n, 12), bool), 12)
    band = build_routing_band(np.stack([x, 0 * x, 0 * x], 1), table.slot_j, table.valid, 8,
                              padded_rows(n))
    assert band is not None and band.window < band.perm.shape[0]
    jparams = jchgnet.init_chgnet(jax.random.PRNGKey(2), jchgnet.CHGNetConfig(
        **dataclasses.asdict(TINY)))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), CPU)
    C = 3
    pos = np.stack([x, np.zeros(n), np.zeros(n)], 1)[None] + rng.normal(0, 0.3, (C, n, 3))
    pos = torch.as_tensor(pos, dtype=torch.float32)
    alive = torch.as_tensor(rng.random((C, n)) > 0.1)
    numbers = torch.as_tensor(rng.integers(1, 20, (C, n)))
    staged = stage_candidate_table(table, TINY.atom_graph_cutoff, TINY.max_neighbors, CPU)
    edges = neighbor_list_from_table(pos, alive, staged)
    e_u = chgnet_apply(params, TINY, numbers, alive, edges)["energy"]
    e_b = chgnet_apply(params, TINY, numbers, alive, edges, band=stage_band(band, CPU))["energy"]
    assert torch.isfinite(e_u).all() and not bool(edges.overflow.any())
    np.testing.assert_allclose(e_b.numpy(), e_u.numpy(), rtol=0, atol=1e-5)
