"""The port's distance criteria and multiple-try Metropolis (core/events.py,
core/engine.py) and the delta engine's canonical step and
metropolis_distance criterion (core/incremental.py) against the JAX package
on the CPU.

* ``make_distance_accept``: the accept masks of random occupancies equal
  JAX's, on single-atom and group vocabularies;
* steps fed the JAX step's own draws (the sites, codes, Gumbels and
  uniforms of its key splits) take the same decisions and reach the same
  occupancies, energies within 1e-4 eV + 1e-5 relative: the distance criteria (semigrand and
  canonical), MTM (semigrand and canonical), the delta canonical step and
  the delta semigrand step under metropolis_distance;
* exactness on a fully enumerable 4-site system (the analogs of
  tests/test_distribution.py's MTM and metropolis_distance tests): MTM and
  metropolis_distance chains sample the exact (constrained) Boltzmann
  distribution, and canonical MTM samples it within its sector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_incremental import CFG, TYPES, _toy

from surface_sampling_tpu.core import make_spec as j_make_spec
from surface_sampling_tpu.core.events import make_canonical_step as j_canonical_step
from surface_sampling_tpu.core.events import make_canonical_step_mtm as j_canonical_mtm
from surface_sampling_tpu.core.events import make_distance_accept as j_distance_accept
from surface_sampling_tpu.core.events import make_semigrand_step as j_semigrand_step
from surface_sampling_tpu.core.events import make_semigrand_step_mtm as j_semigrand_mtm
from surface_sampling_tpu.core.incremental import (
    make_incremental_canonical_step as j_inc_canonical,
)
from surface_sampling_tpu.core.incremental import make_incremental_painn as j_make_inc
from surface_sampling_tpu.core.incremental import (
    make_incremental_semigrand_step as j_inc_semigrand,
)
from surface_sampling_tpu.core.state import MCState as JMCState
from surface_sampling_tpu.core.state import device_spec as j_device_spec
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.core.energy import make_state_energy_fn as j_state_energy_fn
from surface_sampling_tpu.models.painn import PaiNNConfig as JPaiNNConfig
from surface_sampling_tpu.models.train import init_ensemble
from surface_sampling_tpu.ops.banding import build_routing_band_for_spec as j_build_band
from surface_sampling_tpu.potentials import make_lennard_jones as j_lj
from surface_sampling_tpu.structure import Structure as JStructure
from surface_sampling_tpu.structure.sites import find_adsorption_sites as j_find_sites
from surface_sampling_tpu.structure.slabs import fcc100 as j_fcc100
from surface_sampling_tpu_torch.core.energy import make_state_energy_fn
from surface_sampling_tpu_torch.core.engine import (
    EngineConfig,
    make_generator,
    make_run_fn,
)
from surface_sampling_tpu_torch.core.events import (
    make_canonical_step,
    make_canonical_step_mtm,
    make_distance_accept,
    make_semigrand_step,
    make_semigrand_step_mtm,
    mtm_draws,
)
from surface_sampling_tpu_torch.core.incremental import (
    make_incremental_canonical_step,
    make_incremental_painn,
    make_incremental_semigrand_step,
)
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import device_spec, initial_state
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
from surface_sampling_tpu_torch.models.painn import PaiNNConfig
from surface_sampling_tpu_torch.models.weights import from_jax_params
from surface_sampling_tpu_torch.ops.banding import build_routing_band_for_spec
from surface_sampling_tpu_torch.parallel.chains import chain_states
from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones
from surface_sampling_tpu_torch.structure import Structure, fcc100, find_adsorption_sites

# port vs JAX, f32 on both sides: the JAX package's own rule for delta vs
# full evaluations (overlapping LJ states score 1e2-1e3 eV)
E_TOL = dict(rtol=1e-5, atol=1e-4)
L1_TOL, L1_WRONG = 0.05, 0.15  # tests/test_distribution.py's bounds
FD = 2.8                      # excludes neighbouring ontop pairs (2.56 A apart)
# empty share of random start states: the 'group' lattice's sites sit ~1.3 A
# apart, so it is sparse enough there for some states to pass the filter
P_EMPTY = {"ontop": 0.6, "group": 0.92}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lj_system(kind: str, mk_fcc, mk_sites, mk_spec, lj, run_cls):
    """'ontop': the enumerable 4-site LJ system of tests/test_distribution.py;
    'group': LJ(100) 2x2x2 with all sites and a Cu / OH vocabulary (two-atom
    groups exercise the filter's intra-group pairs)."""
    pot = lj(epsilon=0.4, sigma=2.3, cutoff=5.0)
    if kind == "ontop":
        slab = mk_fcc("Cu", size=(2, 2, 1), a=3.6147, vacuum=10.0)
        sites = mk_sites(slab, planar_distance=2.0)["ontop"]
        spec = mk_spec(slab, sites, ["Cu"], potential_numbers=[29], cutoff=5.0)
    else:
        slab = mk_fcc("Cu", size=(2, 2, 2), a=3.6147, vacuum=10.0)
        sites = mk_sites(slab, planar_distance=1.2)["all"]
        spec = mk_spec(slab, sites, ["Cu", "HO"], potential_numbers=[29, 8, 1], cutoff=5.0)
    return spec, pot


@pytest.fixture(scope="module", params=["ontop", "group"])
def lj(request):
    """(port d, port state_energy_fn, JAX d, JAX state_energy_fn)."""
    tspec, tpot = _lj_system(request.param, fcc100, find_adsorption_sites, make_spec,
                             make_lennard_jones, None)
    jspec, jpot = _lj_system(request.param, j_fcc100, j_find_sites, j_make_spec, j_lj, None)
    d = device_spec(tspec, torch.device("cpu"))
    jd = j_device_spec(jspec)
    return (request.param, d, make_state_energy_fn(d, tpot), jd,
            j_state_energy_fn(jd, jpot))


@pytest.fixture(scope="module")
def enumerable():
    """The 4-site system, its 16 states and their exact surface energies."""
    spec, pot = _lj_system("ontop", fcc100, find_adsorption_sites, make_spec,
                           make_lennard_jones, None)
    d = device_spec(spec, torch.device("cpu"))
    sef = make_state_energy_fn(d, pot)
    S = spec.n_sites
    states = np.array([[int(b) for b in np.binary_repr(i, S)] for i in range(2 ** S)])
    E = sef(torch.as_tensor(states)).surface_energy.double().numpy()
    return d, sef, S, states, E


def _random_states(n, S, n_codes, seed, p_empty=0.4):
    rng = np.random.default_rng(seed)
    ss = rng.integers(1, n_codes, (n, S))
    return np.where(rng.random((n, S)) < p_empty, 0, ss)


def _j_states(jd, jsef, ss, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(ss))
    jss = jnp.asarray(ss, jnp.int32)
    e = jax.vmap(jsef)(jss)
    return JMCState(site_state=jss, energy=e.surface_energy, relaxed_positions=e.positions,
                    key=keys)


def _t_states(d, sef, ss):
    st = initial_state(d, torch.as_tensor(ss))
    e = sef(st.site_state)
    return st._replace(energy=e.surface_energy, relaxed_positions=e.positions)


def _check(tst, tinfo, jst, jinfo):
    np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
    np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
    np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), **E_TOL)
    np.testing.assert_array_equal(tinfo.oob.numpy(), np.asarray(jinfo.oob))


# ----------------------------------------------------------------------
# Distance criteria
# ----------------------------------------------------------------------
def test_distance_accept_matches_jax(lj):
    kind, d, _, jd, _ = lj
    ss = _random_states(64, d.site_coords.shape[0], d.n_codes, seed=1, p_empty=P_EMPTY[kind])
    for fd in (1.5, FD, 3.7):
        got = make_distance_accept(d, fd)(torch.as_tensor(ss)).numpy()
        want = np.asarray(jax.vmap(j_distance_accept(jd, fd))(jnp.asarray(ss, jnp.int32)))
        np.testing.assert_array_equal(got, want)
        if fd == FD:
            assert got.any() and not got.all(), kind


def _semigrand_draws(key, S, n_codes):
    _, k_site, k_code, k_acc = jax.random.split(key, 4)
    return (jax.random.randint(k_site, (), 0, S), jax.random.randint(k_code, (), 0, n_codes - 1),
            jax.random.uniform(k_acc, dtype=jnp.float32))


def _canonical_draws(key, S, n_codes):
    _, k_types, k_s1, k_s2, k_acc = jax.random.split(key, 5)
    return (jax.random.gumbel(k_types, (n_codes,)), jax.random.gumbel(k_s1, (S,)),
            jax.random.gumbel(k_s2, (S,)), jax.random.uniform(k_acc, dtype=jnp.float32))


@pytest.mark.parametrize("criterion", ["distance", "metropolis_distance"])
@pytest.mark.parametrize("canonical", [False, True])
def test_distance_criterion_step_replays_jax_draws(lj, criterion, canonical):
    kind, d, sef, jd, jsef = lj
    S, n_codes = d.site_coords.shape[0], d.n_codes
    make_t, make_j = ((make_canonical_step, j_canonical_step) if canonical
                      else (make_semigrand_step, j_semigrand_step))
    tstep = make_t(d, sef, criterion=criterion, filter_distance=FD)
    jstep = jax.jit(jax.vmap(make_j(jd, jsef, criterion=criterion, filter_distance=FD),
                             in_axes=(0, None)))
    draw = _canonical_draws if canonical else _semigrand_draws
    ss0 = _random_states(12, S, n_codes, seed=3, p_empty=P_EMPTY[kind])
    jst, tst = _j_states(jd, jsef, ss0, 5), _t_states(d, sef, ss0)
    temp, accepted = 0.5, []
    for _ in range(6):
        dr = [torch.as_tensor(np.array(x)) for x in jax.vmap(lambda k: draw(k, S, n_codes))(
            jst.key)]
        if not canonical:
            dr[0], dr[1] = dr[0].long(), dr[1].long()
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = tstep(tst, temp, *dr)
        _check(tst, tinfo, jst, jinfo)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()
    # no accepted state violates the filter
    assert make_distance_accept(d, FD)(tst.site_state)[torch.as_tensor(accepted.any(0))].all() \
        or not accepted.any(0).any()


# ----------------------------------------------------------------------
# Multiple-try Metropolis
# ----------------------------------------------------------------------
def _mtm_draws(key, K, S, n_codes, canonical):
    """The draws of one JAX MTM step, in the port's layout."""
    _, k_trials, k_sel, k_ref, k_acc = jax.random.split(key, 5)

    def proposal(keys):
        if canonical:
            def one(k):
                k_types, k_s1, k_s2 = jax.random.split(k, 3)
                return (jax.random.gumbel(k_types, (n_codes,)), jax.random.gumbel(k_s1, (S,)),
                        jax.random.gumbel(k_s2, (S,)))
        else:
            def one(k):
                k_site, k_code = jax.random.split(k)
                return (jax.random.randint(k_site, (), 0, S),
                        jax.random.randint(k_code, (), 0, n_codes - 1))
        return jax.vmap(one)(keys)

    return (proposal(jax.random.split(k_trials, K)), jax.random.gumbel(k_sel, (K,)),
            proposal(jax.random.split(k_ref, K - 1)),
            jax.random.uniform(k_acc, dtype=jnp.float32))


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.as_tensor(np.array(x)).long()
                        if np.issubdtype(np.asarray(x).dtype, np.integer)
                        else torch.as_tensor(np.array(x)), tree)


@pytest.mark.parametrize("canonical", [False, True])
def test_mtm_step_replays_jax_draws(lj, canonical):
    kind, d, sef, jd, jsef = lj
    S, n_codes, K = d.site_coords.shape[0], d.n_codes, 4
    tstep = (make_canonical_step_mtm if canonical else make_semigrand_step_mtm)(d, sef, K)
    jstep = jax.jit(jax.vmap((j_canonical_mtm if canonical else j_semigrand_mtm)(jd, jsef, K),
                             in_axes=(0, None)))
    ss0 = _random_states(10, S, n_codes, seed=7, p_empty=P_EMPTY[kind])
    ss0[-1] = 0                          # canonical: a single code present, never accepted
    jst, tst = _j_states(jd, jsef, ss0, 11), _t_states(d, sef, ss0)
    temp, accepted = 0.4, []
    for _ in range(5):
        trial, g_sel, ref, u = _to_torch(jax.vmap(
            lambda k: _mtm_draws(k, K, S, n_codes, canonical))(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = tstep(tst, temp, tuple(trial), g_sel, tuple(ref), u)
        _check(tst, tinfo, jst, jinfo)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()
    if canonical:
        assert not accepted[:, -1].any()
        np.testing.assert_array_equal((tst.site_state > 0).sum(1).numpy(), (ss0 > 0).sum(1))


def test_mtm_refusals_and_draw_shapes(lj):
    _, d, sef, _, _ = lj
    with pytest.raises(ValueError):
        make_semigrand_step_mtm(d, sef, k_trials=1)
    with pytest.raises(ValueError, match="metropolis"):
        make_run_fn(d, sef, EngineConfig(mtm_trials=3, criterion="metropolis_distance"))
    with pytest.raises(ValueError, match="unweighted"):
        make_run_fn(d, sef, EngineConfig(mtm_trials=3, canonical=True,
                                          require_per_atom_energies=True))
    S = d.site_coords.shape[0]
    trial, g, ref, u = mtm_draws(5, canonical=True)(make_generator(0, "cpu"), 3, S, d.n_codes)
    assert [t.shape for t in trial] == [(3, 5, d.n_codes), (3, 5, S), (3, 5, S)]
    assert g.shape == (3, 5) and [t.shape for t in ref][1] == (3, 4, S) and u.shape == (3,)


# ----------------------------------------------------------------------
# Exactness on the enumerable system
# ----------------------------------------------------------------------
def _exact(E, temp, allowed=None):
    w = np.exp(-(E - E.min()) / temp)
    if allowed is not None:
        w = w * allowed
    return w / w.sum()


def _visits(site_states, S, burn):
    ss = site_states[:, burn:].reshape(-1, S)
    counts = np.bincount(ss.dot(1 << np.arange(S)[::-1]), minlength=2 ** S)
    return counts / counts.sum()


def _sample(d, sef, cfg, n_chains, sweeps, seed, temp, site_state=None):
    run = make_run_fn(d, sef, cfg)
    st = chain_states(d, n_chains, site_state)
    st = st._replace(energy=sef(st.site_state).surface_energy)
    _, rec = run(st, np.full(sweeps, temp), make_generator(seed, "cpu"))
    return rec


def test_mtm_chain_samples_exact_boltzmann(enumerable):
    d, sef, S, _, E = enumerable
    temp = 1.5
    rec = _sample(d, sef, EngineConfig(sweep_size=4, record_positions=False, mtm_trials=4),
                  512, 60, 7, temp)
    p = _visits(rec.site_state.numpy(), S, 20)
    assert np.abs(p - _exact(E, temp)).sum() < L1_TOL
    assert np.abs(p - _exact(E, 0.6)).sum() > L1_WRONG
    rec1 = _sample(d, sef, EngineConfig(sweep_size=4, record_positions=False), 512, 20, 7, temp)
    assert float(rec.accept_rate.mean()) > float(rec1.accept_rate.mean())


def test_canonical_mtm_samples_exact_boltzmann_in_sector(enumerable):
    d, sef, S, states, E = enumerable
    temp = 1.5
    sector = np.where(states.sum(axis=1) == 2)[0]
    rec = _sample(d, sef, EngineConfig(sweep_size=3, canonical=True, record_positions=False,
                                       mtm_trials=3), 256, 40, 13, temp,
                  site_state=np.array([1, 1, 0, 0]))
    ss = rec.site_state.numpy()
    assert set(ss.sum(axis=2).reshape(-1)) == {2}
    p = _visits(ss, S, 13)[sector]
    assert np.abs(p / p.sum() - _exact(E[sector], temp)).sum() < L1_TOL


def test_metropolis_distance_samples_constrained_boltzmann(enumerable):
    d, sef, S, states, E = enumerable
    temp = 1.5
    ok = make_distance_accept(d, FD)(torch.as_tensor(states)).numpy()
    assert ok.any() and not ok.all()
    rec = _sample(d, sef, EngineConfig(sweep_size=4, record_positions=False,
                                       criterion="metropolis_distance", filter_distance=FD),
                  512, 60, 2, temp)
    p = _visits(rec.site_state.numpy(), S, 20)
    assert p[~ok].sum() == 0.0
    assert np.abs(p - _exact(E, temp, ok)).sum() < L1_TOL
    assert _exact(E, temp)[~ok].sum() > 0.02


# ----------------------------------------------------------------------
# The delta engine: canonical step and metropolis_distance
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def inc_pair():
    """The banded toy of tests/test_torch_incremental.py: the JAX delta
    engine and DeviceSpec, the port's."""
    jcfg = JPaiNNConfig(**CFG, pallas_routing="f32")
    jspec = _toy(JStructure, j_make_spec)
    jnbr = j_build_table(jspec, jcfg.cutoff, relax_slack=0.1)
    params = init_ensemble(jax.random.PRNGKey(0), jcfg, 2)
    jd = j_device_spec(jspec)
    jeng = j_make_inc(jspec, jd, params, jcfg, jnbr, j_build_band(jspec, jnbr), TYPES,
                      units="kcal/mol")
    cfg = PaiNNConfig(**CFG)
    spec = _toy(Structure, make_spec)
    nbr = build_static_neighbor_table(spec, cfg.cutoff, relax_slack=0.1)
    band = build_routing_band_for_spec(spec, nbr)
    d = device_spec(spec, torch.device("cpu"))
    pot = make_painn_potential(from_jax_params(jax.tree.map(np.asarray, params), "cpu"), cfg,
                               TYPES, units="kcal/mol", static_nbr=nbr, spec=spec, device="cpu",
                               routing_band=band)
    return jd, jeng, d, make_incremental_painn(spec, d, pot, nbr, band)


@pytest.mark.parametrize("canonical,criterion", [(True, "metropolis"),
                                                 (True, "metropolis_distance"),
                                                 (False, "metropolis_distance")])
def test_incremental_step_replays_jax_draws(inc_pair, canonical, criterion):
    jd, jeng, d, eng = inc_pair
    S, n_codes = eng.n_sites, eng.n_codes
    fd = 2.2                               # the toy's sites sit 2 A apart in x
    make_t, make_j = ((make_incremental_canonical_step, j_inc_canonical) if canonical
                      else (make_incremental_semigrand_step, j_inc_semigrand))
    tstep = make_t(eng, d, criterion=criterion, filter_distance=fd)
    jstep = jax.jit(jax.vmap(make_j(jeng, jd, criterion=criterion, filter_distance=fd),
                             in_axes=(0, None)))
    draw = _canonical_draws if canonical else _semigrand_draws
    rng = np.random.default_rng(4)
    ss0 = np.zeros((5, S), np.int64)
    for c in range(4):
        ss0[c, rng.choice(S, 6, replace=False)] = rng.integers(1, n_codes, 6)
    keys = jax.random.split(jax.random.PRNGKey(9), len(ss0))
    jst = jax.vmap(jeng.init_state)(keys, jnp.asarray(ss0, jnp.int32))
    tst = eng.init_state(torch.as_tensor(ss0))
    temp, accepted = 0.02, []
    for _ in range(6):
        dr = [torch.as_tensor(np.array(x)) for x in jax.vmap(lambda k: draw(k, S, n_codes))(
            jst.key)]
        if not canonical:
            dr[0], dr[1] = dr[0].long(), dr[1].long()
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = tstep(tst, temp, *dr)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), **E_TOL)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()
    assert not accepted[:, -1].any() or not canonical      # the all-empty chain
    if canonical:
        np.testing.assert_array_equal((tst.site_state > 0).sum(1).numpy(), (ss0 > 0).sum(1))
    # the cached energies equal a fresh full evaluation
    np.testing.assert_allclose(eng.energy_full(tst.site_state)[0].numpy(), tst.energy.numpy(),
                               **E_TOL)
