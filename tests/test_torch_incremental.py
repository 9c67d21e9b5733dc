"""The port's delta-energy MC engine (core/incremental.py) against
the JAX package on the CPU, on the elongated toy of tests/test_incremental.py
whose candidate windows band (42 slots, blocks of 16, two layers).

The JAX side runs its static-geometry delta with routing="f32" under jit
(its Pallas kernels in interpret mode), each reference computed once per
module. Energies are held to rtol 1e-5, atol 1e-4 (the JAX package's own
rule for delta vs full evaluation); the replayed MC steps must take the
same decisions. The port's incremental run is also held to the port's
full-evaluation run with the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.core import make_spec as j_make_spec
from surface_sampling_tpu.core.incremental import (
    make_incremental_painn as j_make_incremental_painn,
)
from surface_sampling_tpu.core.incremental import (
    make_incremental_semigrand_step as j_make_incremental_step,
)
from surface_sampling_tpu.core.state import device_spec as j_device_spec
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.models.painn import PaiNNConfig as JPaiNNConfig
from surface_sampling_tpu.models.train import init_ensemble
from surface_sampling_tpu.ops.banding import build_routing_band_for_spec as j_build_band
from surface_sampling_tpu.structure import Structure as JStructure
from surface_sampling_tpu_torch.core.energy import make_state_energy_fn
from surface_sampling_tpu_torch.core.engine import EngineConfig, make_generator, make_run_fn
from surface_sampling_tpu_torch.core.incremental import (
    make_incremental_canonical_step,
    make_incremental_painn,
    make_incremental_painn_from_system,
    make_incremental_run,
    make_incremental_semigrand_step,
)
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import device_spec
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
from surface_sampling_tpu_torch.models.painn import PaiNNConfig
from surface_sampling_tpu_torch.models.weights import from_jax_params
from surface_sampling_tpu_torch.ops.banding import build_routing_band_for_spec
from surface_sampling_tpu_torch.parallel.chains import chain_states, incremental_chain_states
from surface_sampling_tpu_torch.structure import Structure
from surface_sampling_tpu_torch.systems import srtio3_001_painn

E_TOL = dict(rtol=1e-5, atol=1e-4)
TYPES = [22, 8, 38]
CFG = dict(feat_dim=16, n_rbf=6, cutoff=4.0, n_layers=2, readout_hidden=8, max_neighbors=10,
           excl_vol=True, sigma=1.2, power=8.0)
N_MODELS = 2
# (sites, codes) of the delta sequence: changes, and exchanges (two sites)
MOVES = [((3,), None), ((10,), None), ((3, 17), "swap"), ((0,), None), ((20, 5), "swap"),
         ((11,), None)]


def _toy(structure_cls, spec_fn):
    rng = np.random.default_rng(5)
    xs = np.arange(21) * 2.0 + 0.3
    pos = np.stack([xs, np.full(21, 2.0), np.full(21, 5.0)], axis=1)
    pos[:, 1] += rng.uniform(-0.3, 0.3, 21)
    slab = structure_cls.from_symbols(["Ti"] * 21, pos, np.diag([42.0, 4.2, 16.0]))
    return spec_fn(slab, pos + np.array([0.7, 0.0, 1.9]), ["O", "Sr"], potential_numbers=TYPES,
                   cutoff=4.0, surface_name="toy_band")


@pytest.fixture(scope="module")
def jtoy():
    cfg = JPaiNNConfig(**CFG, pallas_routing="f32")
    spec = _toy(JStructure, j_make_spec)
    nbr = j_build_table(spec, cfg.cutoff, relax_slack=0.1)
    band = j_build_band(spec, nbr)
    params = init_ensemble(jax.random.PRNGKey(0), cfg, N_MODELS)
    d = j_device_spec(spec)
    eng = j_make_incremental_painn(spec, d, params, cfg, nbr, band, TYPES, units="kcal/mol")
    return spec, d, params, eng


@pytest.fixture(scope="module")
def ttoy(jtoy):
    cfg = PaiNNConfig(**CFG)
    spec = _toy(Structure, make_spec)
    nbr = build_static_neighbor_table(spec, cfg.cutoff, relax_slack=0.1)
    band = build_routing_band_for_spec(spec, nbr)
    params = from_jax_params(jax.tree.map(np.asarray, jtoy[2]), "cpu")
    d = device_spec(spec, torch.device("cpu"))
    pot = make_painn_potential(params, cfg, TYPES, units="kcal/mol", static_nbr=nbr, spec=spec,
                               device="cpu", routing_band=band)
    eng = make_incremental_painn(spec, d, pot, nbr, band)
    return spec, d, eng, pot, nbr, band


def _moves(spec, seed):
    """Start occupancy and the MOVES as (trial occupancy, sites) pairs."""
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, spec.n_codes, spec.n_sites)
    out = []
    for sites, kind in MOVES:
        trial = ss.copy()
        if kind == "swap":
            trial[sites[0]], trial[sites[1]] = ss[sites[1]], ss[sites[0]]
        else:
            trial[sites[0]] = (ss[sites[0]] + 1 + rng.integers(0, spec.n_codes - 1)) % spec.n_codes
        out.append((trial, sites))
        ss = trial
    return rng, out


@pytest.fixture(scope="module")
def jdelta(jtoy):
    """JAX energy_full of the start occupancy and the delta energies along
    the move sequence (each delta from the previous one's caches)."""
    spec, _, _, eng = jtoy
    ss0 = np.random.default_rng(1).integers(0, spec.n_codes, spec.n_sites)
    full, delta = jax.jit(eng.energy_full), jax.jit(eng.delta)
    se0, caches, _ = full(jnp.asarray(ss0, jnp.int32))
    energies = []
    for trial, sites in _moves(spec, 1)[1]:
        sites2 = jnp.asarray(list(sites) * (2 // len(sites)), jnp.int32)
        se, caches, _ = delta(caches, jnp.asarray(trial, jnp.int32), sites2)
        energies.append(float(se))
    return ss0, float(se0), energies


def test_energy_full_and_delta_sequence_match_jax(ttoy, jdelta):
    """(e) energy_full and a sequence of single-site changes and two-site
    exchanges, each delta from the previous caches, against JAX's; the
    final caches agree with a fresh full evaluation."""
    spec, _, eng, _, _, _ = ttoy
    ss0, je0, jes = jdelta
    se, caches, _ = eng.energy_full(torch.as_tensor(ss0)[None])
    np.testing.assert_allclose(float(se[0]), je0, **E_TOL)
    assert len(caches.s) == 2 and caches.s[0].shape == (1, N_MODELS, 48, 16)
    for (trial, sites), je in zip(_moves(spec, 1)[1], jes):
        se, caches, oob = eng.delta(caches, torch.as_tensor(trial)[None],
                                    torch.as_tensor(sites)[None])
        np.testing.assert_allclose(float(se[0]), je, **E_TOL, err_msg=str(sites))
        assert not bool(oob[0])
    fresh, _, _ = eng.energy_full(torch.as_tensor(trial)[None])
    np.testing.assert_allclose(float(se[0]), float(fresh[0]), **E_TOL)


def test_incremental_step_replays_jax_draws(jtoy, ttoy):
    """(f) The port's incremental semigrand step fed the JAX incremental
    step's own draws takes the same decisions and reaches the same
    occupancies, energies within the tolerance."""
    jspec, _, _, jeng = jtoy
    eng = ttoy[2]
    n_chains, n_steps, temp = 4, 6, 0.01
    S, n_codes = jspec.n_sites, jspec.n_codes
    jstep = jax.jit(jax.vmap(j_make_incremental_step(jeng), in_axes=(0, None)))

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    ss0 = np.zeros((n_chains, S), np.int64)
    ss0[:, 2], ss0[:, 7] = 1, 2
    keys = jax.random.split(jax.random.PRNGKey(9), n_chains)
    jst = jax.vmap(jeng.init_state)(keys, jnp.asarray(ss0, jnp.int32))
    tst = eng.init_state(torch.as_tensor(ss0))
    np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), **E_TOL)
    step = make_incremental_semigrand_step(eng)
    accepted = []
    for _ in range(n_steps):
        site, u_code, u_acc = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = step(tst, temp, site.long(), u_code.long(), u_acc)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), **E_TOL)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()      # both branches replayed


def test_incremental_run_equals_full_run(ttoy):
    """(g) With the same seed, the incremental run and the full-evaluation
    run (banded rigid hook) draw the same moves and record the same
    occupancies, energies within the tolerance, at a temperature where
    some moves are accepted and some rejected."""
    spec, d, eng, pot, _, _ = ttoy
    temps = np.array([0.01, 0.005])
    n_chains, sweep = 3, 4
    sef = make_state_energy_fn(d, pot)
    full_run = make_run_fn(d, sef, EngineConfig(sweep_size=sweep, record_positions=False))
    states = chain_states(d, n_chains)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    f_out, f_rec = full_run(states, temps, make_generator(4, "cpu"))

    inc_run = make_incremental_run(make_incremental_semigrand_step(eng), sweep, spec.n_sites,
                                   spec.n_codes)
    i_out, i_rec = inc_run(incremental_chain_states(eng, d, n_chains), temps,
                           make_generator(4, "cpu"))
    np.testing.assert_array_equal(i_rec.site_state.numpy(), f_rec.site_state.numpy())
    np.testing.assert_array_equal(i_rec.accept_rate.numpy(), f_rec.accept_rate.numpy())
    np.testing.assert_allclose(i_rec.energy.numpy(), f_rec.energy.numpy(), **E_TOL)
    np.testing.assert_allclose(i_out.energy.numpy(), f_out.energy.numpy(), **E_TOL)
    assert 0.0 < float(i_rec.accept_rate.mean()) < 1.0
    assert i_rec.site_state.shape == (n_chains, 2, spec.n_sites)


def test_unported_options_raise(ttoy):
    """(i) An unknown static_geometry mode is refused (the dynamic delta of
    "off" is pinned in tests/test_torch_incremental_dynamic.py); the steps
    take only the Metropolis and metropolis_distance criteria, the latter
    with the DeviceSpec; a system without a band has no delta engine."""
    spec, d, eng, pot, nbr, band = ttoy
    with pytest.raises(ValueError, match="static_geometry"):
        make_incremental_painn(spec, d, pot, nbr, band, static_geometry="on")
    with pytest.raises(ValueError, match="DeviceSpec"):
        make_incremental_semigrand_step(eng, criterion="metropolis_distance")
    with pytest.raises(ValueError, match="support"):
        make_incremental_canonical_step(eng, d, criterion="distance")
    make_incremental_semigrand_step(eng, d, criterion="metropolis_distance")
    make_incremental_canonical_step(eng, d, criterion="metropolis_distance")
    with pytest.raises(ValueError, match="no routing band"):
        make_incremental_painn_from_system(srtio3_001_painn(n_models=1, device="cpu"))
