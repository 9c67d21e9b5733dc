"""The port's parallel tempering and population annealing
(parallel/tempering.py, parallel/population.py) against the JAX package on
the CPU.

- The swap phase fed JAX's own uniforms (``uniform(key, (C,))``) makes the
  same swaps: the same site states, energies and positions, bitwise, and the
  same rate, with and without the pod schedule's gating.
- Tempered Au(110) rounds replayed from JAX's draws (each replica's sweep at
  its own temperature, then the swap phase): the same decisions and site
  states, energies within 1e-4 eV (the EAM port's rule).
- A tempered run repeats bitwise and continues bitwise across two chunks; the
  pod schedule keeps configurations inside their pods except on its rounds.
- Systematic resampling fed JAX's uniform picks the same sources; population
  annealing on the enumerable 4-site LJ system of tests/test_distribution.py
  lands on the exact Boltzmann distribution (L1 < 0.08) and estimates
  log Z(T_lo) / Z(T_hi) within 0.15 of enumeration, with 2,048 chains (the
  JAX test runs 4,096) and the JAX test's schedule.
- Tempering of the delta engine's states carries their caches: after swaps
  the cached energies equal fresh evaluations of the swapped occupancies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp
from test_torch_criteria_mtm import _lj_system

from surface_sampling_tpu import systems as jsystems
from surface_sampling_tpu.core.events import make_semigrand_step as j_make_semigrand_step
from surface_sampling_tpu.core.state import MCState as JMCState
from surface_sampling_tpu.parallel.population import _systematic_resample as j_resample
from surface_sampling_tpu.parallel.tempering import _swap_phase as j_swap_phase
from surface_sampling_tpu_torch.core.energy import make_state_energy_fn
from surface_sampling_tpu_torch.core.engine import EngineConfig, make_generator, make_run_fn
from surface_sampling_tpu_torch.core.events import make_semigrand_step
from surface_sampling_tpu_torch.core.incremental import (
    make_incremental_run,
    make_incremental_semigrand_step,
)
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import MCState, device_spec
from surface_sampling_tpu_torch.parallel import (
    chain_states,
    incremental_chain_states,
    make_population_annealing_run,
    make_tempered_run,
    swap_phase,
    systematic_resample,
    temperature_ladder,
)
from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones
from surface_sampling_tpu_torch.structure.sites import find_adsorption_sites
from surface_sampling_tpu_torch.structure.slabs import fcc100
from surface_sampling_tpu_torch.systems import au110_eam

EAM_TOL = 1e-4       # eV, port vs JAX (tests/test_torch_eam.py's rule)
PA_CHAINS = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one torch thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def au():
    return jsystems.au110_eam(), au110_eam(device="cpu")


def _tagged_states(C, S, seed):
    """Occupancies tagged with their chain index, spread energies and
    positions, as JAX and port MCStates."""
    rng = np.random.default_rng(seed)
    ss = np.tile(np.arange(C)[:, None], (1, S))
    e = rng.normal(0.0, 2.0, C).astype(np.float32)
    pos = rng.normal(size=(C, 3, 3)).astype(np.float32)
    jst = JMCState(site_state=jnp.asarray(ss, jnp.int32), energy=jnp.asarray(e),
                   relaxed_positions=jnp.asarray(pos),
                   key=jax.random.split(jax.random.PRNGKey(seed), C))
    tst = MCState(site_state=torch.as_tensor(ss), energy=torch.as_tensor(e),
                  relaxed_positions=torch.as_tensor(pos))
    return jst, tst


@pytest.mark.parametrize("C,pod", [(6, None), (8, None), (8, 4), (7, 3)])
def test_swap_phase_replays_jax_uniforms(C, pod):
    """Both parities, with the pod gating of non-boundary rounds when a pod
    size is given: the swapped states bitwise JAX's (positions too), the
    rate equal, the energy multiset kept; gated phases never cross a pod."""
    temps_np = temperature_ladder(0.05, 2.0, C).astype(np.float32)
    temps = torch.as_tensor(temps_np)
    jst, tst = _tagged_states(C, 4, C)
    idx = np.arange(C)
    pair_ok = None if pod is None else ~(((idx + 1) % pod == 0) & (idx + 1 < C))
    for parity in (0, 1):
        for seed in range(3):
            key = jax.random.PRNGKey(10 * seed + parity)
            u = torch.as_tensor(np.array(jax.random.uniform(key, (C,))))
            jout, jrate = j_swap_phase(jst, jnp.asarray(temps_np), key, parity,
                                       None if pair_ok is None else jnp.asarray(pair_ok))
            out, rate = swap_phase(tst, temps, u, parity,
                                   None if pair_ok is None else torch.as_tensor(pair_ok))
            np.testing.assert_array_equal(out.site_state.numpy(), np.asarray(jout.site_state))
            np.testing.assert_array_equal(out.energy.numpy(), np.asarray(jout.energy))
            np.testing.assert_array_equal(out.relaxed_positions.numpy(),
                                          np.asarray(jout.relaxed_positions))
            assert float(rate) == pytest.approx(float(jrate), abs=1e-7)
            assert sorted(out.energy.tolist()) == sorted(tst.energy.tolist())
            if pod is not None:
                origin = out.site_state[:, 0].numpy()
                assert all(o // pod == i // pod for i, o in enumerate(origin))


def test_tempered_rounds_replay_jax_draws(au):
    """Au(110), 8 replicas on the ladder 0.05-2.0, 3 rounds of a 4-step
    sweep: every replica's steps at its own temperature (per-chain temps)
    and the swap phases, fed JAX's draws, take JAX's decisions."""
    jsys, tsys = au
    jd, d = jsys.run.d, tsys.run.d
    C, S, n_codes, sweep = 8, tsys.spec.n_sites, tsys.spec.n_codes, 4
    temps_np = temperature_ladder(0.05, 2.0, C).astype(np.float32)
    jstep = jax.jit(jax.vmap(j_make_semigrand_step(jd, jsys.run.state_energy_fn),
                             in_axes=(0, 0)))
    step = make_semigrand_step(d, tsys.run.state_energy_fn)
    ss0 = np.zeros((C, S), np.int64)
    ss0[:, 1] = 1
    jss = jnp.asarray(ss0, jnp.int32)
    jst = JMCState(site_state=jss,
                   energy=jax.vmap(lambda s: jsys.run.state_energy_fn(s).surface_energy)(jss),
                   relaxed_positions=jnp.zeros((C, tsys.spec.n_slots, 3)),
                   key=jax.random.split(jax.random.PRNGKey(0), C))
    tst = chain_states(d, C, ss0)
    tst = tst._replace(energy=tsys.run.state_energy_fn(tst.site_state).surface_energy)

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    swap_key = jax.random.PRNGKey(7)
    accepted, swapped = [], []
    for r in range(3):
        for _ in range(sweep):
            site, u_code, u_acc = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
            jst, jinfo = jstep(jst, jnp.asarray(temps_np))
            tst, tinfo = step(tst, torch.as_tensor(temps_np), site.long(), u_code.long(), u_acc)
            np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
            accepted.append(tinfo.accepted.numpy())
        swap_key, k = jax.random.split(swap_key)
        jst, jrate = j_swap_phase(jst, jnp.asarray(temps_np), k, r % 2)
        tst, rate = swap_phase(tst, torch.as_tensor(temps_np),
                               torch.as_tensor(np.array(jax.random.uniform(k, (C,)))), r % 2)
        assert float(rate) == pytest.approx(float(jrate), abs=1e-7)
        swapped.append(float(rate))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), rtol=0,
                                   atol=EAM_TOL)
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()
    assert max(swapped) > 0


def test_tempered_run_repeats_continues_and_pods(au):
    """make_tempered_run on Au(110) (8 replicas, sweeps of 4): records of
    the JAX shapes, finite energies, swap rates in [0, 1]; the same
    generator repeats the run bitwise, and two chunks of 3 rounds with
    ``start`` continue it bitwise; with pod_size 4 (dcn_every 3) the rounds
    off the schedule keep every configuration in its pod."""
    tsys = au[1]
    d = tsys.run.d
    C = 8
    temps = temperature_ladder(0.05, 2.0, C)
    run_fn = make_run_fn(d, tsys.run.state_energy_fn,
                         EngineConfig(sweep_size=4, record_positions=False))
    st = chain_states(d, C)
    st = st._replace(energy=tsys.run.state_energy_fn(st.site_state).surface_energy)
    trun = make_tempered_run(run_fn, n_rounds=6)
    out, rec = trun(st, temps, make_generator(7, "cpu"))
    assert rec.energy.shape == (6, C) and rec.site_state.shape == (6, C, tsys.spec.n_sites)
    assert torch.isfinite(rec.energy).all()
    assert ((rec.swap_rate >= 0) & (rec.swap_rate <= 1)).all() and rec.swap_rate.max() > 0
    again = trun(st, temps, make_generator(7, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(out + rec, again[0] + again[1]))
    half = make_tempered_run(run_fn, n_rounds=3)
    gen = make_generator(7, "cpu")
    mid, rec1 = half(st, temps, gen)
    fin, rec2 = half(mid, temps, gen, start=3)
    assert all(torch.equal(a, b) for a, b in zip(out, fin))
    assert all(torch.equal(a, torch.cat([b, c])) for a, b, c in zip(rec, rec1, rec2))

    tag = st._replace(site_state=torch.arange(C)[:, None].expand(C, tsys.spec.n_sites))
    criterion_free = make_tempered_run(lambda s, t, g: (s, None), n_rounds=6, pod_size=4,
                                       dcn_every=3)
    _, prec = criterion_free(tag._replace(energy=torch.linspace(3.0, -3.0, C)), temps,
                             make_generator(8, "cpu"))
    for r in range(6):
        origin = prec.site_state[r, :, 0]
        if r % 3 != 2:
            assert all(int(o) // 4 == i // 4 for i, o in enumerate(origin))
        assert sorted(prec.energy[r].tolist()) == sorted(torch.linspace(3.0, -3.0, C).tolist())


def test_systematic_resample_replays_jax():
    """Systematic resampling of the same weights with JAX's uniform picks
    the same source chains."""
    rng = np.random.default_rng(0)
    for n in (16, 256, 2048):
        log_w = rng.normal(0.0, 3.0, n).astype(np.float32)
        for seed in range(3):
            key = jax.random.PRNGKey(seed)
            want = np.asarray(j_resample(key, jnp.asarray(log_w), n))
            u0 = torch.as_tensor(np.array(jax.random.uniform(key, ())))
            got = systematic_resample(u0, torch.as_tensor(log_w), n)
            np.testing.assert_array_equal(got.numpy(), want)


def test_population_annealing_boltzmann_and_free_energy():
    """The analog of tests/test_distribution.py's PA test: 10 burn-in
    sweeps at T_hi, then 40 temperatures from 4.0 to 0.6 (sweeps of 4): the
    final population's occupancy histogram within L1 0.08 of the exact
    Boltzmann distribution at 0.6, sum dlogZ within 0.15 of the exact
    log Z(0.6) / Z(4.0), ESS above 0.2 C throughout; with the resampling
    threshold 0 no step resamples, and ``t_prev`` reweights the first
    step."""
    spec, pot = _lj_system("ontop", fcc100, find_adsorption_sites, make_spec,
                           make_lennard_jones, None)
    d = device_spec(spec, torch.device("cpu"))
    sef = make_state_energy_fn(d, pot)
    S = spec.n_sites
    states = np.array([[int(b) for b in np.binary_repr(i, S)] for i in range(2 ** S)])
    E = sef(torch.as_tensor(states)).surface_energy.double().numpy()
    t_hi, t_lo, R = 4.0, 0.6, 40
    run_fn = make_run_fn(d, sef, EngineConfig(sweep_size=4, record_positions=False))
    cs = chain_states(d, PA_CHAINS)
    cs = cs._replace(energy=sef(cs.site_state).surface_energy)
    gen = make_generator(3, "cpu")
    cs, _ = run_fn(cs, np.full(10, t_hi), gen)
    out, rec = make_population_annealing_run(run_fn)(cs, np.geomspace(t_hi, t_lo, R), gen)
    assert rec.energy.shape == (R, PA_CHAINS) and rec.site_state.shape == (R, PA_CHAINS, S)
    idx = out.site_state.numpy().dot(1 << np.arange(S)[::-1])
    emp = np.bincount(idx, minlength=2 ** S) / PA_CHAINS
    p = np.exp(-(E - E.min()) / t_lo)
    p /= p.sum()
    assert np.abs(emp - p).sum() < 0.08
    logz_exact = logsumexp(-E / t_lo) - logsumexp(-E / t_hi)
    assert abs(float(rec.dlogz.sum()) - logz_exact) < 0.15
    # the first step reweights from its own temperature: ESS = C, no resampling
    assert float(rec.ess.min()) > 0.2 * PA_CHAINS and bool(rec.resampled[1:].all())
    _, rec0 = make_population_annealing_run(run_fn, resample_threshold=0.0)(
        cs, np.geomspace(t_hi, t_lo, 3), gen, t_prev=5.0)
    assert not rec0.resampled.any() and float(rec0.dlogz[0]) != 0.0


def test_tempering_carries_incremental_caches():
    """Tempering over the delta engine (tests/test_torch_incremental.py's
    toy): after rounds with swaps, every replica's cached energy equals a
    fresh full evaluation of its occupancy, and a swap phase gathers the
    caches with their states (bitwise the caches of the source chain)."""
    from test_torch_incremental import _toy, CFG, TYPES, N_MODELS
    from surface_sampling_tpu_torch.core.incremental import make_incremental_painn
    from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
    from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
    from surface_sampling_tpu_torch.models.painn import PaiNNConfig, init_ensemble
    from surface_sampling_tpu_torch.ops.banding import build_routing_band_for_spec
    from surface_sampling_tpu_torch.structure import Structure

    cfg = PaiNNConfig(**CFG)
    spec = _toy(Structure, make_spec)
    nbr = build_static_neighbor_table(spec, cfg.cutoff, relax_slack=0.1)
    band = build_routing_band_for_spec(spec, nbr)
    params = init_ensemble(make_generator(0, "cpu"), cfg, N_MODELS)
    d = device_spec(spec, torch.device("cpu"))
    pot = make_painn_potential(params, cfg, TYPES, units="kcal/mol", static_nbr=nbr, spec=spec,
                               device="cpu", routing_band=band)
    eng = make_incremental_painn(spec, d, pot, nbr, band)
    C = 6
    ss0 = np.random.default_rng(3).integers(0, spec.n_codes, (C, spec.n_sites))
    st = incremental_chain_states(eng, d, C, ss0)
    temps = torch.as_tensor(temperature_ladder(0.01, 1.0, C), dtype=torch.float32)
    out, rate = swap_phase(st, temps, torch.zeros(C), 0)     # u = 0: every pair swaps
    assert float(rate) == 1.0
    src = torch.tensor([1, 0, 3, 2, 5, 4])
    for a, b in zip(out.caches.s + out.caches.vcat + (out.caches.e_atom,),
                    st.caches.s + st.caches.vcat + (st.caches.e_atom,)):
        assert torch.equal(a, b[src])
    irun = make_incremental_run(make_incremental_semigrand_step(eng), 3, spec.n_sites,
                                spec.n_codes)
    fin, rec = make_tempered_run(irun, n_rounds=4)(st, temps, make_generator(2, "cpu"))
    assert rec.swap_rate.max() > 0
    fresh = eng.energy_full(fin.site_state)[0]
    np.testing.assert_allclose(fin.energy.numpy(), fresh.numpy(), rtol=1e-5, atol=1e-4)
