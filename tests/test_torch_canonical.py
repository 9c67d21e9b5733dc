"""The port's canonical engine and run entry points against the JAX package
on the CPU, on the Au(110) and Cu(100) EAM systems.

* ``exchange_sites`` / ``num_adsorbate_atoms`` equal to JAX's;
* the canonical step replayed with the JAX step's own draws (the Gumbels
  and the uniform of its key split): accept and site_state exactly,
  energies within 1e-4 eV, without weights, with per-atom-energy weights,
  with distance-decay weights and under the testing criterion;
* ``prepare_canonical_fn``: every chain reaches ``num_ads_atoms`` and a
  chain that starts there keeps its state bitwise; the bounded force fill;
* a run cut into two chunks that pass one generator along equals one run
  bitwise (semigrand and canonical);
* ``MCMCRun.run`` canonical on Au(110) finds the -79.0349 eV ground state;
* even prefill and site-class counts equal to JAX's; the semigrand run
  through the EAM kernel potential equals the run through the Chebyshev
  path it shares its math with.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.core import engine as jengine
from surface_sampling_tpu.core import state as jstate
from surface_sampling_tpu.core.events import make_canonical_step as j_make_canonical_step
from surface_sampling_tpu.systems import au110_eam as j_au110
from surface_sampling_tpu.systems import cu100_eam as j_cu100
from surface_sampling_tpu_torch.core.engine import (
    EngineConfig,
    MCMCRun,
    count_adsorption_sites,
    even_site_prefill,
    geometric_schedule,
    make_generator,
    make_run_fn,
    prepare_canonical_fn,
)
from surface_sampling_tpu_torch.core.events import make_canonical_step, make_semigrand_step
from surface_sampling_tpu_torch.core.state import (
    exchange_sites,
    initial_state,
    num_adsorbate_atoms,
    num_occupied_sites,
)
from surface_sampling_tpu_torch.ops.eam_kernels import make_eam_kernel_potential
from surface_sampling_tpu_torch.parallel.chains import chain_states
from surface_sampling_tpu_torch.potentials.eam import builtin_eam
from surface_sampling_tpu_torch.systems import au110_eam, cu100_eam

E_TOL = 1e-4                                # eV, port vs JAX, f32 on both sides
AU_REFERENCE_MIN = -79.03490823689619       # tests/test_regression_eam.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def au():
    """Port exact and rigid Au(110) systems, the JAX exact one."""
    return au110_eam(device="cpu"), au110_eam(fast=True, device="cpu"), j_au110()


def _au_states(n, seed):
    """Six of the eight sites occupied per chain, one chain with three and
    one all empty (a single code present: never accepted)."""
    rng = np.random.default_rng(seed)
    ss = np.zeros((n, 8), np.int64)
    for c in range(n - 2):
        ss[c, rng.choice(8, 6, replace=False)] = 1
    ss[n - 2, rng.choice(8, 3, replace=False)] = 1
    return ss


def test_exchange_sites_and_adsorbate_atoms_match_jax(au):
    tex = au[0]
    ss = _au_states(5, seed=0)
    s1, s2 = np.array([0, 1, 2, 7, 3]), np.array([5, 1, 6, 0, 4])
    got = exchange_sites(torch.as_tensor(ss), torch.as_tensor(s1), torch.as_tensor(s2))
    want = jax.vmap(jstate.exchange_sites)(jnp.asarray(ss, jnp.int32), jnp.asarray(s1),
                                           jnp.asarray(s2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jd = au[2].run.d
    np.testing.assert_array_equal(
        num_adsorbate_atoms(tex.run.d, torch.as_tensor(ss)).numpy(),
        np.asarray(jax.vmap(lambda s: jstate.num_adsorbate_atoms(jd, s))(jnp.asarray(ss))))


def _distance_weights(spec):
    xy = spec.site_coords[:, :2]
    return np.exp(-np.linalg.norm(xy[:, None] - xy[None], axis=-1) / 2.0).astype(np.float32)


@pytest.mark.parametrize("variant", ["plain", "per_atom", "distance_decay", "testing"])
def test_canonical_step_replays_jax_draws(au, variant):
    tex, _, jex = au
    kw = {}
    if variant == "per_atom":
        kw = dict(require_per_atom_energies=True)
    elif variant == "distance_decay":
        kw = dict(require_distance_decay=True)
    elif variant == "testing":
        kw = dict(criterion="testing", always_accept=True)
    dwm = _distance_weights(tex.spec)
    jd, jsef = jex.run.d, jex.run.state_energy_fn
    jstep = jax.jit(jax.vmap(j_make_canonical_step(jd, jsef, potential=jex.potential,
                                                   distance_weight_matrix=jnp.asarray(dwm), **kw),
                             in_axes=(0, None)))
    tstep = make_canonical_step(tex.run.d, tex.run.state_energy_fn, potential=tex.potential,
                                distance_weight_matrix=dwm, **kw)
    S, K1 = 8, tex.spec.n_codes

    def draws(key):
        _, k_types, k_s1, k_s2, k_acc = jax.random.split(key, 5)
        return (jax.random.gumbel(k_types, (K1,)), jax.random.gumbel(k_s1, (S,)),
                jax.random.gumbel(k_s2, (S,)), jax.random.uniform(k_acc, dtype=jnp.float32))

    n_chains, temp = 8, 0.3
    ss0 = _au_states(n_chains, seed=1)
    keys = jax.random.split(jax.random.PRNGKey(3), n_chains)
    jss = jnp.asarray(ss0, jnp.int32)
    jst = jax.vmap(lambda s, k: jstate.initial_state(jd, k, s))(jss, keys)
    jst = jst._replace(energy=jax.vmap(jsef)(jss).surface_energy)
    tst = initial_state(tex.run.d, torch.as_tensor(ss0))
    tst = tst._replace(energy=tex.run.state_energy_fn(tst.site_state).surface_energy)
    accepted = []
    for _ in range(5):
        dr = [torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key)]
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = tstep(tst, temp, *dr)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), atol=E_TOL)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert not accepted[:, -1].any()          # the all-empty chain never exchanges
    assert accepted.any()
    if variant != "testing":
        assert not accepted.all()
    assert (num_occupied_sites(tst.site_state).numpy() == ss0.sum(axis=1)).all()


def test_prepare_canonical_reaches_count_and_keeps_finished_chains(au):
    _, rigid, _ = au
    d, sef = rigid.run.d, rigid.run.state_energy_fn
    ss = np.zeros((4, 8), np.int64)
    ss[1, :2] = 1
    ss[2, :7] = 1                                 # already past the count
    ss[3, 1:7] = 1                                # exactly at the count
    state = initial_state(d, torch.as_tensor(ss))
    state = state._replace(energy=sef(state.site_state).surface_energy)
    prep = prepare_canonical_fn(d, sef, 6, EngineConfig())
    out = prep(state, 1.0, make_generator(0, "cpu"))
    n = num_occupied_sites(out.site_state).numpy()
    assert n[0] == 6 and n[1] == 6 and n[2] == 7 and n[3] == 6
    for c in (2, 3):
        assert torch.equal(out.site_state[c], state.site_state[c])
        assert torch.equal(out.energy[c], state.energy[c])
    fill = prepare_canonical_fn(d, sef, 6, EngineConfig(), max_steps=0, force_fill=True)
    out = fill(state, 1.0, make_generator(0, "cpu"))
    want = ss.copy()
    want[0, :6] = 1
    want[1, :6] = 1
    np.testing.assert_array_equal(out.site_state.numpy(), want)


@pytest.mark.parametrize("canonical", [False, True])
def test_two_chunks_equal_one_run(au, canonical):
    """The run's generator continues across calls: sweeps [0, 2) and
    [2, 5) with one generator passed along give bitwise the states and
    records of one 5-sweep run from the same seed (Queue 3's fault: a
    reseeded second chunk replays the first chunk's draws)."""
    _, rigid, _ = au
    d, sef = rigid.run.d, rigid.run.state_energy_fn
    cfg = EngineConfig(sweep_size=3, canonical=canonical)
    run = make_run_fn(d, sef, cfg)
    states = chain_states(d, 4, _au_states(4, seed=2))
    states = states._replace(energy=sef(states.site_state).surface_energy)
    temps = geometric_schedule(2.0, 5, 0.8)
    whole, rec = run(states, temps, make_generator(7, "cpu"))
    gen = make_generator(7, "cpu")
    half, rec_a = run(states, temps[:2], gen)
    end, rec_b = run(half, temps[2:], gen)
    for f in rec._fields:
        assert torch.equal(getattr(rec, f), torch.cat([getattr(rec_a, f), getattr(rec_b, f)],
                                                      dim=1)), f
    for a, b in zip(whole, end):
        assert torch.equal(a, b)
    # the fault this repairs: reseeding each chunk replays the draws
    reseeded, _ = run(half, temps[2:], make_generator(7, "cpu"))
    assert not torch.equal(reseeded.site_state, end.site_state) or \
        not torch.equal(reseeded.energy, end.energy)
    assert float(rec.accept_rate.mean()) > 0.0


def test_mcmc_run_canonical_finds_au_ground_state(au):
    _, rigid, _ = au
    cfg = EngineConfig(sweep_size=8, canonical=True, num_ads_atoms=6)
    state, rec = rigid.run.run(0, geometric_schedule(1.0, 20, 0.8), cfg=cfg, n_chains=4)
    assert (rec.n_ads == 6).all()
    assert abs(float(rec.energy.min()) - AU_REFERENCE_MIN) < 5e-3
    again, rec2 = rigid.run.run(make_generator(0, "cpu"), geometric_schedule(1.0, 20, 0.8),
                                cfg=cfg, n_chains=4)
    assert torch.equal(rec.energy, rec2.energy) and torch.equal(state.site_state,
                                                                again.site_state)


def test_criteria_and_unported_options(au):
    _, rigid, _ = au
    d, sef = rigid.run.d, rigid.run.state_energy_fn
    state = initial_state(d, torch.as_tensor(_au_states(4, seed=4)))
    state = state._replace(energy=sef(state.site_state).surface_energy)
    site = torch.tensor([0, 1, 2, 3])
    u_code = torch.zeros(4, dtype=torch.int64)
    for always in (True, False):
        step = make_semigrand_step(d, sef, criterion="testing", always_accept=always)
        _, info = step(state, 1.0, site, u_code, torch.full((4,), 0.5))
        assert bool((info.accepted == always).all())
    # the distance criteria build (their replays are in
    # tests/test_torch_criteria_mtm.py); an unknown one is refused
    for crit in ("distance", "metropolis_distance"):
        make_semigrand_step(d, sef, criterion=crit)
        make_canonical_step(d, sef, criterion=crit)
    with pytest.raises(ValueError):
        make_canonical_step(d, sef, criterion="nope")
    # multiple-try Metropolis needs the Metropolis criterion and, canonical,
    # the unweighted proposal
    make_run_fn(d, sef, EngineConfig(mtm_trials=4))
    with pytest.raises(ValueError):
        make_run_fn(d, sef, EngineConfig(mtm_trials=4, criterion="testing"))
    with pytest.raises(ValueError):
        make_run_fn(d, sef, EngineConfig(mtm_trials=4, canonical=True,
                                          require_distance_decay=True))
    with pytest.raises(ValueError):
        make_canonical_step(d, sef, require_per_atom_energies=True)


def test_even_prefill_and_site_counts_match_jax(au):
    tex, _, jex = au
    cu_t, cu_j = cu100_eam(device="cpu"), j_cu100()
    for t_spec, j_spec, k in ((tex.spec, jex.spec, 6), (cu_t.spec, cu_j.spec, 5)):
        got = even_site_prefill(t_spec, k, rng=np.random.default_rng(3))
        want = jengine.even_site_prefill(j_spec, k, rng=np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)
        assert int((got > 0).sum()) == k
    conn = np.arange(24) % 3 + 1
    ss = np.zeros(24, np.int64)
    ss[[0, 1, 4, 9]] = 1
    assert count_adsorption_sites(ss, conn) == jengine.count_adsorption_sites(ss, conn)


def test_cu_semigrand_run_through_kernel_potential():
    """On the CPU the kernel potential's energy is the plain version, the
    Chebyshev path's math: a semigrand run through it equals the run
    through ``cu100_eam(fast=True)`` step for step."""
    fast = cu100_eam(fast=True, device="cpu")
    pot = make_eam_kernel_potential(builtin_eam("Cu_u3"), fast.static_nbr, device="cpu")
    kernel = MCMCRun(fast.spec, pot, device="cpu")
    cfg = EngineConfig(sweep_size=4, record_positions=False)
    temps = geometric_schedule(1.0, 3, 0.9)
    a, rec_a = fast.run.run(5, temps, cfg=cfg, n_chains=6)
    b, rec_b = kernel.run(5, temps, cfg=cfg, n_chains=6)
    assert torch.equal(rec_a.site_state, rec_b.site_state)
    np.testing.assert_allclose(rec_a.energy.numpy(), rec_b.energy.numpy(), atol=E_TOL)
    assert int(rec_a.n_ads.max()) > 0
