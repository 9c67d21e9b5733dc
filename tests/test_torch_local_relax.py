"""The port's warm-started ball-local relaxation MC (core/local_relax.py)
against the JAX package and against the port's own full relaxed path, on
the CPU.

- The ball masks are host tables: equal to JAX's exactly.
- With a ball that covers every slot, a move from a lattice-positioned chain
  runs the full relaxed path's computation: equal bitwise (the analog of
  tests/test_local_relax.py's full-ball parity, at 1x1 with one member).
- Steps fed the JAX step's own draws (site, code, acceptance uniform) on the
  banded toy of tests/test_torch_relaxed_supercell.py must take the same
  decisions and reach the same occupancies; energies within 5e-3 eV and
  positions within 1e-3 A (relaxed values, as there).
- Locality: slots outside the ball keep their positions bitwise, rejected
  moves keep the chain's positions bitwise, and carried energies equal a
  fresh evaluation of the carried geometry to 1e-5 eV (the JAX package's
  own rule: the same evaluator, so in practice exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_relaxed_supercell import toy_relax_systems

from surface_sampling_tpu.core.local_relax import build_ball_masks as j_build_ball_masks
from surface_sampling_tpu.core.local_relax import make_local_relax_eval as j_make_eval
from surface_sampling_tpu.core.local_relax import (
    make_local_relax_semigrand_step as j_make_step,
)
from surface_sampling_tpu.core.state import initial_state as j_initial_state
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu_torch.core import state as tstate
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import SweepRecord, make_generator
from surface_sampling_tpu_torch.core.local_relax import (
    build_ball_masks,
    make_local_relax_canonical_step,
    make_local_relax_eval,
    make_local_relax_run,
    make_local_relax_semigrand_step,
)
from surface_sampling_tpu_torch.parallel.chains import relaxed_chain_states
from surface_sampling_tpu_torch.systems import srtio3_001_painn

E_TOL_RELAXED = 5e-3    # eV, port vs JAX after FIRE
POS_TOL_RELAXED = 1e-3  # A
CARRY_TOL = 1e-5        # eV, carried energy vs a fresh evaluation
RELAX_KW = dict(steps=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work in this module is many small tensor ops: with
    other test processes on the machine, torch's intra-op threads mostly
    wait on each other, so the module runs them on one thread (restored
    afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship():
    return srtio3_001_painn(relax=RelaxConfig(steps=8), n_models=1, device="cpu")


@pytest.fixture(scope="module")
def toy():
    return toy_relax_systems(RELAX_KW)


def _toy_start(spec):
    ss = np.zeros((3, spec.n_sites), np.int64)
    ss[0, 2], ss[1, [3, 9]], ss[2, ::3] = 1, [1, 2], 2
    return ss


def test_ball_masks_match_jax(flagship):
    """(g) build_ball_masks on the 1x1 relax table (slack 0.6) equals
    JAX's, one and two hops; every ball holds its site's own slots."""
    spec = flagship.spec
    jtable = j_build_table(spec, 5.0, relax_slack=0.6)
    for hops in (1, 2):
        got = build_ball_masks(spec, flagship.static_nbr, hops)
        np.testing.assert_array_equal(got, j_build_ball_masks(spec, jtable, hops))
    balls = build_ball_masks(spec, flagship.static_nbr, 1)
    P, G = spec.n_pristine, spec.group_size
    assert balls.shape == (spec.n_sites, spec.n_slots)
    assert all(balls[s, P + s * G: P + (s + 1) * G].all() for s in range(spec.n_sites))


def test_full_ball_equals_full_relaxed_path(flagship):
    """(d) 1x1, one member, 8 FIRE steps: with hops large enough that every
    ball covers the cell, one local-relax evaluation from a fresh
    (lattice-positioned) chain equals the full relaxed path's evaluation
    of the trial state bitwise: surface energy, positions and oob."""
    d, run = flagship.run.d, flagship.run
    balls = build_ball_masks(flagship.spec, flagship.static_nbr, hops=6)
    assert balls.all()
    evaluate = make_local_relax_eval(d, flagship.potential, run.surface_energy_fn,
                                     RelaxConfig(steps=8), balls)
    ss = torch.zeros((1, flagship.spec.n_sites), dtype=torch.int64)
    trial = tstate.change_site(ss, torch.tensor([3]), torch.tensor([1]))
    e_loc = evaluate(trial, tstate.realize_positions(d, ss), torch.tensor([[3, 3]]))
    e_full = run.state_energy_fn(trial)
    assert torch.equal(e_loc.surface_energy, e_full.surface_energy)
    assert torch.equal(e_loc.positions, e_full.positions)
    assert torch.equal(e_loc.oob, e_full.oob) and not bool(e_loc.oob[0])
    assert (e_loc.positions - tstate.realize_positions(d, trial)).abs().max() > 1e-3


def test_step_replays_jax_draws(toy):
    """(e) The port's local-relax semigrand step on the banded toy (one hop
    balls), fed the JAX local-relax step's own draws from the same relaxed
    start states, accepts the same moves and carries the same occupancies,
    energies and relaxed positions."""
    (jspec, jrun, jpot), (spec, run, pot, nbr) = toy
    d, jd = run.d, jrun.d
    balls = build_ball_masks(spec, nbr, 1)
    assert not balls.all()
    ss0 = _toy_start(spec)
    n_chains, n_steps, temp = ss0.shape[0], 4, 0.05
    jeval = j_make_eval(jd, jpot, relax=jrun.relax,
                        ball_masks=j_build_ball_masks(jspec, j_build_table(jspec, 4.0, 0.6), 1))
    jstep = jax.jit(jax.vmap(j_make_step(jd, jeval), in_axes=(0, None)))
    S, n_codes = spec.n_sites, spec.n_codes

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    jss = jnp.asarray(ss0, jnp.int32)
    first = jax.jit(jax.vmap(jrun.state_energy_fn))(jss)
    keys = jax.random.split(jax.random.PRNGKey(4), n_chains)
    jst = jax.vmap(lambda s, k: j_initial_state(jd, k, s))(jss, keys)
    jst = jst._replace(energy=first.surface_energy, relaxed_positions=first.positions)
    tst = relaxed_chain_states(d, run.state_energy_fn, n_chains, ss0)
    np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), atol=E_TOL_RELAXED)
    step = make_local_relax_semigrand_step(
        make_local_relax_eval(d, pot, relax=RelaxConfig(**RELAX_KW), ball_masks=balls))
    accepted = []
    for _ in range(n_steps):
        site, u_code, u_acc = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = step(tst, temp, site.long(), u_code.long(), u_acc)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), rtol=0,
                                   atol=E_TOL_RELAXED)
        np.testing.assert_allclose(tst.relaxed_positions.numpy(),
                                   np.asarray(jst.relaxed_positions), atol=POS_TOL_RELAXED)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()      # both branches replayed


def test_locality_rollback_and_carried_energies(toy):
    """(f) On the banded toy with one-hop balls: a local evaluation moves
    nothing outside the moved site's ball (bitwise) and something inside;
    over a short run every rejected move keeps the chain's positions
    bitwise, the record has the engine's schema, and the carried energies
    equal a fresh evaluation of the carried geometry."""
    _, (spec, run, pot, nbr) = toy
    d = run.d
    balls = build_ball_masks(spec, nbr, 1)
    evaluate = make_local_relax_eval(d, pot, relax=RelaxConfig(**RELAX_KW), ball_masks=balls)
    states = relaxed_chain_states(d, run.state_energy_fn, 3, _toy_start(spec))
    site = torch.tensor([5, 12, 0])
    trial = tstate.change_site(states.site_state, site, torch.tensor([2, 1, 1]))
    e = evaluate(trial, states.relaxed_positions, torch.stack([site, site], 1))
    for c in range(3):
        outside = torch.as_tensor(~balls[int(site[c])])
        assert torch.equal(e.positions[c][outside], states.relaxed_positions[c][outside])
        assert (e.positions[c] - states.relaxed_positions[c]).abs().max() > 0

    step = make_local_relax_semigrand_step(evaluate)
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        draws = (torch.randint(0, spec.n_sites, (3,), generator=g),
                 torch.randint(0, spec.n_codes - 1, (3,), generator=g),
                 torch.rand((3,), generator=g))
        new, info = step(states, 0.05, *draws)
        rejected = ~info.accepted
        assert torch.equal(new.relaxed_positions[rejected], states.relaxed_positions[rejected])
        assert torch.equal(new.site_state[rejected], states.site_state[rejected])
        states = new
    run_fn = make_local_relax_run(step, 2, spec.n_sites, spec.n_codes)
    out, rec = run_fn(states, np.array([0.05, 0.04]), make_generator(1, "cpu"))
    assert isinstance(rec, SweepRecord) and rec.positions.shape == (3, 2, spec.n_slots, 3)
    assert torch.isfinite(rec.energy).all()
    ss = out.site_state
    fresh = pot.energy(out.relaxed_positions, tstate.realize_type_idx(d, ss),
                       tstate.realize_alive(d, ss))
    np.testing.assert_allclose(out.energy.numpy(), fresh.numpy(), rtol=0, atol=CARRY_TOL)


def test_unported_options_raise(toy):
    """The steps take only the Metropolis and metropolis_distance criteria,
    the latter with the DeviceSpec; the canonical step, a separate relax
    potential and L-BFGS build (their parity is in
    tests/test_torch_relax_modes.py); an unknown relax method is refused and
    a ball table is required."""
    _, (spec, run, pot, nbr) = toy
    d, balls = run.d, build_ball_masks(spec, nbr, 1)
    evaluate = make_local_relax_eval(d, pot, ball_masks=balls)
    make_local_relax_canonical_step(evaluate)
    with pytest.raises(ValueError):
        make_local_relax_semigrand_step(evaluate, criterion="distance")
    with pytest.raises(ValueError):
        make_local_relax_semigrand_step(evaluate, criterion="metropolis_distance")
    make_local_relax_semigrand_step(evaluate, criterion="metropolis_distance", d=d)
    make_local_relax_eval(d, pot, ball_masks=balls, relax_potential=pot)
    make_local_relax_eval(d, pot, relax=RelaxConfig(method="lbfgs"), ball_masks=balls)
    with pytest.raises(ValueError):
        make_local_relax_eval(d, pot, relax=RelaxConfig(method="bfgs"), ball_masks=balls)
    with pytest.raises(ValueError):
        make_local_relax_eval(d, pot)
