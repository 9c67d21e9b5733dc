"""The port's flagship main path (SrTiO3(001) 2x2, 3-member PaiNN
ensemble, rigid semigrand MC) against the JAX package on the CPU.

The JAX side is built with pallas_routing="f32" (its Pallas kernels run
in interpret mode with exact f32 routing), so both packages compute the
same f32 function and differ only by summation order: energies of a
~470 eV total agree to 1e-3 eV. The default "bf16x2" routing carries a
constant ~3.7 meV offset (surface_sampling_tpu/ops/pallas_routing.py), so
it is held to 5e-3 eV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu import systems as jsystems
from surface_sampling_tpu.core import state as jstate
from surface_sampling_tpu.core.events import make_semigrand_step as j_make_step
from surface_sampling_tpu.ops.static_edges import static_edge_geometry as j_edge_geometry
from surface_sampling_tpu_torch.core import state as tstate
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import (
    EngineConfig,
    geometric_schedule,
    make_generator,
    make_run_fn,
)
from surface_sampling_tpu_torch.core.events import make_semigrand_step
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.ops.static_edges import static_edge_geometry
from surface_sampling_tpu_torch.parallel.chains import chain_states, make_chain_run
from surface_sampling_tpu_torch.systems import srtio3_001_painn

E_TOL = 1e-3          # eV, port vs JAX f32 routing
E_TOL_BF16X2 = 5e-3   # eV, port vs JAX default routing (~3.7 meV offset)


@pytest.fixture(scope="module")
def jsys():
    return jsystems.srtio3_001_painn(pallas_routing="f32")


@pytest.fixture(scope="module")
def tsys():
    return srtio3_001_painn(device="cpu")


@pytest.fixture(scope="module")
def jeval(jsys):
    return jax.jit(jax.vmap(jsys.run.state_energy_fn))


def _random_states(spec, seed, n, empty_frac=0.75):
    rng = np.random.default_rng(seed)
    ss = rng.integers(0, spec.n_codes, (n, spec.n_sites))
    return np.where(rng.random(ss.shape) < empty_frac, 0, ss)


def test_spec_and_static_table_match(jsys, tsys):
    js, ts = jsys.spec, tsys.spec
    for field in ("pristine_numbers", "pristine_positions", "cell", "frozen_pristine",
                  "site_coords", "code_numbers", "code_offsets", "code_natoms",
                  "element_zs", "z_to_element", "type_of_z", "shifts"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field), err_msg=field)
    assert (ts.n_pristine, ts.n_sites, ts.n_codes, ts.group_size) == (60, 64, 4, 1)
    from surface_sampling_tpu.core.static_neighbors import (
        build_static_neighbor_table as j_build_table,
    )

    jt, tt = j_build_table(js, 5.0, relax_slack=0.1), build_static_neighbor_table(ts, 5.0, 0.1)
    assert tt.max_candidates == jt.max_candidates == 120
    for a, b in zip(tt[:3], jt[:3]):
        np.testing.assert_array_equal(a, b)


def test_realized_arrays_match(jsys, tsys):
    ss = _random_states(tsys.spec, 0, 4, empty_frac=0.5)
    jd, td = jsys.run.d, tsys.run.d
    tss = torch.as_tensor(ss)
    for jfn, tfn in ((jstate.realize_numbers, tstate.realize_numbers),
                     (jstate.realize_alive, tstate.realize_alive),
                     (jstate.realize_type_idx, tstate.realize_type_idx),
                     (jstate.element_counts, tstate.element_counts)):
        want = np.stack([np.asarray(jfn(jd, jnp.asarray(s, jnp.int32))) for s in ss])
        np.testing.assert_array_equal(tfn(td, tss).numpy(), want, err_msg=tfn.__name__)
    want = np.stack([np.asarray(jstate.realize_positions(jd, jnp.asarray(s, jnp.int32)))
                     for s in ss])
    np.testing.assert_allclose(tstate.realize_positions(td, tss).numpy(), want, atol=1e-6)
    changed = tstate.change_site(tss, torch.tensor([0, 5, 9, 63]), torch.tensor([1, 2, 3, 0]))
    assert changed[:, [0, 5, 9, 63]].diagonal().tolist() == [1, 2, 3, 0]
    np.testing.assert_array_equal(tstate.num_occupied_sites(changed).numpy(),
                                  (changed.numpy() > 0).sum(1))


def test_static_edge_geometry_matches(jsys, tsys):
    """Same selected edges in the same order and the same overflow flag as
    the JAX static path; geometry to its bf16 hi/lo payload tolerance.
    The two dense states overflow; the last has every site occupied."""
    ss = np.concatenate([_random_states(tsys.spec, 1, 2, 0.75),
                         _random_states(tsys.spec, 2, 1, 0.55),
                         np.full((1, tsys.spec.n_sites), 3)])
    tss = torch.as_tensor(ss)
    (rbf, envm, nbr, unit, n_pad), (r, mask, overflow) = static_edge_geometry(
        tsys.potential.static_edge_pack, tstate.realize_alive(tsys.run.d, tss))
    jpack = jsys.potential.__dict__["static_edge_pack"]
    assert overflow.tolist() == [False, False, True, True]
    for c, s in enumerate(ss):
        alive = jstate.realize_alive(jsys.run.d, jnp.asarray(s, jnp.int32))
        mg, edges = j_edge_geometry(jpack, alive)
        assert n_pad == mg[4] == 128
        np.testing.assert_array_equal(mask[c].numpy(), np.asarray(edges[3]))
        assert bool(overflow[c]) == bool(edges[4])
        np.testing.assert_array_equal(nbr[c].numpy(), np.asarray(mg[2])[:, 0])
        np.testing.assert_allclose(rbf[c].numpy(), np.asarray(mg[0]), atol=5e-5)
        np.testing.assert_allclose(envm[c].numpy(), np.asarray(mg[1])[:, 0], atol=5e-5)
        np.testing.assert_allclose(unit[c].numpy(), np.asarray(mg[3]), atol=5e-5)
        np.testing.assert_allclose(r[c].numpy(), np.asarray(edges[1]), atol=1e-4)


def test_pristine_anchor_and_random_states(jsys, tsys, jeval):
    """Pristine: -467.52 +- 0.05 eV potential, 12.49 +- 0.02 eV surface
    energy (the reference tutorial's anchor). Seeded random occupancies:
    within E_TOL of JAX f32 routing and E_TOL_BF16X2 of its default.

    The states are sparse (90% of sites empty) and score ~100 eV. Dense
    random states put adsorbates on top of each other and score ~1e3 eV,
    almost all of it the (sigma/r)^12 excluded-volume term, which turns
    the JAX static payload's bf16 hi+lo rounding of r (~16 mantissa bits)
    into ~1e-2 eV; the port carries r as f32 rounded from f64."""
    S = tsys.spec.n_sites
    ss = np.concatenate([np.zeros((1, S), np.int64), _random_states(tsys.spec, 6, 3, 0.9)])
    out = tsys.run.state_energy_fn(torch.as_tensor(ss))
    pe, se = out.potential_energy.numpy(), out.surface_energy.numpy()
    assert abs(pe[0] + 467.52) < 0.05 and abs(se[0] - 12.49) < 0.02
    want = jeval(jnp.asarray(ss, jnp.int32))
    assert not out.oob.any() and not np.asarray(want.oob).any()
    np.testing.assert_allclose(pe, np.asarray(want.potential_energy), rtol=0, atol=E_TOL)
    np.testing.assert_allclose(se, np.asarray(want.surface_energy), rtol=0, atol=E_TOL)

    jdefault = jsystems.srtio3_001_painn()
    want_bf = jax.jit(jax.vmap(jdefault.run.state_energy_fn))(jnp.asarray(ss[1:], jnp.int32))
    np.testing.assert_allclose(se[1:], np.asarray(want_bf.surface_energy), rtol=0,
                               atol=E_TOL_BF16X2)


def test_overflow_state_is_clamped(tsys, jeval):
    """Every site occupied: the graph overflows, the network energy is
    overridden to 1e6 and the state is clamped to the OOB bound, as in
    JAX (1000 + 20 * 124 = 3480 eV)."""
    ss = np.full((1, tsys.spec.n_sites), 2)
    out = tsys.run.state_energy_fn(torch.as_tensor(ss))
    want = jeval(jnp.asarray(ss, jnp.int32))
    assert bool(out.oob[0]) and bool(want.oob[0])
    assert float(out.surface_energy[0]) == float(want.surface_energy[0]) == 3480.0


def test_step_replays_jax_draws(jsys, tsys, jeval):
    """The port's step fed the JAX step's own draws (site, code, acceptance
    uniform from the events.py key split) accepts the same moves and
    reaches the same occupancies and energies. Chains start pristine, so
    they stay among physical (non-overlapping) states."""
    n_chains, n_steps, temp = 8, 5, 3.0
    jd, sef = jsys.run.d, jsys.run.state_energy_fn
    jstep = jax.jit(jax.vmap(j_make_step(jd, sef), in_axes=(0, None)))
    S, n_codes = tsys.spec.n_sites, tsys.spec.n_codes

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    keys = jax.random.split(jax.random.PRNGKey(0), n_chains)
    ss0 = np.zeros((n_chains, S), np.int64)
    jss = jnp.asarray(ss0, jnp.int32)
    jst = jax.vmap(lambda s, k: jstate.initial_state(jd, k, s))(jss, keys)
    jst = jst._replace(energy=jeval(jss).surface_energy)
    tst = tstate.initial_state(tsys.run.d, torch.as_tensor(ss0))
    tst = tst._replace(energy=tsys.run.state_energy_fn(tst.site_state).surface_energy)
    tstep = make_semigrand_step(tsys.run.d, tsys.run.state_energy_fn)

    accepted = []
    for _ in range(n_steps):
        site, u_code, u_acc = (torch.as_tensor(np.array(x))
                               for x in jax.vmap(draws)(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = tstep(tst, temp, site.long(), u_code.long(), u_acc)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), atol=E_TOL)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()   # both branches replayed


def test_short_run_energies_reevaluate_in_jax(tsys, jeval):
    """4 chains x 2 sweeps x 4 steps through make_chain_run: every recorded
    energy is finite and is the JAX f32 energy of the recorded state."""
    d, sef = tsys.run.d, tsys.run.state_energy_fn
    crun = make_chain_run(make_run_fn(d, sef, EngineConfig(sweep_size=4)))
    states = chain_states(d, 4)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    out, recs = crun(states, geometric_schedule(3.0, 2, 0.99), make_generator(0, "cpu"))
    assert recs.energy.shape == (4, 2) and recs.positions.shape == (4, 2, 124, 3)
    assert torch.isfinite(recs.energy).all()
    flat = recs.site_state.reshape(-1, tsys.spec.n_sites).numpy()
    want = jeval(jnp.asarray(flat, jnp.int32)).surface_energy
    np.testing.assert_allclose(recs.energy.reshape(-1).numpy(), np.asarray(want), atol=E_TOL)
    np.testing.assert_array_equal(out.site_state.numpy(), recs.site_state[:, -1].numpy())


@pytest.mark.parametrize("kwargs", [{"relax": RelaxConfig(method="lbfgs"),
                                     "dtype": torch.float64},
                                    {"supercell": (2, 2), "dtype": torch.bfloat16},
                                    {"dtype": torch.float64}])
def test_unported_options_raise(kwargs):
    """The port computes in float32 only (L-BFGS, once refused here, is
    ported: tests/test_torch_relax_modes.py)."""
    with pytest.raises(NotImplementedError):
        srtio3_001_painn(device="cpu", **kwargs)


def test_per_chain_temperatures(tsys):
    """make_chain_run(share_temps=False) takes one schedule per chain: from
    the pristine minimum a near-zero temperature rejects every uphill move
    while a hot chain accepts; a shared schedule must be one-dimensional."""
    d, sef = tsys.run.d, tsys.run.state_energy_fn
    run_fn = make_run_fn(d, sef, EngineConfig(sweep_size=4, record_positions=False))
    states = chain_states(d, 2)
    states = states._replace(energy=sef(states.site_state).surface_energy)
    temps = np.array([[1e-6], [50.0]])
    _, recs = make_chain_run(run_fn, share_temps=False)(states, temps, make_generator(1, "cpu"))
    assert float(recs.accept_rate[0, 0]) == 0.0 and float(recs.accept_rate[1, 0]) > 0.0
    with pytest.raises(ValueError):
        make_chain_run(run_fn)(states, temps, make_generator(1, "cpu"))
