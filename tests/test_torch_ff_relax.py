"""The port's frozen-far-field relaxation MC (core/ff_relax.py) against the
JAX package on the CPU.

Two systems: the tiny Cu PaiNN of tests/test_ff_relax.py (F = 16, two
layers, one network, carried across by ``from_jax_params``), whose one-hop
balls cover its whole cell, and the banded line toy of
tests/test_torch_relaxed_supercell.py (two members), whose balls are strict
subsets of the cell, so that the ring is frozen.

- The subproblem tables are host numpy: equal to JAX's exactly.
- With a ball that covers every slot, a move from a lattice-positioned chain
  descends the full relaxed path's objective: energies within 2e-4 eV and
  positions within 2e-3 A of the port's full relaxed path (the JAX test's
  rule).
- Steps fed the JAX steps' own draws take the same decisions and carry the
  same occupancies; energies within 5e-3 eV and positions within 1e-3 A
  (relaxed values, the tolerance of tests/test_torch_local_relax.py's
  replays); layer caches within 1e-4 of their scale.
- Slots outside the ball never move (bitwise); carried energies equal a fresh
  acceptance pass of the carried positions exactly, and the caches its layer
  inputs; a run at the MCState boundary repeats, and continues across two
  chunks, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_relaxed_supercell import toy_relax_systems

from surface_sampling_tpu.core import RelaxConfig as JRelaxConfig
from surface_sampling_tpu.core import make_spec as j_make_spec
from surface_sampling_tpu.core import make_state_energy_fn as j_make_state_energy_fn
from surface_sampling_tpu.core.ff_relax import build_ff_tables as j_build_ff_tables
from surface_sampling_tpu.core.ff_relax import make_ff_canonical_step as j_make_canonical
from surface_sampling_tpu.core.ff_relax import make_ff_init as j_make_ff_init
from surface_sampling_tpu.core.ff_relax import make_ff_relax_eval as j_make_ff_eval
from surface_sampling_tpu.core.ff_relax import make_ff_semigrand_step as j_make_semigrand
from surface_sampling_tpu.core.state import device_spec as j_device_spec
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.models.nn_calculator import make_painn_potential as j_make_potential
from surface_sampling_tpu.models.painn import PaiNNConfig as JPaiNNConfig
from surface_sampling_tpu.models.painn import init_painn as j_init_painn
from surface_sampling_tpu.structure.sites import find_adsorption_sites as j_find_sites
from surface_sampling_tpu.structure.slabs import fcc100 as j_fcc100
from surface_sampling_tpu_torch.core import state as tstate
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import MCMCRun, SweepRecord, make_generator
from surface_sampling_tpu_torch.core.ff_relax import (
    FFState,
    FFTables,
    build_ff_tables,
    make_ff_canonical_step,
    make_ff_init,
    make_ff_relax_eval,
    make_ff_run,
    make_ff_run_mcstate,
    make_ff_semigrand_step,
)
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.nn_calculator import make_painn_potential
from surface_sampling_tpu_torch.models.painn import PaiNNConfig
from surface_sampling_tpu_torch.models.weights import from_jax_params
from surface_sampling_tpu_torch.structure.sites import find_adsorption_sites
from surface_sampling_tpu_torch.structure.slabs import fcc100

E_TOL_RELAXED = 5e-3    # eV, port vs JAX after FIRE
POS_TOL_RELAXED = 1e-3  # A
CACHE_RTOL = 1e-4       # layer caches port vs JAX, of their scale
CU_CFG = dict(feat_dim=16, n_rbf=6, cutoff=3.0, n_layers=2, readout_hidden=8,
              max_neighbors=24, excl_vol=True, sigma=1.05, power=12.0)
CU_RELAX = dict(steps=8, fmax=0.02)
TOY_RELAX = dict(steps=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one torch thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cu_slab(fcc, find):
    slab = fcc("Cu", size=(2, 2, 2), a=1.5 * 2**0.5, vacuum=10.0)
    return slab, find(slab, planar_distance=1.2)["all"]


@pytest.fixture(scope="module")
def cu():
    """tests/test_ff_relax.py's system in both packages: (jspec, jd, jpot,
    jnbr, jstate_energy), (spec, run, pot, nbr)."""
    slab, sites = _cu_slab(j_fcc100, j_find_sites)
    jspec = j_make_spec(slab, sites, ["Cu"], potential_numbers=[29], cutoff=3.0)
    jcfg = JPaiNNConfig(**CU_CFG)
    params = j_init_painn(jax.random.PRNGKey(11), jcfg)
    jnbr = j_build_table(jspec, 3.0, relax_slack=0.3)
    jpot = j_make_potential(params, jcfg, [29], units="eV", static_nbr=jnbr)
    jd = j_device_spec(jspec)
    jsef = j_make_state_energy_fn(jd, jpot, relax=JRelaxConfig(**CU_RELAX))

    slab, sites = _cu_slab(fcc100, find_adsorption_sites)
    spec = make_spec(slab, sites, ["Cu"], potential_numbers=[29], cutoff=3.0)
    nbr = build_static_neighbor_table(spec, 3.0, relax_slack=0.3)
    stacked = jax.tree.map(lambda x: np.asarray(x)[None], params)
    pot = make_painn_potential(from_jax_params(stacked, "cpu"), PaiNNConfig(**CU_CFG), [29],
                               units="eV", static_nbr=nbr, device="cpu")
    run = MCMCRun(spec, pot, device="cpu", relax=RelaxConfig(**CU_RELAX))
    return (jspec, jd, jpot, jnbr, jsef), (spec, run, pot, nbr)


@pytest.fixture(scope="module")
def toy():
    (jspec, jrun, jpot), (spec, run, pot, nbr) = toy_relax_systems(TOY_RELAX)
    jnbr = j_build_table(jspec, 4.0, relax_slack=0.6)
    return (jspec, jrun.d, jpot, jnbr, jrun.state_energy_fn), (spec, run, pot, nbr)


def _sparse_states(spec, n_chains, seed, share=0.15):
    rng = np.random.default_rng(seed)
    occ = rng.random((n_chains, spec.n_sites)) < share
    return np.where(occ, rng.integers(1, spec.n_codes, occ.shape), 0).astype(np.int64)


def _engines(jsys, tsys, hops, relax_kw):
    (jspec, jd, jpot, jnbr, jsef), (spec, run, pot, nbr) = jsys, tsys
    jev = j_make_ff_eval(jd, jpot, relax=JRelaxConfig(**relax_kw),
                         tables=j_build_ff_tables(jspec, jnbr, hops))
    tables = build_ff_tables(spec, nbr, hops)
    ev = make_ff_relax_eval(run.d, pot, relax=RelaxConfig(**relax_kw), tables=tables)
    return jev, ev, tables


def _jax_states(jd, jev, jsef, ss0, seed):
    init = jax.jit(jax.vmap(j_make_ff_init(jd, jev, jsef)))
    keys = jax.random.split(jax.random.PRNGKey(seed), ss0.shape[0])
    return init(keys, jnp.asarray(ss0, jnp.int32))


def _cache_v(jcv):
    """JAX's (..., N, F, 3) vector caches as the port's x-major (..., N, 3F)."""
    jcv = np.asarray(jcv)
    return np.swapaxes(jcv, -1, -2).reshape(*jcv.shape[:-2], -1)


def _assert_states(tst, jst, caches=True):
    np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
    np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), rtol=0,
                               atol=E_TOL_RELAXED)
    np.testing.assert_allclose(tst.relaxed_positions.numpy(), np.asarray(jst.relaxed_positions),
                               atol=POS_TOL_RELAXED)
    if caches:
        for got, want in ((tst.cache_s.numpy(), np.asarray(jst.cache_s)),
                          (tst.cache_v.numpy(), _cache_v(jst.cache_v))):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=CACHE_RTOL * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("hops", [1, 2, 8])
def test_tables_match_jax(cu, toy, hops):
    """build_ff_tables equals JAX's field by field on both systems; the
    toy's one-hop balls are strict subsets of its cell."""
    for (jspec, _, _, jnbr, _), (spec, _, _, nbr) in (cu, toy):
        want, got = j_build_ff_tables(jspec, jnbr, hops), build_ff_tables(spec, nbr, hops)
        for name in FFTables._fields:
            a, b = getattr(got, name), getattr(want, name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name
    assert build_ff_tables(toy[1][0], toy[1][3], 1).ball_frac < 0.5


def test_full_ball_matches_full_relaxed_path(cu):
    """hops 8 (every slot in the ball, nothing frozen) from a fresh,
    lattice-positioned chain: one FF evaluation lands where the port's full
    relaxed path does (tests/test_ff_relax.py's parity)."""
    spec, run, pot, nbr = cu[1]
    t = build_ff_tables(spec, nbr, hops=8)
    assert t.ball_frac == 1.0
    d = run.d
    ev = make_ff_relax_eval(d, pot, relax=RelaxConfig(**CU_RELAX), tables=t)
    ss = torch.zeros((2, spec.n_sites), dtype=torch.int64)
    ffs = make_ff_init(d, ev, run.state_energy_fn)(ss)
    site = torch.tensor([3, 7])
    trial = tstate.change_site(ss, site, torch.ones(2, dtype=torch.int64))
    e_loc, _ = ev.evaluate1(trial, tstate.realize_positions(d, ss), (ffs.cache_s, ffs.cache_v),
                            site)
    e_full = run.state_energy_fn(trial)
    np.testing.assert_allclose(e_loc.surface_energy.numpy(), e_full.surface_energy.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(e_loc.positions.numpy(), e_full.positions.numpy(),
                               rtol=2e-3, atol=2e-3)
    assert torch.equal(e_loc.oob, e_full.oob) and not e_loc.oob.any()
    assert (e_loc.positions - tstate.realize_positions(d, trial)).abs().max() > 1e-3


@pytest.mark.parametrize("system", ["cu", "toy"])
def test_semigrand_step_replays_jax_draws(cu, toy, system):
    """The FF semigrand step fed the JAX step's own draws (site, code,
    acceptance uniform) from the same start states: the same acceptances
    and occupancies, energies, positions and caches at the relaxed
    tolerances."""
    jsys, tsys = (cu, cu) if system == "cu" else (toy, toy)
    jsys, tsys = jsys[0], tsys[1]
    relax_kw = CU_RELAX if system == "cu" else TOY_RELAX
    jev, ev, _ = _engines(jsys, tsys, 1, relax_kw)
    (jspec, jd, _, _, jsef), (spec, run, _, _) = jsys, tsys
    # the Cu cell is crowded (48 sites over 8 atoms): its chains start empty,
    # where a first adsorbate stays in bounds
    ss0 = _sparse_states(spec, 3, 4, share=0.15 if system == "toy" else 0.0)
    jst = _jax_states(jd, jev, jsef, ss0, 4)
    tst = make_ff_init(run.d, ev, run.state_energy_fn)(torch.as_tensor(ss0))
    _assert_states(tst, jst)
    jstep = jax.jit(jax.vmap(j_make_semigrand(jd, jev), in_axes=(0, None)))
    step = make_ff_semigrand_step(ev)
    S, n_codes = spec.n_sites, spec.n_codes

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    temp = 0.02 if system == "toy" else 0.5
    accepted, in_bounds = [], []
    for _ in range(3):
        site, u_code, u_acc = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = step(tst, temp, site.long(), u_code.long(), u_acc)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        _assert_states(tst, jst)
        accepted.append(tinfo.accepted.numpy())
        in_bounds.append(~tinfo.oob.numpy())
    assert np.stack(in_bounds).sum() >= 3             # relaxed, in-bounds trials replayed
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()      # both branches replayed


def test_canonical_step_replays_jax_draws(toy):
    """The FF canonical step (two sequential ball descents) fed the JAX
    step's own Gumbel draws: the same acceptances and occupancies (the
    composition kept), energies, positions and caches."""
    jev, ev, _ = _engines(toy[0], toy[1], 1, TOY_RELAX)
    (jspec, jd, _, _, jsef), (spec, run, _, _) = toy
    ss0 = _sparse_states(spec, 3, 6, share=0.3)
    jst = _jax_states(jd, jev, jsef, ss0, 6)
    tst = make_ff_init(run.d, ev, run.state_energy_fn)(torch.as_tensor(ss0))
    jstep = jax.jit(jax.vmap(j_make_canonical(jd, jev), in_axes=(0, None)))
    step = make_ff_canonical_step(ev)
    S, n_codes = spec.n_sites, spec.n_codes

    def draws(key):
        _, k_types, k_s1, k_s2, k_acc = jax.random.split(key, 5)
        return (jax.random.gumbel(k_types, (n_codes,)), jax.random.gumbel(k_s1, (S,)),
                jax.random.gumbel(k_s2, (S,)), jax.random.uniform(k_acc, dtype=jnp.float32))

    comp0 = np.sort(ss0, axis=1)
    accepted = []
    for _ in range(3):
        g_t, g1, g2, u = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(0.002, jnp.float32))
        tst, tinfo = step(tst, 0.002, g_t, g1, g2, u)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        _assert_states(tst, jst)
        accepted.append(tinfo.accepted.numpy())
    np.testing.assert_array_equal(np.sort(tst.site_state.numpy(), axis=1), comp0)
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()


def test_locality_carried_energies_and_runs(toy):
    """On the toy (balls strict subsets of the cell): slots outside the
    moved site's ball keep their positions bitwise and something inside
    moves; after a run the carried energies equal a fresh acceptance pass
    of the carried positions and the caches its layer inputs; the run at
    the MCState boundary repeats bitwise and continues bitwise across two
    chunks that pass one generator along."""
    spec, run, pot, nbr = toy[1]
    d = run.d
    tables = build_ff_tables(spec, nbr, 1)
    ev = make_ff_relax_eval(d, pot, relax=RelaxConfig(**TOY_RELAX), tables=tables)
    st = make_ff_init(d, ev, run.state_energy_fn)(torch.as_tensor(_sparse_states(spec, 3, 8)))
    site = torch.tensor([2, 9, 15])
    trial = tstate.change_site(st.site_state, site, torch.tensor([1, 2, 1]))
    e, _ = ev.evaluate1(trial, st.relaxed_positions, (st.cache_s, st.cache_v), site)
    for c in range(3):
        inside = np.zeros(spec.n_slots, bool)
        s = int(site[c])
        inside[tables.rows[s][:tables.n_ball][tables.row_valid[s][:tables.n_ball]]] = True
        outside = torch.as_tensor(~inside)
        assert torch.equal(e.positions[c][outside], st.relaxed_positions[c][outside])
        assert (e.positions[c] - st.relaxed_positions[c]).abs().max() > 0

    step = make_ff_semigrand_step(ev)
    out, rec = make_ff_run(step, 2, spec.n_sites, spec.n_codes)(st, np.array([0.5, 0.4]),
                                                                  make_generator(1, "cpu"))
    assert isinstance(out, FFState) and isinstance(rec, SweepRecord)
    assert rec.positions.shape == (3, 2, spec.n_slots, 3) and torch.isfinite(rec.energy).all()
    fresh, (cs, cv) = ev.finish(out.relaxed_positions, out.site_state)
    assert torch.equal(fresh.surface_energy, out.energy)
    assert torch.equal(cs, out.cache_s) and torch.equal(cv, out.cache_v)
    ss = out.site_state
    e_pot = pot.energy(out.relaxed_positions, tstate.realize_type_idx(d, ss),
                       tstate.realize_alive(d, ss))
    np.testing.assert_allclose(out.energy.numpy(), e_pot.numpy(), rtol=0, atol=1e-5)

    mrun = make_ff_run_mcstate(ev, step, 1, spec.n_sites, spec.n_codes)
    ms = tstate.MCState(site_state=st.site_state, energy=st.energy,
                        relaxed_positions=st.relaxed_positions)
    temps = np.array([0.5, 0.4])
    whole = mrun(ms, temps, make_generator(3, "cpu"))
    again = mrun(ms, temps, make_generator(3, "cpu"))
    gen = make_generator(3, "cpu")
    half, rec1 = mrun(ms, temps[:1], gen)
    fin, rec2 = mrun(half, temps[1:], gen)
    for a, b in zip(whole[0], again[0]):
        assert torch.equal(a, b)
    for a, b in zip(whole[0], fin):
        assert torch.equal(a, b)
    for a, b, c in zip(whole[1], rec1, rec2):
        assert torch.equal(a, torch.cat([b, c], dim=1))


def test_refusals(cu):
    """The TPU-only forms are refused before any work (remat, a bf16
    descent), as are an unknown routing precision and a missing table or a
    potential that is not PaiNN; the f32 forms build."""
    spec, run, pot, nbr = cu[1]
    d, t = run.d, build_ff_tables(spec, nbr, 1)
    for kw in (dict(use_remat=True), dict(descent_dtype="bf16"),
               dict(routing_precision="bf16"), dict(tables=None)):
        with pytest.raises(ValueError):
            make_ff_relax_eval(d, pot, **{"tables": t, **kw})
    with pytest.raises(ValueError):
        make_ff_relax_eval(d, object(), tables=t)
    for kw in (dict(descent_dtype="f32"), dict(routing_precision="highest"),
               dict(use_split_router=False), dict(seat_tables=build_ff_tables(spec, nbr, 0))):
        make_ff_relax_eval(d, pot, tables=t, **kw)
    ev = make_ff_relax_eval(d, pot, tables=t)
    with pytest.raises(ValueError):
        make_ff_semigrand_step(ev, criterion="distance")
    make_ff_canonical_step(ev, criterion="metropolis_distance", d=d)
