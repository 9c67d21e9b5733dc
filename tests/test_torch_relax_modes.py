"""The port's relaxation modes against the JAX package on the CPU:
L-BFGS (core/relax.lbfgs_relax, the JAX package's optax.lbfgs() with its
zoom line search, written in PyTorch), FIRE with frames
(core/relax.fire_relax_traj), the symmetric-slab energy mode and the
dual-potential relaxation (core/energy.make_state_energy_fn's
``symmetric`` / ``relax_potential``), and the local-relax canonical step.

Relaxed values are held to 5e-3 eV and 1e-3 A of JAX's (the tolerance of
the port's other relaxed paths: the optimizer amplifies summation-order
noise); FIRE frames on the Lennard-Jones dimer to 1e-5 A; rigid symmetric
energies to 1e-4 eV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_local_relax import RELAX_KW, _toy_start
from test_torch_relaxed_supercell import toy_relax_systems

from surface_sampling_tpu.core import MCMCRun as JMCMCRun
from surface_sampling_tpu.core import RelaxConfig as JRelaxConfig
from surface_sampling_tpu.core import SymmetricSlabConfig as JSymmetric
from surface_sampling_tpu.core import make_spec as j_make_spec
from surface_sampling_tpu.core.local_relax import build_ball_masks as j_build_ball_masks
from surface_sampling_tpu.core.local_relax import make_local_relax_canonical_step as j_lr_can
from surface_sampling_tpu.core.local_relax import make_local_relax_eval as j_make_eval
from surface_sampling_tpu.core.relax import FireConfig as JFireConfig
from surface_sampling_tpu.core.relax import fire_relax_traj as j_fire_traj
from surface_sampling_tpu.core.relax import lbfgs_relax as j_lbfgs
from surface_sampling_tpu.core.state import initial_state as j_initial_state
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.potentials import make_lennard_jones as j_lj
from surface_sampling_tpu.potentials.sw import SW_SI_1985 as J_SW_SI_1985
from surface_sampling_tpu.potentials.sw import sw_tables as j_sw_tables
from surface_sampling_tpu.structure.sites import find_adsorption_sites as j_find_sites
from surface_sampling_tpu.structure.slabs import fcc100 as j_fcc100
from surface_sampling_tpu.systems import si111_sw as j_si111_sw
from surface_sampling_tpu_torch.core.energy import RelaxConfig, SymmetricSlabConfig
from surface_sampling_tpu_torch.core.engine import EngineConfig, MCMCRun, geometric_schedule
from surface_sampling_tpu_torch.core.local_relax import (
    build_ball_masks,
    make_local_relax_canonical_step,
    make_local_relax_eval,
    make_local_relax_run,
)
from surface_sampling_tpu_torch.core.relax import FireConfig, fire_relax_traj, lbfgs_relax
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import (
    realize_alive,
    realize_numbers,
    realize_positions,
)
from surface_sampling_tpu_torch.parallel.chains import relaxed_chain_states
from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones
from surface_sampling_tpu_torch.potentials.sw import SW_SI_1985, sw_tables
from surface_sampling_tpu_torch.structure import fcc100, find_adsorption_sites
from surface_sampling_tpu_torch.systems import si111_sw

E_TOL_RELAXED, POS_TOL_RELAXED = 5e-3, 1e-3
FRAME_TOL = 1e-5
E_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dimer():
    """The LJ dimer of tests/test_core_engine.py: JAX and port energy
    functions of (N, 3) / (C, N, 3) positions."""
    jp, tp = j_lj(1.0, 1.0, 5.0), make_lennard_jones(1.0, 1.0, 5.0)

    def je(p):
        return jp.energy(p, jnp.zeros(2, jnp.int32), jnp.ones(2, bool), jnp.zeros((1, 3)))

    def te(p):
        C = p.shape[0]
        return tp.energy(p, torch.zeros((C, 2), dtype=torch.int64),
                         torch.ones((C, 2), dtype=torch.bool), torch.zeros((1, 3)))

    return je, te, np.array([[0.0, 0, 0], [1.4, 0, 0]], np.float32)


def test_lbfgs_relax_lj_dimer():
    """The analog of tests/test_core_engine.py's L-BFGS dimer, each chain
    against JAX: two chains, one with atom 0 frozen."""
    je, te, pos0 = _dimer()
    cfg = FireConfig(steps=60, fmax=1e-3)
    free = np.array([[True, True], [False, True]])
    res = lbfgs_relax(te, torch.as_tensor(pos0)[None].repeat(2, 1, 1), torch.as_tensor(free),
                      cfg)
    assert res.converged.all()
    d = float((res.positions[0, 1] - res.positions[0, 0]).norm())
    assert np.isclose(d, 2 ** (1 / 6), atol=1e-2)
    np.testing.assert_allclose(res.energy.numpy(), -1.0, atol=1e-3)
    assert torch.equal(res.positions[1, 0], torch.zeros(3))
    for c in range(2):
        want = j_lbfgs(je, jnp.asarray(pos0), jnp.asarray(free[c]), JFireConfig(steps=60,
                                                                                 fmax=1e-3))
        assert int(res.n_steps[c]) == int(want.n_steps)
        np.testing.assert_allclose(float(res.energy[c]), float(want.energy),
                                   atol=E_TOL_RELAXED)
        np.testing.assert_allclose(res.positions[c].numpy(), np.asarray(want.positions),
                                   atol=POS_TOL_RELAXED)


def _lj_runs(relax_kw):
    """tests/test_core_engine.py's LJ(100) system (ontop + hollow sites),
    relaxed: the JAX and port MCMCRuns."""
    def build(mk_fcc, mk_sites, mk_spec, lj):
        slab = mk_fcc("Cu", size=(2, 2, 2), a=1.5 * 2 ** 0.5, vacuum=10.0)
        sites = mk_sites(slab, planar_distance=1.2)["all"]
        spec = mk_spec(slab, sites, ["Cu"], potential_numbers=[29], cutoff=3.0)
        return spec, lj(epsilon=0.4, sigma=1.05, cutoff=3.0)

    jspec, jpot = build(j_fcc100, j_find_sites, j_make_spec, j_lj)
    spec, pot = build(fcc100, find_adsorption_sites, make_spec, make_lennard_jones)
    return (JMCMCRun(jspec, jpot, relax=JRelaxConfig(**relax_kw)),
            MCMCRun(spec, pot, device="cpu", relax=RelaxConfig(**relax_kw)))


def test_lbfgs_relaxed_states_match_jax():
    """L-BFGS inside the state energy, batched over chains, each chain with
    its own line search: relaxed energies and positions of random
    occupancies against JAX's, and some chains stop before others."""
    jrun, run = _lj_runs(dict(steps=8, fmax=0.05, method="lbfgs"))
    rng = np.random.default_rng(0)
    S = run.spec.n_sites
    ss = (rng.random((5, S)) < 0.3).astype(np.int64)
    ss[0] = 0
    want = jax.jit(jax.vmap(jrun.state_energy_fn))(jnp.asarray(ss, jnp.int32))
    got = run.state_energy_fn(torch.as_tensor(ss))
    np.testing.assert_array_equal(got.oob.numpy(), np.asarray(want.oob))
    np.testing.assert_allclose(got.surface_energy.numpy(), np.asarray(want.surface_energy),
                               atol=E_TOL_RELAXED)
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions),
                               atol=POS_TOL_RELAXED)
    moved = (got.positions - realize_positions(run.d, torch.as_tensor(ss))).abs().amax((1, 2))
    assert (moved > 1e-3).any()


def test_run_with_lbfgs_relaxation():
    """The analog of tests/test_core_engine.py's L-BFGS run: a whole run
    through MCMCRun, finite records, each recorded state's energy equal to
    JAX's relaxed evaluation of it."""
    jrun, run = _lj_runs(dict(steps=5, fmax=0.05, method="lbfgs"))
    temps = geometric_schedule(0.3, 2, alpha=0.9)
    state, rec = run.run(0, temps, cfg=EngineConfig(sweep_size=3), n_chains=3)
    assert torch.isfinite(rec.energy).all()
    flat = rec.site_state.reshape(-1, run.spec.n_sites).numpy()
    want = jax.jit(jax.vmap(jrun.state_energy_fn))(jnp.asarray(flat, jnp.int32))
    np.testing.assert_allclose(rec.energy.reshape(-1).numpy(), np.asarray(want.surface_energy),
                               atol=E_TOL_RELAXED)


def test_fire_relax_traj_matches_jax():
    """The analog of tests/test_extras.py's trajectory test: 40 FIRE steps of
    the LJ dimer recorded every 5th, frames within 1e-5 A of JAX's, the
    energies falling, the relaxed energy -1."""
    je, te, pos0 = _dimer()
    cfg = FireConfig(steps=40, fmax=1e-3)
    res, frames, frame_e = fire_relax_traj(te, torch.as_tensor(pos0)[None].repeat(2, 1, 1),
                                           torch.tensor([[True, True], [False, True]]), cfg, 5)
    assert frames.shape == (2, 8, 2, 3) and frame_e.shape == (2, 8)
    assert (frame_e[:, -1] <= frame_e[:, 0]).all()
    np.testing.assert_allclose(res.energy.numpy(), -1.0, atol=1e-2)
    for c, free in enumerate(([True, True], [False, True])):
        jres, jframes, jfe = j_fire_traj(je, jnp.asarray(pos0), jnp.asarray(free),
                                         JFireConfig(steps=40, fmax=1e-3), record_interval=5)
        np.testing.assert_allclose(frames[c].numpy(), np.asarray(jframes), atol=FRAME_TOL)
        np.testing.assert_allclose(frame_e[c].numpy(), np.asarray(jfe), atol=E_TOL)
        np.testing.assert_allclose(res.positions[c].numpy(), np.asarray(jres.positions),
                                   atol=FRAME_TOL)


def _symmetric_runs(relax_kw=None):
    """tests/test_extras.py's symmetric Cu(100) 2x2x2 LJ slab with one top
    site: (JAX run, port run, port plain run, base_z)."""
    def build(mk_fcc, mk_spec, lj):
        slab = mk_fcc("Cu", size=(2, 2, 2), a=3.6, vacuum=20.0).sorted_by_z()
        sites = np.array([[0.0, 0.0, slab.positions[:, 2].max() + 1.8]])
        spec = mk_spec(slab, sites, ["Cu"], potential_numbers=[29], cutoff=3.5)
        return slab, spec, lj(epsilon=0.4, sigma=2.2, cutoff=3.5)

    _, jspec, jpot = build(j_fcc100, j_make_spec, j_lj)
    slab, spec, pot = build(fcc100, make_spec, make_lennard_jones)
    base_z = float(slab.positions[:4, 2].mean())
    jrelax = JRelaxConfig(**relax_kw) if relax_kw else None
    relax = RelaxConfig(**relax_kw) if relax_kw else None
    return (JMCMCRun(jspec, jpot, symmetric=JSymmetric(base_z=base_z, n_base=4), relax=jrelax),
            MCMCRun(spec, pot, device="cpu", relax=relax,
                    symmetric=SymmetricSlabConfig(base_z=base_z, n_base=4)),
            MCMCRun(spec, pot, device="cpu"), base_z)


def test_symmetric_slab_energy_mode():
    """The analog of tests/test_extras.py's symmetric-slab test: the energy
    equals a direct evaluation of the manually mirrored structure and
    JAX's, and differs from the plain slab's."""
    jrun, run, plain, base_z = _symmetric_runs()
    ss = torch.tensor([[1], [0]])
    out = run.state_energy_fn(ss)
    d = run.d
    pos, alive = realize_positions(d, ss), realize_alive(d, ss)
    refl = pos.clone()
    refl[..., 2] = 2 * base_z - refl[..., 2]
    full_pos, full_alive = torch.cat([pos, refl[:, 4:]], 1), torch.cat([alive, alive[:, 4:]], 1)
    e_manual = plain.potential.energy(full_pos, torch.zeros_like(full_alive, dtype=torch.int64),
                                      full_alive, d.shifts)
    np.testing.assert_allclose(out.potential_energy.numpy(), e_manual.numpy(), rtol=1e-6)
    want = jax.vmap(jrun.state_energy_fn)(jnp.asarray(ss.numpy(), jnp.int32))
    np.testing.assert_allclose(out.surface_energy.numpy(), np.asarray(want.surface_energy),
                               atol=E_TOL)
    assert (plain.state_energy_fn(ss).potential_energy - out.potential_energy).abs().min() > 1e-3
    assert realize_numbers(d, ss).shape[1] == 9


def test_symmetric_slab_relaxed_matches_jax():
    """FIRE-relaxed symmetric slabs: the top half relaxes with the mirror
    re-derived at every force call; energies and positions against JAX's,
    and the relaxation moved something."""
    jrun, run, _, _ = _symmetric_runs(dict(steps=10, fmax=0.01))
    ss = torch.tensor([[1], [0]])
    got = run.state_energy_fn(ss)
    want = jax.vmap(jrun.state_energy_fn)(jnp.asarray(ss.numpy(), jnp.int32))
    np.testing.assert_allclose(got.surface_energy.numpy(), np.asarray(want.surface_energy),
                               atol=E_TOL_RELAXED)
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions),
                               atol=POS_TOL_RELAXED)
    assert (got.positions - realize_positions(run.d, ss)).abs().max() > 1e-3


def _modified_sw(sw_si, make_tables):
    """tests/test_manybody_potentials.py's 'modified SW': the three-body
    term strengthened 30%."""
    entry = dict(sw_si["entries"][("Si", "Si", "Si")])
    entry["lam"] *= 1.3
    return make_tables({"elements": ("Si",), "entries": {("Si", "Si", "Si"): entry}})


def test_si111_dual_potential_relax():
    """The analog of tests/test_manybody_potentials.py's dual-potential
    test on the Si(111) 2x2: relaxed under the modified SW, scored under
    SW85; energies and positions against JAX's; relaxing under SW85 itself
    does at least as well (the variational inequality), and the split is
    live (the geometries differ)."""
    relax = dict(steps=15, fmax=0.02)
    rt = _modified_sw(SW_SI_1985, sw_tables)
    sys_a = si111_sw(size=(2, 2), relax=RelaxConfig(**relax), device="cpu")
    sys_b = si111_sw(size=(2, 2), relax=RelaxConfig(**relax), relax_model=rt, device="cpu")
    jb = j_si111_sw(size=(2, 2), relax=JRelaxConfig(**relax),
                    relax_model=_modified_sw(J_SW_SI_1985, j_sw_tables))
    ss = torch.zeros((2, sys_a.spec.n_sites), dtype=torch.int64)
    ss[0, 0], ss[1, 3] = 1, 1
    out_a, out_b = sys_a.run.state_energy_fn(ss), sys_b.run.state_energy_fn(ss)
    want = jax.jit(jax.vmap(jb.run.state_energy_fn))(jnp.asarray(ss.numpy(), jnp.int32))
    np.testing.assert_allclose(out_b.potential_energy.numpy(),
                               np.asarray(want.potential_energy), atol=E_TOL_RELAXED)
    np.testing.assert_allclose(out_b.positions.numpy(), np.asarray(want.positions),
                               atol=POS_TOL_RELAXED)
    assert torch.isfinite(out_a.potential_energy).all()
    assert (out_a.potential_energy <= out_b.potential_energy + 1e-4).all()
    assert float((out_a.positions - out_b.positions).abs().max()) > 1e-5


@pytest.fixture(scope="module")
def toy():
    return toy_relax_systems(RELAX_KW)


@pytest.mark.parametrize("method", ["fire", "lbfgs"])
def test_local_relax_canonical_step_replays_jax_draws(toy, method):
    """The local-relax canonical step on the banded toy (one-hop balls
    around both exchanged sites), fed the JAX step's own draws from the
    same relaxed start states: the same decisions and occupancies, energies
    and relaxed positions within the relaxed tolerances; FIRE and L-BFGS."""
    (jspec, jrun, jpot), (spec, run, pot, nbr) = toy
    d, jd = run.d, jrun.d
    relax = dict(RELAX_KW, method=method)
    balls = build_ball_masks(spec, nbr, 1)
    jeval = j_make_eval(jd, jpot, relax=JRelaxConfig(**relax),
                        ball_masks=j_build_ball_masks(jspec, j_build_table(jspec, 4.0, 0.6), 1))
    jstep = jax.jit(jax.vmap(j_lr_can(jd, jeval), in_axes=(0, None)))
    S, n_codes = spec.n_sites, spec.n_codes

    def draws(key):
        _, k_types, k_s1, k_s2, k_acc = jax.random.split(key, 5)
        return (jax.random.gumbel(k_types, (n_codes,)), jax.random.gumbel(k_s1, (S,)),
                jax.random.gumbel(k_s2, (S,)), jax.random.uniform(k_acc, dtype=jnp.float32))

    ss0 = _toy_start(spec)
    n_chains, temp = ss0.shape[0], 0.05
    jss = jnp.asarray(ss0, jnp.int32)
    first = jax.jit(jax.vmap(jrun.state_energy_fn))(jss)
    keys = jax.random.split(jax.random.PRNGKey(6), n_chains)
    jst = jax.vmap(lambda s, k: j_initial_state(jd, k, s))(jss, keys)
    jst = jst._replace(energy=first.surface_energy, relaxed_positions=first.positions)
    tst = relaxed_chain_states(d, run.state_energy_fn, n_chains, ss0)
    step = make_local_relax_canonical_step(
        make_local_relax_eval(d, pot, relax=RelaxConfig(**relax), ball_masks=balls))
    accepted = []
    for _ in range(3):
        dr = [torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key)]
        jst, jinfo = jstep(jst, jnp.asarray(temp, jnp.float32))
        tst, tinfo = step(tst, temp, *dr)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), rtol=0,
                                   atol=E_TOL_RELAXED)
        np.testing.assert_allclose(tst.relaxed_positions.numpy(),
                                   np.asarray(jst.relaxed_positions), atol=POS_TOL_RELAXED)
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any()
    np.testing.assert_array_equal((tst.site_state > 0).sum(1).numpy(), (ss0 > 0).sum(1))
    run_fn = make_local_relax_run(step, 2, S, n_codes, canonical=True)
    out, rec = run_fn(tst, np.array([0.05]), torch.Generator().manual_seed(0))
    assert torch.isfinite(rec.energy).all()
    np.testing.assert_array_equal((out.site_state > 0).sum(1).numpy(), (ss0 > 0).sum(1))
