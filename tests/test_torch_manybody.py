"""The port's many-body classical systems against the JAX package on the
CPU: the Tersoff and Stillinger-Weber potentials (potentials/tersoff.py,
potentials/sw.py), their rigid-lattice occupancy-algebra forms
(potentials/rigid_manybody.py), the slab builders (structure/slabs.py) and
the GaN(0001) and Si(111) 5x5 systems (systems.py).

* energies within 1e-4 eV + 1e-6 relative (a few f32 spacings of the
  500-eV sums) and forces within 1e-3 eV/A of JAX's on random occupancies,
  over a static table and by the all-image search;
* the physics anchors in float32: SW Si bulk -4.3363 eV/atom, wurtzite GaN
  -4.526 eV/atom, the GaN tutorial slab -144.059 eV, the Si(111) 5x5
  pristine slab -379.42511 eV, each within 1e-3 eV (5e-3 for the last,
  the JAX package's pin);
* the rigid forms against the dynamic ones (as
  tests/test_manybody_potentials.py does) and against JAX's rigid forms;
* the slab builders equal to JAX's, the parameter-file readers equal to
  JAX's, canonical GaN runs (exact and fast) keeping n_ads.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.core.state import realize_alive as j_realize_alive
from surface_sampling_tpu.core.state import realize_positions as j_realize_positions
from surface_sampling_tpu.core.state import realize_type_idx as j_realize_type_idx
from surface_sampling_tpu.potentials import builtin_tersoff as j_builtin_tersoff
from surface_sampling_tpu.potentials import make_sw as j_make_sw
from surface_sampling_tpu.potentials import make_tersoff as j_make_tersoff
from surface_sampling_tpu.potentials import sw_tables as j_sw_tables
from surface_sampling_tpu.potentials.rigid_manybody import make_sw_rigid as j_sw_rigid
from surface_sampling_tpu.potentials.rigid_manybody import make_tersoff_rigid as j_ters_rigid
from surface_sampling_tpu.potentials.sw import load_sw_any as j_load_sw_any
from surface_sampling_tpu.potentials.sw import parse_kim_threebody as j_parse_kim
from surface_sampling_tpu.structure import bulk as j_bulk
from surface_sampling_tpu.structure import surface_from_bulk as j_surface_from_bulk
from surface_sampling_tpu.structure.slabs import diamond111 as j_diamond111
from surface_sampling_tpu.systems import gan0001_tersoff as j_gan
from surface_sampling_tpu.systems import si111_sw as j_si
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import (
    EngineConfig,
    even_site_prefill,
    geometric_schedule,
)
from surface_sampling_tpu_torch.core.state import realize_alive, realize_positions, realize_type_idx
from surface_sampling_tpu_torch.ops.neighbors import pair_shifts, pair_shifts_for
from surface_sampling_tpu_torch.potentials.rigid_manybody import make_sw_rigid, make_tersoff_rigid
from surface_sampling_tpu_torch.potentials.sw import (
    SW_SI_1985,
    load_sw_any,
    parse_kim_threebody,
    parse_sw,
    sw_tables,
    make_sw,
)
from surface_sampling_tpu_torch.potentials.tersoff import (
    builtin_tersoff,
    load_tersoff_npz,
    make_tersoff,
    save_tersoff_npz,
)
from surface_sampling_tpu_torch.structure import bulk, diamond111, surface_from_bulk
from surface_sampling_tpu_torch.systems import SI111_TUTORIAL_A, gan0001_tersoff, si111_sw

E_TOL, F_TOL = 1e-4, 1e-3          # eV, eV/A: port vs JAX, f32 on both sides
ANCHOR_TOL = 1e-3
GAN_SLAB = Path(__file__).parents[1] / "surface_sampling_tpu/systems_data/GaN_0001_3x3.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems():
    """Small GaN (2x2, 3 layers) and Si(111) (2x2) systems, port and JAX."""
    return {"tersoff": (gan0001_tersoff(size=(2, 2), layers=3, device="cpu"),
                        j_gan(size=(2, 2), layers=3)),
            "sw": (si111_sw(size=(2, 2), device="cpu"), j_si(size=(2, 2)))}


def _states(spec, n, seed, p_empty=0.6):
    rng = np.random.default_rng(seed)
    ss = rng.integers(1, spec.n_codes, (n, spec.n_sites))
    ss = np.where(rng.random(ss.shape) < p_empty, 0, ss)
    ss[0] = 0
    return ss


def _atoms(d, ss):
    ss = torch.as_tensor(ss)
    return realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss)


def _j_eval(pot, jd, ss, forces=False):
    def one(s):
        p, ti, al = j_realize_positions(jd, s), j_realize_type_idx(jd, s), j_realize_alive(jd, s)
        if forces:
            return pot.energy(p, ti, al, jd.shifts), pot.forces(p, ti, al, jd.shifts)
        return pot.energy(p, ti, al, jd.shifts), pot.per_atom_energy(p, ti, al, jd.shifts)
    return jax.jit(jax.vmap(one))(jnp.asarray(ss, jnp.int32))


def _pots(kind, static_nbr, max_neighbors=24):
    if kind == "tersoff":
        return (make_tersoff(builtin_tersoff("GaN_nord2003"), max_neighbors=max_neighbors,
                             static_nbr=static_nbr, device="cpu"),
                j_make_tersoff(j_builtin_tersoff("GaN_nord2003"), max_neighbors=max_neighbors))
    return (make_sw(sw_tables(), max_neighbors=max_neighbors, static_nbr=static_nbr,
                    device="cpu"),
            j_make_sw(j_sw_tables(), max_neighbors=max_neighbors))


@pytest.mark.parametrize("kind", ["tersoff", "sw"])
@pytest.mark.parametrize("edges", ["table", "search"])
def test_energies_and_forces_match_jax(systems, kind, edges):
    """Energies (1e-4 eV + 1e-6 relative) and forces (1e-3 eV/A) of random occupancies
    against JAX's all-image evaluation, with the port's edges ranked over
    the system's static table or found by the all-image search."""
    tsys, jsys = systems[kind]
    pot, jpot = _pots(kind, tsys.static_nbr if edges == "table" else None)
    ss = _states(tsys.spec, 4, seed=2, p_empty=0.85)
    pos, ti, alive = _atoms(tsys.run.d, ss)
    e, f = pot.energy_and_forces(pos, ti, alive, tsys.run.d.shifts)
    je, jf = _j_eval(jpot, jsys.run.d, ss, forces=True)
    assert (np.abs(np.asarray(je)) < 1e3).all()          # physical states, no overlaps
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6, atol=E_TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=F_TOL)
    if edges == "table":
        # the relax loop's fixed-topology hooks recompute the same energy
        topo = pot.edge_topology(pos, alive)
        np.testing.assert_allclose(
            pot.energy_with_edges(pos, ti, alive, edges=pot.edges_of(pos, topo)).numpy(),
            e.numpy(), rtol=0, atol=1e-5)


def test_sw_si_cohesive_energy():
    """Stillinger & Weber PRB 31, 5262 (1985): diamond Si at a = 5.431 A has
    -4.3363 eV/atom; the forces vanish by symmetry."""
    t = sw_tables()
    st = bulk("Si", "diamond", a=5.431).repeat((2, 2, 2))
    pos = torch.as_tensor(st.positions, dtype=torch.float32)[None]
    ti = torch.zeros((1, len(st)), dtype=torch.int64)
    e, f = make_sw(t, max_neighbors=20, device="cpu").energy_and_forces(
        pos, ti, torch.ones_like(ti, dtype=torch.bool),
        torch.as_tensor(pair_shifts(st.cell, t.cutoff), dtype=torch.float32))
    assert abs(float(e) / len(st) - (-4.3363)) < ANCHOR_TOL
    assert float(f.abs().max()) < 1e-3


def test_tersoff_gan_cohesive_energy_and_tutorial_slab():
    """Nord et al. (2003): wurtzite GaN -4.526 eV/atom near a = 3.19 A
    (within the JAX test's 5e-3); the reference GaN tutorial's 3x3 pristine
    slab -144.059 eV (LAMMPS) within 1e-3 eV in float32."""
    t = builtin_tersoff("GaN_nord2003")
    pot = make_tersoff(t, max_neighbors=24, device="cpu")
    gan = bulk(["Ga", "N"], "wurtzite", a=3.19, c=5.19).repeat((2, 2, 2))
    ti = torch.as_tensor([[t.elements.index(s) for s in gan.symbols]])
    e = pot.energy(torch.as_tensor(gan.positions, dtype=torch.float32)[None], ti,
                   torch.ones_like(ti, dtype=torch.bool),
                   torch.as_tensor(pair_shifts(gan.cell, t.cutoff), dtype=torch.float32))
    assert abs(float(e) / len(gan) - (-4.526)) < 5e-3
    data = np.load(GAN_SLAB)
    sym_of = {31: "Ga", 7: "N"}
    ti = torch.as_tensor([[t.elements.index(sym_of[int(z)]) for z in data["numbers"]]])
    frac = np.linalg.solve(data["cell"].T, data["positions"].T).T
    e = pot.energy(torch.as_tensor(data["positions"], dtype=torch.float32)[None], ti,
                   torch.ones_like(ti, dtype=torch.bool),
                   torch.as_tensor(pair_shifts_for(data["cell"], frac, t.cutoff),
                                   dtype=torch.float32))
    assert abs(float(e) - (-144.059)) < ANCHOR_TOL


@pytest.mark.parametrize("kind", ["tersoff", "sw"])
def test_rigid_matches_dynamic_and_jax(systems, kind):
    """The rigid forms reproduce the dynamic path on random (multi-type)
    occupancies, energies and per-atom energies, and JAX's rigid forms
    (the analogs of tests/test_manybody_potentials.py's rigid tests)."""
    tsys, jsys = systems[kind]
    spec, d = tsys.spec, tsys.run.d
    if kind == "tersoff":
        rig = make_tersoff_rigid(builtin_tersoff("GaN_nord2003"), spec, device="cpu")
        jrig = j_ters_rigid(j_builtin_tersoff("GaN_nord2003"), jsys.spec)
        ss = _states(spec, 6, seed=3, p_empty=0.3)
        ss[1], ss[2] = 1, 2                  # every site Ga, every site N
    else:
        rig = make_sw_rigid(sw_tables(), spec, device="cpu")
        jrig = j_sw_rigid(j_sw_tables(), jsys.spec)
        ss = _states(spec, 5, seed=4, p_empty=0.75)
    dyn, _ = _pots(kind, None, max_neighbors=48)     # no truncation on crowded states
    pos, ti, alive = _atoms(d, ss)
    e_d, e_r = dyn.energy(pos, ti, alive, d.shifts), rig.energy(pos, ti, alive, d.shifts)
    np.testing.assert_allclose(e_r.numpy(), e_d.numpy(), rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(rig.per_atom_energy(pos, ti, alive).numpy(),
                               dyn.per_atom_energy(pos, ti, alive, d.shifts).numpy(),
                               rtol=1e-4, atol=2e-3)
    je, jpa = _j_eval(jrig, jsys.run.d, ss)
    np.testing.assert_allclose(e_r.numpy(), np.asarray(je), rtol=1e-6, atol=E_TOL)
    np.testing.assert_allclose(rig.per_atom_energy(pos, ti, alive).numpy(), np.asarray(jpa),
                               rtol=1e-6, atol=E_TOL)


def test_slab_builders_match_jax():
    """bulk, the general Miller cut and diamond111 equal the JAX builders:
    the tutorial Si(111) 5x5, the GaN(0001) slab and a diamond (111) cut."""
    for size, bil, a in (((5, 5), 2, SI111_TUTORIAL_A), ((3, 2), 3, 5.431)):
        got, want = diamond111("Si", size, bil, a=a), j_diamond111("Si", size, bil, a=a)
        np.testing.assert_array_equal(got.positions, want.positions)
        np.testing.assert_array_equal(got.cell, want.cell)
        np.testing.assert_array_equal(got.numbers, want.numbers)
    cases = [((["Ga", "N"], "wurtzite", 3.19, 5.19), (0, 0, 1), (3, 3), 4, 12.0),
             (("Si", "diamond", 5.431, None), (1, 1, 1), (2, 2), 3, 10.0),
             (("Cu", "fcc", 3.6147, None), (1, 1, 0), (2, 1), 2, 8.0)]
    for (sym, crystal, a, c), miller, size, layers, vac in cases:
        got, m = surface_from_bulk(bulk(sym, crystal, a=a, c=c), miller, size=size,
                                   layers=layers, vacuum=vac)
        want, jm = j_surface_from_bulk(j_bulk(sym, crystal, a=a, c=c), miller, size=size,
                                       layers=layers, vacuum=vac)
        np.testing.assert_allclose(got.positions, want.positions, atol=1e-12)
        np.testing.assert_allclose(got.cell, want.cell, atol=1e-12)
        np.testing.assert_array_equal(got.numbers, want.numbers)
        np.testing.assert_array_equal(m, jm)


def test_si111_tutorial_system():
    """si111_sw() is the tutorial system: 100 atoms, the bottom 75 frozen,
    the tutorial cell, the SW85 pristine energy pinned by the JAX package
    (-379.42511 eV), fast and exact paths agreeing."""
    sys_ = si111_sw(device="cpu")
    spec = sys_.spec
    assert spec.n_pristine == 100 and int(spec.frozen_pristine.sum()) == 75
    z = spec.pristine_positions[:, 2]
    assert z[spec.frozen_pristine].max() < z[~spec.frozen_pristine].min()
    np.testing.assert_allclose(spec.cell[0, 0], 19.2463943, atol=1e-6)
    ss = torch.zeros((1, spec.n_sites), dtype=torch.int64)
    out = sys_.run.state_energy_fn(ss)
    assert not bool(out.oob[0])
    np.testing.assert_allclose(float(out.potential_energy[0]), -379.42511, atol=5e-3)
    fast = si111_sw(fast=True, device="cpu")
    ss = torch.as_tensor(_states(spec, 3, seed=5, p_empty=0.95))
    np.testing.assert_allclose(fast.run.state_energy_fn(ss).potential_energy.numpy(),
                               sys_.run.state_energy_fn(ss).potential_energy.numpy(),
                               rtol=1e-5, atol=2e-3)


def test_gan_canonical_runs_keep_n_ads():
    """Canonical GaN from an even prefill (the JAX test's smoke run), exact
    and fast: n_ads is constant, energies finite, the fast path's records
    equal a fresh exact evaluation of its states."""
    cfg = EngineConfig(sweep_size=4, canonical=True, num_ads_atoms=4, record_positions=False)
    temps = geometric_schedule(0.5, 3, 0.9)
    exact = gan0001_tersoff(size=(2, 2), layers=3, device="cpu")
    fast = gan0001_tersoff(size=(2, 2), layers=3, fast=True, device="cpu")
    ss0 = even_site_prefill(exact.spec, 4, rng=np.random.default_rng(0))
    for sys_ in (exact, fast):
        _, rec = sys_.run.run(0, temps, site_state=ss0, cfg=cfg, n_chains=4)
        assert (rec.n_ads == 4).all() and torch.isfinite(rec.energy).all()
    flat = rec.site_state.reshape(-1, exact.spec.n_sites)
    np.testing.assert_allclose(rec.energy.reshape(-1).numpy(),
                               exact.run.state_energy_fn(flat).surface_energy.numpy(),
                               rtol=1e-5, atol=2e-3)


def test_parameter_files_match_jax(tmp_path):
    """The readers give JAX's tables: a LAMMPS .sw file, a KIM
    ThreeBodyCluster file (load_sw_any sniffs both), the Tersoff npz round
    trip."""
    v = SW_SI_1985["entries"][("Si", "Si", "Si")]
    sw_text = "Si Si Si " + " ".join(str(v[f]) for f in
                                     ("eps", "sig", "a", "lam", "gam", "cos0", "A", "B", "p",
                                      "q", "tol"))
    kim_text = "1 Si\n" + " ".join(str(x) for x in (15.28, 0.6, 4.0, 0.0, 2.0951, 45.5,
                                                     2.51, -1.0 / 3.0, 3.77))
    (tmp_path / "si.sw").write_text(sw_text)
    (tmp_path / "si.params").write_text(kim_text)
    for path in ("si.sw", "si.params"):
        got, want = load_sw_any(tmp_path / path), j_load_sw_any(tmp_path / path)
        assert got.elements == want.elements
        for f in got.params:
            np.testing.assert_array_equal(got.params[f], want.params[f])
    got, want = parse_kim_threebody(kim_text), j_parse_kim(kim_text)
    np.testing.assert_array_equal(got.params["lam"], want.params["lam"])
    np.testing.assert_array_equal(parse_sw(sw_text).params["A"], sw_tables().params["A"])
    t = builtin_tersoff("GaN_nord2003")
    save_tersoff_npz(tmp_path / "t.npz", t)
    back = load_tersoff_npz(tmp_path / "t.npz")
    assert back.elements == t.elements and back.cutoff == t.cutoff


def test_relax_fixed_topology_matches_refreshed():
    """refresh_edges="once" (one topology per relaxation) lands on the
    relaxed energies of every-step re-ranking, for Tersoff and SW (the
    JAX test's 5e-3 eV)."""
    once = dict(steps=6, fmax=0.02)
    for build, kw in ((gan0001_tersoff, dict(size=(2, 2), layers=3)),
                      (si111_sw, dict(size=(2, 2)))):
        s1 = build(relax=RelaxConfig(**once, refresh_edges="once"), device="cpu", **kw)
        s2 = build(relax=RelaxConfig(**once, refresh_edges="every_step"), device="cpu", **kw)
        assert hasattr(s1.potential, "edge_topology")
        ss = torch.zeros((1, s1.spec.n_sites), dtype=torch.int64)
        ss[0, 1] = 1
        r1, r2 = s1.run.state_energy_fn(ss), s2.run.state_energy_fn(ss)
        assert not r1.oob.any() and not r2.oob.any()
        np.testing.assert_allclose(r1.potential_energy.numpy(), r2.potential_energy.numpy(),
                                   atol=5e-3)
