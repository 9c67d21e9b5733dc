"""The port's classical potentials and EAM systems against the JAX package
on the CPU, on the same seeded numpy inputs.

* splines (``ops/splines.py``), the Cu(100) slab and spec, the dense image
  pairs, Lennard-Jones and Morse: equal to the JAX functions;
* every EAM evaluator (exact, the three static-table modes, rigid) against
  its JAX counterpart at 1e-4 eV, per-atom energies too;
* the EAM kernel's plain version (``ops/eam_kernels.eam_rho_ep_plain``)
  against the JAX Pallas kernel in interpret mode: rho and ep within atol
  1e-5 + rtol 1e-5, energies within 1e-4 eV where |E| < 999 eV (the wall's
  overlap energies reach 1e3-1e5 eV, where f32 spacing alone is ~1e-4);
* the fast modes against the exact path on physical states: poly within
  1e-4 eV, cheb within 5e-4 (the JAX package's own bound,
  tests/test_fast_eam.py; the cheb fit sits 1.9e-4 eV from the exact
  pristine energy in JAX and here alike); both over-reject overlap states;
* the physics anchors in f32: Cu and Au cohesive energies, vanishing bulk
  forces, per-atom energies summing to the total, the Cu(100) pristine pin
  and the Au(110) canonical ground state -79.0349 eV;
* the kernel potential refusing gradients, relaxation and alloys; one
  FIRE-relaxed evaluation against JAX through Cu(100)'s cheb and exact
  paths and Au(110)'s exact path.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.core import RelaxConfig as JRelaxConfig
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.ops import neighbors as jnbr
from surface_sampling_tpu.ops import splines as jsplines
from surface_sampling_tpu.ops.pallas_eam import make_pallas_eam_energy
from surface_sampling_tpu.potentials import eam as jeam
from surface_sampling_tpu.potentials import pair as jpair
from surface_sampling_tpu.structure import bulk as j_bulk
from surface_sampling_tpu.structure.slabs import fcc100 as j_fcc100
from surface_sampling_tpu.systems import au110_eam as j_au110
from surface_sampling_tpu.systems import cu100_eam as j_cu100
from surface_sampling_tpu_torch.core.energy import RelaxConfig
from surface_sampling_tpu_torch.core.engine import MCMCRun
from surface_sampling_tpu_torch.core.state import (
    realize_alive,
    realize_positions,
    realize_type_idx,
)
from surface_sampling_tpu_torch.ops import eam_kernels as ek
from surface_sampling_tpu_torch.ops import splines as tsplines
from surface_sampling_tpu_torch.ops.neighbors import (
    image_distances,
    image_pair_mask,
    pair_shifts,
)
from surface_sampling_tpu_torch.potentials import eam as team
from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones, make_morse
from surface_sampling_tpu_torch.structure import fcc100
from surface_sampling_tpu_torch.systems import au110_eam, cu100_eam

E_TOL = 1e-4              # eV, port vs JAX, f32 on both sides
FAST_TOL = 5e-4           # eV, fast modes vs exact on physical states
PRISTINE_CU100_E = -24.058476294465656    # tests/test_regression_eam.py (x64)
AU_REFERENCE_MIN = -79.03490823689619     # tests/test_regression_eam.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cu():
    """(JAX fast system, port exact system, port fast system)."""
    return j_cu100(fast=True), cu100_eam(device="cpu"), cu100_eam(fast=True, device="cpu")


@pytest.fixture(scope="module")
def tables():
    return {n: team.builtin_eam(n) for n in ("Cu_u3", "Au_u3")}


def _states(S, n, seed, empty=0.6):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, S)) < empty, 0, 1).astype(np.int64)


def _physical_states(S):
    """Pristine, single adsorbates and one far-apart pair (no overlaps)."""
    out = [np.zeros(S, np.int64)]
    for i in (0, 3, 7, 11, 20):
        out.append(np.zeros(S, np.int64))
        out[-1][i] = 1
    out.append(np.zeros(S, np.int64))
    out[-1][[0, 15]] = 1
    return np.stack(out)


def _inputs(d, ss):
    ss = torch.as_tensor(ss)
    return realize_positions(d, ss), realize_type_idx(d, ss), realize_alive(d, ss)


def _j(x):
    return jnp.asarray(np.asarray(x))


# ----------------------------------------------------------------------
# splines, slab, spec, image pairs, pair potentials
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["spline_eval", "spline_eval_rows", "spline_eval_onehot",
                                  "spline_eval_deriv"])
def test_splines_match_jax(tables, name):
    both = team.combine_tables([tables["Cu_u3"], tables["Au_u3"]])
    np.testing.assert_array_equal(tsplines.lammps_spline_coeffs(both.frho[1]),
                                  jsplines.lammps_spline_coeffs(both.frho[1]))
    single = np.asarray(tsplines.lammps_spline_coeffs(both.rhor[0]), np.float32)
    stacked = np.stack([tsplines.lammps_spline_coeffs(t) for t in both.rhor]).astype(np.float32)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, both.nr * both.dr * 1.05, (7, 33)).astype(np.float32)
    tidx = rng.integers(0, 2, (7, 33))
    t_fn, j_fn = getattr(tsplines, name), getattr(jsplines, name)
    inv = 1.0 / both.dr
    got = t_fn(torch.as_tensor(single), torch.as_tensor(x), inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_fn(_j(single), _j(x), inv)),
                               rtol=1e-6, atol=1e-7)
    got = t_fn(torch.as_tensor(stacked), torch.as_tensor(x), inv, table_idx=torch.as_tensor(tidx))
    want = j_fn(_j(stacked), _j(x), inv, table_idx=_j(tidx.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_fcc100_spec_and_image_pairs_match_jax(cu):
    jsys, tsys, _ = cu
    for size in ((2, 2, 2), (3, 2, 3)):
        a, b = fcc100("Cu", size, 3.6147), j_fcc100("Cu", size, 3.6147)
        np.testing.assert_allclose(a.positions, b.positions, atol=1e-12)
        np.testing.assert_allclose(a.cell, b.cell, atol=1e-12)
        np.testing.assert_array_equal(a.numbers, b.numbers)
    np.testing.assert_allclose(tsys.spec.site_coords, jsys.spec.site_coords, atol=1e-9)
    np.testing.assert_allclose(tsys.spec.shifts, jsys.spec.shifts, atol=1e-9)
    ss = _states(tsys.spec.n_sites, 3, seed=1)
    pos, _, alive = _inputs(tsys.run.d, ss)
    r, disp = image_distances(pos, tsys.run.d.shifts)
    mask = image_pair_mask(alive, r, 4.95)
    for c in range(3):
        jr, jdisp = jnbr.image_distances(_j(pos[c]), _j(tsys.spec.shifts.astype(np.float32)))
        np.testing.assert_allclose(r[c].numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(disp[c].numpy(), np.asarray(jdisp), atol=1e-5)
        np.testing.assert_array_equal(mask[c].numpy(),
                                      np.asarray(jnbr.image_pair_mask(_j(alive[c]), jr, 4.95)))


@pytest.mark.parametrize("kind", ["lj", "morse"])
def test_pair_potentials_match_jax(cu, kind):
    _, tsys, _ = cu
    if kind == "lj":
        tpot, jpot = make_lennard_jones(0.4, 2.3, 5.0), jpair.make_lennard_jones(0.4, 2.3, 5.0)
    else:
        tpot, jpot = make_morse(0.35, 1.4, 2.5, 5.0), jpair.make_morse(0.35, 1.4, 2.5, 5.0)
    d = tsys.run.d
    pos, ti, alive = _inputs(d, _states(tsys.spec.n_sites, 3, seed=2, empty=0.8))
    e, f = tpot.energy_and_forces(pos, ti, alive, d.shifts)
    pa = tpot.per_atom_energy(pos, ti, alive, d.shifts)
    sh = _j(tsys.spec.shifts.astype(np.float32))
    for c in range(3):
        args = (_j(pos[c]), _j(ti[c]), _j(alive[c]), sh)
        np.testing.assert_allclose(float(e[c]), float(jpot.energy(*args)), rtol=1e-5, atol=E_TOL)
        np.testing.assert_allclose(pa[c].numpy(), np.asarray(jpot.per_atom_energy(*args)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f[c].numpy(), np.asarray(jpot.forces(*args)), rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------------------------------------------
# EAM evaluators against JAX
# ----------------------------------------------------------------------
def _eam_pair(kind, tables, jsys, tsys):
    """(port potential, JAX potential) of one evaluator on Cu(100)."""
    tab = tables["Cu_u3"]
    jtab = jeam.builtin_eam("Cu_u3")
    if kind == "exact":
        return team.make_eam(tab, device="cpu"), jeam.make_eam(jtab)
    if kind == "rigid":
        return (team.make_eam_rigid(tab, tsys.spec, device="cpu"),
                jeam.make_eam_rigid(jtab, jsys.spec))
    nbr = j_build_table(jsys.spec, jtab.cutoff, relax_slack=0.05)
    return (team.make_eam_static(tab, nbr, mode=kind, device="cpu"),
            jeam.make_eam_static(jtab, nbr, mode=kind))


@pytest.mark.parametrize("kind", ["exact", "cheb", "poly", "spline", "rigid"])
def test_eam_evaluators_match_jax(cu, tables, kind):
    jsys, tsys, _ = cu
    tpot, jpot = _eam_pair(kind, tables, jsys, tsys)
    d = tsys.run.d
    ss = np.concatenate([_physical_states(tsys.spec.n_sites),
                         _states(tsys.spec.n_sites, 4, seed=3, empty=0.7)])
    pos, ti, alive = _inputs(d, ss)
    e = tpot.energy(pos, ti, alive, d.shifts)
    pa = tpot.per_atom_energy(pos, ti, alive, d.shifts)
    sh = _j(tsys.spec.shifts.astype(np.float32))
    j_e = jax.jit(jax.vmap(jpot.energy, in_axes=(0, 0, 0, None)))(
        _j(pos), _j(ti.int()), _j(alive), sh)
    j_pa = jax.jit(jax.vmap(jpot.per_atom_energy, in_axes=(0, 0, 0, None)))(
        _j(pos), _j(ti.int()), _j(alive), sh)
    np.testing.assert_allclose(e.numpy(), np.asarray(j_e), rtol=1e-6, atol=E_TOL)
    np.testing.assert_allclose(pa.numpy(), np.asarray(j_pa), rtol=1e-6, atol=E_TOL)
    assert torch.allclose(pa.sum(dim=1), e, atol=E_TOL)


def test_gather_via_matmul_is_the_same_function(cu, tables):
    jsys, tsys, _ = cu
    nbr = j_build_table(jsys.spec, 4.95, relax_slack=0.05)
    tab = tables["Cu_u3"]
    a = team.make_eam_static(tab, nbr, mode="cheb", device="cpu")
    b = team.make_eam_static(tab, nbr, mode="cheb", gather_via_matmul=True, device="cpu")
    jb = jeam.make_eam_static(jeam.builtin_eam("Cu_u3"), nbr, mode="cheb", gather_via_matmul=True)
    pos, ti, alive = _inputs(tsys.run.d, _physical_states(tsys.spec.n_sites))
    e_b = b.energy(pos, ti, alive)
    assert torch.equal(a.energy(pos, ti, alive), e_b)
    j_e = jax.vmap(jb.energy)(_j(pos), _j(ti.int()), _j(alive))
    np.testing.assert_allclose(e_b.numpy(), np.asarray(j_e), atol=E_TOL)
    with pytest.raises(ValueError):
        team.make_eam_static(tab, nbr, mode="poly", gather_via_matmul=True, device="cpu")


def _jax_rho_ep(batched_energy):
    """The Pallas kernel's own ``batched_rho_ep``, a free variable of the
    ``batched_energy`` closure that ``make_pallas_eam_energy`` returns."""
    cells = dict(zip(batched_energy.__code__.co_freevars, batched_energy.__closure__))
    return cells["batched_rho_ep"].cell_contents


@pytest.fixture(scope="module")
def jax_kernel(cu):
    jsys = cu[0]
    jtab = jeam.builtin_eam("Cu_u3")
    nbr = j_build_table(jsys.spec, jtab.cutoff, relax_slack=0.05)
    _, batched = make_pallas_eam_energy(jtab, nbr, interpret=True)
    return nbr, batched


@pytest.mark.parametrize("n_chains", [5, 70])
def test_kernel_plain_version_matches_jax_interpret(cu, tables, jax_kernel, n_chains):
    """Chain counts below and not a multiple of the TPU kernel's 64-chain
    block; seeded states mixing physical and overlap occupancies."""
    _, tsys, _ = cu
    nbr, batched = jax_kernel
    pot = ek.make_eam_kernel_potential(tables["Cu_u3"], nbr, device="cpu")
    ss = np.concatenate([_physical_states(tsys.spec.n_sites),
                         _states(tsys.spec.n_sites, n_chains, seed=n_chains, empty=0.7)])[
        :n_chains]
    pos, ti, alive = _inputs(tsys.run.d, ss)
    alive_f = alive.float()
    before = ek.eam_rho_ep.launches
    rho, ep = ek.eam_rho_ep(pos, alive_f, pot.pairs, pot.cheb)
    assert ek.eam_rho_ep.launches == before        # the CPU runs the plain version
    j_rho, j_ep = _jax_rho_ep(batched)(_j(pos), _j(alive_f))
    np.testing.assert_allclose(rho.numpy(), np.asarray(j_rho), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ep.numpy(), np.asarray(j_ep), atol=1e-5, rtol=1e-5)
    e = pot.energy(pos, ti, alive).numpy()
    j_e = np.asarray(batched(_j(pos), _j(alive_f)))
    ok = np.abs(j_e) < 999.0
    assert ok.sum() >= min(n_chains, 7)
    np.testing.assert_allclose(e[ok], j_e[ok], atol=E_TOL)
    np.testing.assert_allclose(e, j_e, rtol=1e-5, atol=E_TOL)


@pytest.mark.parametrize("mode,tol", [("cheb", FAST_TOL), ("poly", E_TOL)])
def test_fast_modes_track_exact_and_over_reject(cu, tables, mode, tol):
    """poly within 1e-4 eV of exact on physical states; cheb within the JAX
    package's 5e-4 (its degree-24 fit is 1.9e-4 eV off at the pristine
    state, in JAX too); both over-reject a fully occupied (overlapping)
    state."""
    _, tsys, tfast = cu
    nbr = tfast.static_nbr
    pot = team.make_eam_static(tables["Cu_u3"], nbr, mode=mode, device="cpu")
    d = tsys.run.d
    S = tsys.spec.n_sites
    pos, ti, alive = _inputs(d, _physical_states(S))
    e_fast = pot.energy(pos, ti, alive)
    e_exact = tsys.potential.energy(pos, ti, alive, d.shifts)
    assert float((e_fast - e_exact).abs().max()) < tol
    full = _inputs(d, np.ones((1, S), np.int64))
    e_empty = float(e_exact[0])
    assert float(pot.energy(*full)[0]) > e_empty + 50.0
    assert float(tsys.potential.energy(*full, d.shifts)[0]) > e_empty + 50.0


# ----------------------------------------------------------------------
# physics anchors in f32
# ----------------------------------------------------------------------
def _bulk(sym, a, rep):
    st = j_bulk(sym, "fcc", a=a).repeat(rep)
    pos = torch.as_tensor(st.positions, dtype=torch.float32)[None]
    shifts = torch.as_tensor(pair_shifts(st.cell, 6.0), dtype=torch.float32)
    n = len(st)
    return pos, torch.zeros((1, n), dtype=torch.int64), torch.ones((1, n), dtype=torch.bool), \
        shifts


@pytest.mark.parametrize("table,sym,a0,ecoh", [("Cu_u3", "Cu", 3.615, -3.54),
                                               ("Au_u3", "Au", 4.08, -3.93)])
def test_eam_cohesive_energy(tables, table, sym, a0, ecoh):
    """Foiles et al. PRB 33, 7983 (1986), as tests/test_potentials.py."""
    pos, ti, alive, shifts = _bulk(sym, a0, 3)
    e = float(team.make_eam(tables[table], device="cpu").energy(pos, ti, alive, shifts)[0])
    assert abs(e / pos.shape[1] - ecoh) < 2e-3


def test_eam_bulk_forces_vanish_and_per_atom_sums(tables):
    pot = team.make_eam(tables["Cu_u3"], device="cpu")
    pos, ti, alive, shifts = _bulk("Cu", 3.615, 2)
    e, f = pot.energy_and_forces(pos, ti, alive, shifts)
    assert float(f.abs().max()) < 1e-4
    pa = pot.per_atom_energy(pos, ti, alive, shifts)
    assert abs(float(pa.sum()) - float(e[0])) < E_TOL


def test_cu_pristine_pin_and_au_ground_state(cu, tables):
    _, tsys, tfast = cu
    S = tsys.spec.n_sites
    empty = torch.zeros((1, S), dtype=torch.int64)
    rigid = MCMCRun(tsys.spec, team.make_eam_rigid(tables["Cu_u3"], tsys.spec, device="cpu"),
                    device="cpu")
    kernel = MCMCRun(tsys.spec, ek.make_eam_kernel_potential(tables["Cu_u3"], tfast.static_nbr,
                                                             device="cpu"), device="cpu")
    for run, tol in ((tsys.run, E_TOL), (rigid, E_TOL), (tfast.run, FAST_TOL),
                     (kernel, FAST_TOL)):
        assert abs(float(run.state_energy_fn(empty).surface_energy[0]) - PRISTINE_CU100_E) < tol

    exact, fast = au110_eam(device="cpu"), au110_eam(fast=True, device="cpu")
    nbr = j_build_table(exact.spec, tables["Au_u3"].cutoff, relax_slack=0.05)
    au_kernel = MCMCRun(exact.spec, ek.make_eam_kernel_potential(tables["Au_u3"], nbr,
                                                                 device="cpu"), device="cpu")
    ss = np.zeros((28, 8), np.int64)
    for row, combo in enumerate(itertools.combinations(range(8), 6)):
        ss[row, list(combo)] = 1
    ss = torch.as_tensor(ss)
    mins = {name: float(run.state_energy_fn(ss).surface_energy.min())
            for name, run in (("exact", exact.run), ("rigid", fast.run), ("kernel", au_kernel))}
    assert abs(mins["exact"] - AU_REFERENCE_MIN) < E_TOL
    assert abs(mins["rigid"] - AU_REFERENCE_MIN) < E_TOL
    assert abs(mins["kernel"] - AU_REFERENCE_MIN) < 5e-3


# ----------------------------------------------------------------------
# the kernel potential: energy only, one element; relaxed Cu vs JAX
# ----------------------------------------------------------------------
def test_kernel_potential_refuses_gradients_relaxation_and_alloys(cu, tables):
    _, tsys, tfast = cu
    pot = ek.make_eam_kernel_potential(tables["Cu_u3"], tfast.static_nbr, device="cpu")
    pos, ti, alive = _inputs(tsys.run.d, _physical_states(tsys.spec.n_sites)[:2])
    with pytest.raises(NotImplementedError, match="energy only"):
        pot.energy(pos.requires_grad_(True), ti, alive)
    with pytest.raises(NotImplementedError, match="energy only"):
        pot.energy_and_forces(pos, ti, alive)
    relaxing = MCMCRun(tsys.spec, pot, device="cpu", relax=RelaxConfig(steps=2))
    with pytest.raises(NotImplementedError, match="energy only"):
        relaxing.state_energy_fn(torch.zeros((1, tsys.spec.n_sites), dtype=torch.int64))
    with pytest.raises(ValueError, match="single-element"):
        ek.make_eam_kernel_potential(team.combine_tables([tables["Cu_u3"], tables["Au_u3"]]),
                                     tfast.static_nbr, device="cpu")
    with pytest.raises(NotImplementedError):
        cu100_eam(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("system,fast", [("cu100", True), ("cu100", False), ("au110", False)])
def test_relaxed_evaluation_matches_jax(system, fast):
    """One FIRE-relaxed evaluation of two states (forces by autograd)
    against the JAX package, at the tolerances the JAX package holds its own
    two topology modes to (5e-3 eV, 1e-3 A): Cu(100) through the cheb path
    and through the exact splines over image pairs, Au(110) through the
    exact splines (the only relaxed Au path)."""
    make_t, make_j = {"cu100": (cu100_eam, j_cu100), "au110": (au110_eam, j_au110)}[system]
    tsys = make_t(fast=fast, relax=RelaxConfig(steps=8), device="cpu")
    jsys = make_j(fast=fast, relax=JRelaxConfig(steps=8))
    ss = np.zeros((2, tsys.spec.n_sites), np.int64)
    ss[0, 5 % tsys.spec.n_sites] = 1
    ss[1, [2, tsys.spec.n_sites - 1]] = 1
    out = tsys.run.state_energy_fn(torch.as_tensor(ss))
    jout = jax.jit(jax.vmap(jsys.run.state_energy_fn))(_j(ss.astype(np.int32)))
    assert np.isfinite(out.surface_energy.numpy()).all()
    np.testing.assert_allclose(out.surface_energy.numpy(), np.asarray(jout.surface_energy),
                               atol=5e-3)
    np.testing.assert_allclose(out.positions.numpy(), np.asarray(jout.positions), atol=1e-3)
    assert float((out.positions - realize_positions(tsys.run.d, torch.as_tensor(ss)))
                 .abs().max()) > 1e-3         # the slab did relax


def test_funcfl_parse_and_tables_match_jax(tables, tmp_path):
    """A funcfl file written from the Cu tables parses, combines and
    round-trips through npz as in the JAX package."""
    t = tables["Cu_u3"]
    zr = np.sqrt(np.maximum(t.z2r[0, 0], 0.0) / 14.3888)
    lines = ["Cu test", "29 63.55 3.615 fcc",
             f"{t.nrho} {t.drho!r} {t.nr} {t.dr!r} {t.cutoff!r}"]
    lines += [" ".join(repr(float(v)) for v in arr) for arr in (t.frho[0], zr, t.rhor[0])]
    path = tmp_path / "Cu_test.eam"
    path.write_text("\n".join(lines) + "\n")
    a, b = team.parse_funcfl(path), jeam.parse_funcfl(path)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    au = tables["Au_u3"]
    ta = team.tables_from_funcfl([a, {**a, "number": 79, "nr": au.nr, "dr": au.dr,
                                      "rhor": au.rhor[0], "zr": zr[:au.nr]}])
    ja = jeam.tables_from_funcfl([b, {**b, "number": 79, "nr": au.nr, "dr": au.dr,
                                      "rhor": au.rhor[0], "zr": zr[:au.nr]}])
    tc = team.combine_tables([tables["Cu_u3"], tables["Au_u3"]])
    jc = jeam.combine_tables([jeam.builtin_eam("Cu_u3"), jeam.builtin_eam("Au_u3")])
    for x, y in ((ta, ja), (tc, jc)):
        for k in ("numbers", "frho", "rhor", "z2r"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
    team.save_tables_npz(tmp_path / "t.npz", tc)
    back = team.load_tables_npz(tmp_path / "t.npz")
    np.testing.assert_array_equal(back.z2r, tc.z2r)
    assert (back.nr, back.dr, back.cutoff) == (tc.nr, tc.dr, tc.cutoff)
