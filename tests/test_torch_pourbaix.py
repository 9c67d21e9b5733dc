"""The port's Pourbaix path (``pourbaix/*``, ``structure/io.py``, the new
``Structure`` methods, ``core.spec.make_spec_sampling_surface_atoms``,
``utils/sampling.py``) against the JAX package on the CPU, on the
production campaign ``campaigns/pourbaix_sriro`` (SrIrO3(001) 2x2, surface
atoms sampled) and on seeded numpy inputs.

Tolerances: host-side objects (Pourbaix atoms, compatibility corrections,
specs, schedules, structures read back) equal, floats to the last bit;
the batched Pourbaix energy against JAX's vmapped hook bit for bit (the
same f32 coefficients and the same fused multiply-add chain); a replayed
MC step under the Pourbaix energy and ``metropolis_distance``: acceptances
and occupancies equal, energies within 1e-4 eV (the model's f32 sums run
in another order; surface energies of a few hundred eV); the prefilled
campaign state's energy at the checkpoint's full width within 1e-3 eV (the
port's CHGNet tests' tolerance). Every JAX reference runs under one jit.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.core import MCMCRun as JMCMCRun
from surface_sampling_tpu.core.events import make_semigrand_step as j_semigrand_step
from surface_sampling_tpu.core.spec import make_spec_sampling_surface_atoms as j_surface_spec
from surface_sampling_tpu.core.state import MCState as JMCState
from surface_sampling_tpu.core.static_neighbors import (
    build_static_neighbor_table as j_build_table,
)
from surface_sampling_tpu.models import chgnet as jchgnet
from surface_sampling_tpu.models.convert_chgnet import load_chgnet_npz as j_load_chgnet_npz
from surface_sampling_tpu.models.nn_calculator import make_chgnet_potential as j_chgnet_pot
from surface_sampling_tpu.pourbaix import generate_pourbaix_atoms as j_generate_atoms
from surface_sampling_tpu.pourbaix import load_pourbaix_atoms as j_load_atoms
from surface_sampling_tpu.pourbaix import make_pourbaix_surface_energy as j_pourbaix_energy
from surface_sampling_tpu.pourbaix import save_pourbaix_atoms as j_save_atoms
from surface_sampling_tpu.pourbaix import compatibility as jcompat
from surface_sampling_tpu.pourbaix.utils import SurfaceOHCompatibility as JSurfaceOH
from surface_sampling_tpu.structure import Structure as JStructure
from surface_sampling_tpu.structure import find_adsorption_sites as j_find_sites
from surface_sampling_tpu.structure import io as jio
from surface_sampling_tpu.utils.sampling import create_anneal_schedule as j_anneal
from surface_sampling_tpu.utils.sampling import per_chain_schedules as j_per_chain
from surface_sampling_tpu_torch import utils as tutils
from surface_sampling_tpu_torch.constants import Z_FROM_SYMBOL
from surface_sampling_tpu_torch.core.engine import MCMCRun
from surface_sampling_tpu_torch.core.events import make_semigrand_step
from surface_sampling_tpu_torch.core.spec import make_spec_sampling_surface_atoms
from surface_sampling_tpu_torch.core.state import initial_state
from surface_sampling_tpu_torch.core.static_neighbors import build_static_neighbor_table
from surface_sampling_tpu_torch.models.chgnet import CHGNetConfig
from surface_sampling_tpu_torch.models.nn_calculator import make_chgnet_potential
from surface_sampling_tpu_torch.models.weights import from_jax_params, load_chgnet_npz
from surface_sampling_tpu_torch.pourbaix import (
    PhaseDiagramLite,
    PourbaixAtom,
    PourbaixDiagramLite,
    SurfaceOHCompatibility,
    generate_pourbaix_atoms,
    load_pourbaix_atoms,
    make_pourbaix_surface_energy,
    save_pourbaix_atoms,
)
from surface_sampling_tpu_torch.pourbaix import compatibility as tcompat
from surface_sampling_tpu_torch.structure import Structure, find_adsorption_sites
from surface_sampling_tpu_torch.structure import io as tio
from surface_sampling_tpu_torch.systems import MODEL_DATA

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
PD = ROOT / "tests/data/pourbaix/pd_dict.json"
PBX = ROOT / "tests/data/pourbaix/pbx_dict.json"
CAMPAIGN = ROOT / "campaigns/pourbaix_sriro"
SETTINGS = json.loads((CAMPAIGN / "settings.json").read_text())
ELEMENTS = SETTINGS["calc_settings"]["elements"]               # Sr, Ir, O, H
TYPES = [Z_FROM_SYMBOL[e] for e in ELEMENTS]
CONDITIONS = [(0.0, 1.0), (0.0, 0.0), (7.0, 0.5)]            # (pH, phi)
STEP_E_TOL, ANCHOR_E_TOL = 1e-4, 1e-3
FILTER = SETTINGS["sampling_settings"]["filter_distance"]
TINY = dict(atom_fea_dim=16, bond_fea_dim=16, angle_fea_dim=16, num_radial=7, num_angular=7,
            n_conv=2, max_neighbors=96, max_bond_neighbors=8, mlp_hidden_dims=(16, 16, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _campaign_spec(read_cif, find_sites, surface_spec):
    """What ``cli/sample_pourbaix_surface.py`` builds from the campaign's
    settings: the slab, its sites, the surface-atom spec and start state."""
    sys_s, samp = SETTINGS["system_settings"], SETTINGS["sampling_settings"]
    slab = read_cif(CAMPAIGN / "SrIrO3_001_2x2.cif")
    sites = find_sites(slab, planar_distance=sys_s["planar_distance"],
                       near_reduce=sys_s["near_reduce"],
                       no_obtuse_hollow=sys_s["no_obtuse_hollow"])[sys_s["ads_site_type"]]
    z = slab.positions[:, 2]
    mask = (z.max() - z) < sys_s["surface_atom_tol"]
    spec, ss0 = surface_spec(slab, mask, samp["adsorbates"], potential_numbers=TYPES,
                             cutoff=sys_s["cutoff"], extra_site_coords=sites,
                             surface_depth=sys_s["surface_depth"],
                             surface_name=sys_s["surface_name"])
    return slab, spec, ss0


@pytest.fixture(scope="module")
def campaign():
    """Both packages' campaign spec and start state, and their Pourbaix
    atoms at the campaign's (pH 0, phi 1 V)."""
    _, spec, ss0 = _campaign_spec(tio.read_cif, find_adsorption_sites,
                                  make_spec_sampling_surface_atoms)
    _, jspec, jss0 = _campaign_spec(jio.read_cif, j_find_sites, j_surface_spec)
    atoms = generate_pourbaix_atoms(PD, PBX, 1.0, 0.0, ELEMENTS)
    jatoms = j_generate_atoms(str(PD), str(PBX), 1.0, 0.0, ELEMENTS)
    return spec, ss0, jspec, jss0, atoms, jatoms


# ----------------------------------------------------------------------
# Host side: Pourbaix atoms, compatibility, specs, structures, schedules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pH, phi", CONDITIONS)
def test_generate_pourbaix_atoms_matches_jax(tmp_path, pH, phi):
    """Every field of every element's PourbaixAtom equals JAX's (the golden
    operating points of ``tests/test_pourbaix.py`` and one more), and each
    package reads the other's JSON file back equal."""
    got = generate_pourbaix_atoms(PD, PBX, phi, pH, ("Sr", "Ir", "O"))
    want = j_generate_atoms(str(PD), str(PBX), phi, pH, ("Sr", "Ir", "O"))
    assert sorted(got) == sorted(want) == ["H", "Ir", "O", "Sr"]
    for sym in got:
        assert dataclasses.asdict(got[sym]) == dataclasses.asdict(want[sym]), sym
    save_pourbaix_atoms(tmp_path / "port.json", got)
    j_save_atoms(tmp_path / "jax.json", want)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert load_pourbaix_atoms(tmp_path / "jax.json") == got
    back = j_load_atoms(tmp_path / "port.json")
    assert {k: dataclasses.asdict(v) for k, v in back.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert PourbaixAtom.from_dict(got["Ir"].as_dict()) == got["Ir"]
    if (pH, phi) == (0.0, 1.0):
        assert got["Sr"].dominant_species == "Sr[+2]" and got["Ir"].dominant_species == "IrO2"
        assert got["Ir"].delta_G2_std == pytest.approx(1.76738, rel=1e-5)


def test_diagrams_and_compatibility_match_jax():
    """The diagram readers' elemental references and stable entries, the
    MP2020 anion and GGA+U corrections (``tests/test_pourbaix.py``'s
    compositions), the oxide classification of O-O distances, the aqueous
    H2 fit and the surface-OH correction equal JAX's."""
    from surface_sampling_tpu.pourbaix.entries import PhaseDiagramLite as JPD
    from surface_sampling_tpu.pourbaix.entries import PourbaixDiagramLite as JPBX

    pd, jpd = PhaseDiagramLite.from_mson(PD), JPD.from_mson(str(PD))
    assert pd.el_refs == jpd.el_refs
    pbx, jpbx = PourbaixDiagramLite.from_mson(PBX), JPBX.from_mson(str(PBX))
    for pH, phi in CONDITIONS:
        got, want = pbx.get_stable_entry(pH, phi), jpbx.get_stable_entry(pH, phi)
        assert got.weights == want.weights
        assert [e.name for e in got.entries] == [e.name for e in want.entries]

    cases = [({"Fe": 2, "O": 3}, {"Fe": 5.3, "O": 0.0}), ({"La": 1, "Mn": 1, "O": 3},
             {"La": 0.0, "Mn": 3.9, "O": 0.0}), ({"Mn": 1, "O": 1}, {"Mn": 0.0, "O": 0.0}),
             ({"Na": 1, "Cl": 1}, None), ({"Na": 1, "Cl": 1, "O": 1}, None), ({"Cu": 4}, None),
             ({"Sr": 1, "Ir": 1, "O": 3, "H": 2}, None)]
    for comp, hub in cases:
        got = tcompat.MP2020Compatibility().get_adjustments(comp, None, hub)
        assert got == jcompat.MP2020Compatibility().get_adjustments(comp, None, hub), comp
        assert tcompat.MP2020Compatibility().process_entry_energy(-10.0, comp, None, hub) == \
            jcompat.MP2020Compatibility().process_entry_energy(-10.0, comp, None, hub)
    kinds = []
    for d in (1.30, 1.45, 2.50):
        pos = [[5, 5, 1], [5, 5, 5], [5, 5, 5 + d]]
        kinds.append(tcompat.classify_oxide(Structure.from_symbols(["Li", "O", "O"], pos,
                                                                   np.eye(3) * 10)))
        assert kinds[-1] == jcompat.classify_oxide(
            JStructure.from_symbols(["Li", "O", "O"], pos, np.eye(3) * 10))
    assert kinds == ["superoxide", "peroxide", "oxide"]
    assert tcompat.classify_oxide(None, {"Fe": 2, "O": 3}) == "oxide"
    aq, jaq = tcompat.AqueousCompatibility(), jcompat.AqueousCompatibility()
    assert aq.fit_h2_energy == jaq.fit_h2_energy
    for comp in ({"Ir": 1, "O": 1, "H": 2}, {"H": 2}, {"Ir": 1, "O": 1}):
        assert aq.process_entry_energy(-10.0, comp, -3.39) == \
            jaq.process_entry_energy(-10.0, comp, -3.39)
    for comp in ({"Ir": 4, "O": 2, "H": 2}, {"Ir": 4, "O": 2, "H": 4}, {"Ir": 4},
                 {"Ir": 4, "O": 3, "H": 1}):
        assert SurfaceOHCompatibility().get_adjustment(comp) == JSurfaceOH().get_adjustment(comp)


def test_campaign_spec_matches_jax(campaign):
    """make_spec_sampling_surface_atoms on the campaign CIF: the 8 atoms of
    the top SrO layer become pre-occupied sites ahead of the 47 empty ones
    (55 sites, 222 slots, vocabulary O, H, HO, Sr); every spec field and
    the start state equal JAX's."""
    spec, ss0, jspec, jss0, _, _ = campaign
    assert (spec.n_sites, spec.n_slots, spec.n_pristine) == (55, 222, 112)
    assert [v.name for v in spec.vocab] == ["O", "H", "HO", "Sr"]
    assert (ss0 > 0).sum() == 8 and (ss0[8:] == 0).all()
    np.testing.assert_array_equal(ss0, jss0)
    for f in dataclasses.fields(spec):
        a, b = getattr(spec, f.name), getattr(jspec, f.name)
        if f.name == "vocab":
            assert [(v.name, v.numbers) for v in a] == [(v.name, v.numbers) for v in b]
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u.offsets, v.offsets)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def _same_structure(port, jst):
    np.testing.assert_array_equal(port.numbers, jst.numbers)
    np.testing.assert_array_equal(port.positions, jst.positions)
    np.testing.assert_array_equal(port.cell, jst.cell)


def test_structure_methods_and_io_match_jax(tmp_path):
    """select, translated, + , masses and the minimum-image distances equal
    JAX's on a random triclinic cell; CIF and XYZ written by either package
    read back equal by the other; POSCAR, LAMMPS data (but the header line)
    and the structure npz bundle byte for byte or value for value."""
    rng = np.random.default_rng(11)
    cell = np.array([[7.9, 0.0, 0.0], [0.4, 7.6, 0.0], [0.3, -0.2, 12.0]])
    numbers = rng.choice([1, 8, 38, 77], 9).astype(np.int32)
    pos = rng.uniform(0, 1, (9, 3)) @ cell
    st, jst = Structure(numbers, pos, cell), JStructure(numbers, pos, cell)
    idx = [4, 0, 7]
    mask = rng.random(9) < 0.5
    for a, b in ((st.select(idx), jst.select(idx)), (st.select(mask), jst.select(mask)),
                 (st.translated([0.5, -1.0, 2.0]), jst.translated([0.5, -1.0, 2.0])),
                 (st + st.select(idx), jst + jst.select(idx)),
                 (st.sorted_by_z(), jst.sorted_by_z())):
        _same_structure(a, b)
    np.testing.assert_array_equal(st.masses, jst.masses)
    for mic in (True, False):
        np.testing.assert_array_equal(st.all_distances(mic=mic), jst.all_distances(mic=mic))

    for ext, write, jwrite, read, jread in (("cif", tio.write_cif, jio.write_cif, tio.read_cif,
                                             jio.read_cif),
                                            ("xyz", tio.write_xyz, jio.write_xyz, tio.read_xyz,
                                             jio.read_xyz)):
        write(tmp_path / f"port.{ext}", st)
        jwrite(tmp_path / f"jax.{ext}", jst)
        assert (tmp_path / f"port.{ext}").read_text() == (tmp_path / f"jax.{ext}").read_text()
        _same_structure(read(tmp_path / f"jax.{ext}"), jread(tmp_path / f"port.{ext}"))
    tio.write_poscar(tmp_path / "port.poscar", st)
    jio.write_poscar(tmp_path / "jax.poscar", jst)
    assert (tmp_path / "port.poscar").read_text() == (tmp_path / "jax.poscar").read_text()
    tio.write_lammps_data(tmp_path / "port.data", st)
    jio.write_lammps_data(tmp_path / "jax.data", jst)
    body = [p.read_text().splitlines()[1:] for p in (tmp_path / "port.data",
                                                      tmp_path / "jax.data")]
    assert body[0] == body[1]
    frames = [st, st.translated([0.1, 0.2, 0.3])]
    tio.save_structures_npz(tmp_path / "port.npz", frames, energies=[1.5, -2.0])
    back, e = jio.load_structures_npz(tmp_path / "port.npz")
    for a, b in zip(frames, back):
        _same_structure(a, b)
    jio.save_structures_npz(tmp_path / "jax.npz", [jst], energies=[3.0])
    back, e = tio.load_structures_npz(tmp_path / "jax.npz")
    _same_structure(back[0], jst)
    assert e.tolist() == [3.0]


def test_anneal_schedules_match_jax(tmp_path):
    """create_anneal_schedule (geometric, the campaign's alpha; and the
    multi-stage recipe), its CSV file, and per_chain_schedules equal JAX's."""
    samp = SETTINGS["sampling_settings"]
    for kw in (dict(start_temp=samp["start_temp"], total_sweeps=samp["total_sweeps"],
                    alpha=samp["alpha"]),
               dict(start_temp=0.2, total_sweeps=700, multiple_anneal=True)):
        np.testing.assert_array_equal(tutils.create_anneal_schedule(**kw), j_anneal(**kw))
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    tutils.create_anneal_schedule(1.0, 20, 0.9, save_folder=tmp_path / "p")
    j_anneal(1.0, 20, 0.9, save_folder=tmp_path / "j")
    assert (tmp_path / "p/anneal_schedule.csv").read_text() == \
        (tmp_path / "j/anneal_schedule.csv").read_text()
    for stagger in (0.0, 0.5):
        np.testing.assert_array_equal(tutils.per_chain_schedules(8, 30, 1.0, 0.95, stagger),
                                      j_per_chain(8, 30, 1.0, 0.95, stagger))
    # the figure is drawn where matplotlib is installed, as JAX's; without it
    # the schedule and its CSV are the same and no figure is written
    (tmp_path / "f").mkdir()
    (tmp_path / "n").mkdir()
    np.testing.assert_array_equal(
        tutils.create_anneal_schedule(1.0, 5, save_folder=tmp_path / "f", save_fig=True),
        j_anneal(1.0, 5))
    assert (tmp_path / "f/anneal_schedule.png").exists()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        tutils.create_anneal_schedule(1.0, 5, save_folder=tmp_path / "n", save_fig=True)
    assert sorted(p.name for p in (tmp_path / "n").iterdir()) == ["anneal_schedule.csv"]


# ----------------------------------------------------------------------
# Device side: the Pourbaix energy hook and the campaign's MC step
# ----------------------------------------------------------------------
def test_pourbaix_energy_defaults_to_the_card(campaign, monkeypatch):
    spec, _, _, _, atoms, _ = campaign
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pourbaix_surface_energy(spec, atoms, 1.0, 0.0)
    with pytest.raises(ValueError, match="one or two elements"):
        make_pourbaix_surface_energy(spec, atoms, 1.0, 0.0, adsorbate_corrections={"SrOH": 0.1},
                                     device=CPU)


@pytest.mark.parametrize("corrections", [None, {"OH": 0.23}, {"OH": 0.23, "H": -0.1}])
def test_pourbaix_surface_energy_matches_jax(campaign, corrections):
    """The batched hook on 64 random count vectors of the campaign's
    elements (H, O, Sr, Ir), some with more H than O (the excess taken as
    water), against JAX's hook vmapped over the same counts."""
    spec, _, jspec, _, atoms, jatoms = campaign
    assert spec.element_zs.tolist() == [1, 8, 38, 77]
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 40, (64, 4)).astype(np.float32)
    counts[:16, 0] = counts[:16, 1] + rng.integers(1, 10, 16)          # excess H
    e_pot = rng.uniform(-700.0, -600.0, 64).astype(np.float32)
    se = make_pourbaix_surface_energy(spec, atoms, phi=1.0, pH=0.0,
                                      adsorbate_corrections=corrections, device=CPU)
    jse = j_pourbaix_energy(jspec, jatoms, phi=1.0, pH=0.0, adsorbate_corrections=corrections)
    got = se(torch.as_tensor(e_pot), torch.as_tensor(counts)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jse))(jnp.asarray(e_pot), jnp.asarray(counts)))
    np.testing.assert_array_equal(got, want)
    if corrections:
        base = make_pourbaix_surface_energy(spec, atoms, 1.0, 0.0, device=CPU)
        shift = got - base(torch.as_tensor(e_pot), torch.as_tensor(counts)).numpy()
        assert (shift[16:] > 0.1).any() and (np.abs(shift[:16]) < 0.5).any()


def _replay_runs(campaign):
    """A tiny CHGNet carried from JAX, over the campaign spec's static
    candidate table, under the campaign's Pourbaix energy, in both
    packages."""
    spec, _, jspec, _, atoms, jatoms = campaign
    jcfg = jchgnet.CHGNetConfig(**TINY, conv_mode="gather")
    jparams = jchgnet.init_chgnet(jax.random.PRNGKey(7), jcfg)
    cfg = CHGNetConfig(**TINY)
    corr = SETTINGS["calc_settings"]["adsorbate_corrections"]
    table = build_static_neighbor_table(spec, 6.0, relax_slack=0.1)
    pot = make_chgnet_potential(from_jax_params(jax.tree.map(np.asarray, jparams), CPU), cfg,
                                TYPES, static_nbr=table, device=CPU)
    run = MCMCRun(spec, pot, device=CPU, surface_energy_fn=make_pourbaix_surface_energy(
        spec, atoms, 1.0, 0.0, adsorbate_corrections=corr, device=CPU))
    jpot = j_chgnet_pot(jparams, jcfg, TYPES, static_nbr=j_build_table(jspec, 6.0, relax_slack=0.1))
    jrun = JMCMCRun(jspec, jpot, surface_energy_fn=j_pourbaix_energy(
        jspec, jatoms, 1.0, 0.0, adsorbate_corrections=corr))
    return run, jrun


def test_pourbaix_mc_step_replays_jax_draws(campaign):
    """8 chains from the prefilled start state with a few random extra
    adsorbates take 4 semigrand steps under metropolis_distance (the
    campaign's 1.2 A filter) at T = 1 from the same energies; fed the JAX
    steps' own draws, the port accepts the same moves and reaches the same
    occupancies and energies."""
    run, jrun = _replay_runs(campaign)
    _, ss0, _, _, _, _ = campaign
    S, n_codes = run.spec.n_sites, run.spec.n_codes
    rng = np.random.default_rng(2)
    ss = np.tile(ss0, (8, 1)).astype(np.int64)
    extra = rng.integers(1, n_codes, (8, S))
    ss = np.where((rng.random((8, S)) < 0.06) & (np.arange(S) >= 8), extra, ss)
    tst = initial_state(run.d, torch.as_tensor(ss))
    tst = tst._replace(energy=run.state_energy_fn(tst.site_state).surface_energy)
    jss = jnp.asarray(ss, jnp.int32)
    je = jax.jit(jax.vmap(jrun.state_energy_fn))(jss)
    np.testing.assert_allclose(tst.energy.numpy(), np.asarray(je.surface_energy), rtol=0,
                               atol=STEP_E_TOL)
    jst = JMCState(site_state=jss, energy=jnp.asarray(tst.energy.numpy()),
                   relaxed_positions=je.positions, key=jax.random.split(jax.random.PRNGKey(3), 8))

    def draws(key):
        _, k_site, k_code, k_acc = jax.random.split(key, 4)
        return (jax.random.randint(k_site, (), 0, S),
                jax.random.randint(k_code, (), 0, n_codes - 1),
                jax.random.uniform(k_acc, dtype=jnp.float32))

    kw = dict(criterion="metropolis_distance", filter_distance=FILTER)
    jstep = jax.jit(jax.vmap(j_semigrand_step(jrun.d, jrun.state_energy_fn, **kw),
                             in_axes=(0, None)))
    tstep = make_semigrand_step(run.d, run.state_energy_fn, **kw)
    accepted = []
    for _ in range(4):
        site, code, u = (torch.as_tensor(np.array(x)) for x in jax.vmap(draws)(jst.key))
        jst, jinfo = jstep(jst, jnp.asarray(1.0, jnp.float32))
        tst, tinfo = tstep(tst, 1.0, site.long(), code.long(), u)
        np.testing.assert_array_equal(tinfo.accepted.numpy(), np.asarray(jinfo.accepted))
        np.testing.assert_array_equal(tst.site_state.numpy(), np.asarray(jst.site_state))
        np.testing.assert_allclose(tst.energy.numpy(), np.asarray(jst.energy), rtol=0,
                                   atol=STEP_E_TOL)
        # carry the port's energies, so that each step starts from one state
        jst = jst._replace(energy=jnp.asarray(tst.energy.numpy()))
        accepted.append(tinfo.accepted.numpy())
    accepted = np.stack(accepted)
    assert accepted.any() and not accepted.all()


def test_prefilled_energy_at_full_width_matches_jax(campaign):
    """The campaign's prefilled start state scored by the full-width CHGNet
    checkpoint (lamno3_chgnet.npz, F = 64, 4 atom convs) over the static
    candidate table under the campaign's Pourbaix energy: the port against
    JAX (conv_mode="gather")."""
    spec, ss0, jspec, jss0, atoms, jatoms = campaign
    corr = SETTINGS["calc_settings"]["adsorbate_corrections"]
    tree, cfg = load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    pot = make_chgnet_potential(from_jax_params(tree, CPU), cfg, TYPES,
                                static_nbr=build_static_neighbor_table(spec, 6.0, relax_slack=0.1),
                                device=CPU)
    run = MCMCRun(spec, pot, device=CPU, surface_energy_fn=make_pourbaix_surface_energy(
        spec, atoms, 1.0, 0.0, adsorbate_corrections=corr, device=CPU))
    got = run.state_energy_fn(torch.as_tensor(ss0)[None])
    jparams, jcfg = j_load_chgnet_npz(MODEL_DATA / "lamno3_chgnet.npz")
    jpot = j_chgnet_pot(jparams, dataclasses.replace(jcfg, conv_mode="gather"), TYPES,
                        static_nbr=j_build_table(jspec, 6.0, relax_slack=0.1))
    jrun = JMCMCRun(jspec, jpot, surface_energy_fn=j_pourbaix_energy(
        jspec, jatoms, 1.0, 0.0, adsorbate_corrections=corr))
    want = jax.jit(jrun.state_energy_fn)(jnp.asarray(jss0))
    assert abs(float(got.potential_energy[0]) - float(want.potential_energy)) <= ANCHOR_E_TOL
    assert abs(float(got.surface_energy[0]) - float(want.surface_energy)) <= ANCHOR_E_TOL
    assert np.isfinite(float(got.surface_energy[0])) and not bool(got.oob[0])
