"""The port's sampling CLI (``cli/common.py`` and the drivers
``sample_surface``, ``sample_pourbaix_surface``, ``sample_bulk``,
``predict``) against the JAX package's on the CPU (``--device cpu``).

Shapes: the ``cu_setup`` of ``tests/test_cli.py`` (Cu(100) 2x2x2, EAM, 2
chains, 2-8 sweeps of 2 steps), a toy SrIrO slab with Lennard-Jones for
the Pourbaix driver, bulk Cu for the bulk driver, and the Ti strip with a
tiny PaiNN of ``tests/test_cli.py``'s incremental tests (4 A cutoff: the
smallest cell that bands) for the delta, local-relax and frozen-far-field
branches.

What is held against JAX, where the function is deterministic: the
assembled spec, the anneal schedule and the ``temp`` column of stats.csv
(bitwise, ``t_min`` included), the even prefill (bitwise), the stats.csv
header, the history.npz keys and shapes, the sampling_quality.json keys
and the set of artifact files; every energy of the port's history against
JAX's ``state_energy_fn`` on the same site states (1e-4 eV for EAM and
Lennard-Jones, 1e-3 eV for PaiNN on the f32 path); predict's energies and
forces (1e-4). Where the draws differ (one torch.Generator against per-chain
JAX keys), the port is held against itself: ``--resume`` is bitwise for
plain, chunked, tempered and population-annealing runs, and for the delta,
local-relax and FF engines; checkpointed energies equal a fresh evaluation.
Each JAX reference is computed once per module.
"""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.cli import common as jcommon
from surface_sampling_tpu.cli.predict import main as j_predict
from surface_sampling_tpu.cli.sample_surface import main as j_sample_surface
from surface_sampling_tpu.structure.io import read_cif as j_read_cif
from surface_sampling_tpu_torch.cli import common
from surface_sampling_tpu_torch.cli.predict import main as predict
from surface_sampling_tpu_torch.cli.sample_bulk import main as sample_bulk
from surface_sampling_tpu_torch.cli.sample_pourbaix_surface import main as sample_pourbaix
from surface_sampling_tpu_torch.cli.sample_surface import main as sample_surface
from surface_sampling_tpu_torch.io import load_checkpoint
from surface_sampling_tpu_torch.models.painn import PaiNNConfig, init_ensemble, init_painn
from surface_sampling_tpu_torch.models.weights import save_painn_npz
from surface_sampling_tpu_torch.potentials.eam import builtin_eam, save_tables_npz
from surface_sampling_tpu_torch.structure import Structure, bulk
from surface_sampling_tpu_torch.structure.io import read_cif, write_cif
from surface_sampling_tpu_torch.structure.slabs import fcc100

REPO = Path(__file__).resolve().parent.parent
PD = str(REPO / "tests/data/pourbaix/pd_dict.json")
PBX = str(REPO / "tests/data/pourbaix/pbx_dict.json")
EAM_TOL, PAINN_TOL = 1e-4, 1e-3
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp: Path, name: str, settings: dict) -> Path:
    p = tmp / name
    p.write_text(json.dumps(settings))
    return p


def _variant(base: dict, tmp: Path, folder: str, **samp) -> dict:
    s = json.loads(json.dumps(base))
    s["sampling_settings"].update(samp)
    s["sampling_settings"]["run_folder"] = str(tmp / folder)
    return s


def _run(main, base, tmp, folder, slab, resume=None, flag="--slab", device=True, **samp):
    s = _variant(base, tmp, folder, **samp)
    sp = _write(tmp, f"s_{folder}_{s['sampling_settings']['total_sweeps']}.json", s)
    argv = ["--settings", str(sp), flag, str(slab)] + (CPU if device else [])
    if resume:
        argv += ["--resume", str(tmp / resume)]
    main(argv)
    with np.load(tmp / folder / "history.npz") as h:
        return {k: h[k] for k in h.files}


def _j_state_energies(run_j, site_states) -> np.ndarray:
    """JAX's surface energies (an ``MCMCRun``'s) of (..., S) site states,
    under one jit."""
    ss = np.asarray(site_states)
    flat = jnp.asarray(ss.reshape(-1, ss.shape[-1]), jnp.int32)
    e = jax.jit(jax.vmap(lambda s: run_j.state_energy_fn(s).surface_energy))(flat)
    return np.asarray(e).reshape(ss.shape[:-1])


# ----------------------------------------------------------------------
# Cu(100) EAM: the cu_setup shape
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cu(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cu")
    write_cif(tmp / "slab.cif", fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0))
    save_tables_npz(tmp / "Cu_u3.eam.npz", builtin_eam("Cu_u3"))
    base = {
        "system_settings": {"surface_name": "Cu_100_test", "planar_distance": 1.5,
                            "near_reduce": 0.01},
        "sampling_settings": {"total_sweeps": 3, "sweep_size": 2, "start_temp": 1.0,
                              "alpha": 0.99, "adsorbates": ["Cu"], "n_chains": 2,
                              "run_folder": str(tmp / "run")},
        "calc_settings": {"calc_name": "eam", "potential_file": str(tmp / "Cu_u3.eam.npz")},
    }
    return tmp, tmp / "slab.cif", base


@pytest.fixture(scope="module")
def cu_runs(cu):
    """One 8-sweep run of each package on the same settings (t_min floors
    the last sweeps), and JAX's assembled system."""
    tmp, slab, base = cu
    samp = dict(total_sweeps=8, t_min=0.95)
    s_j = _variant(base, tmp, "jax8", **samp)
    j_sample_surface(["--settings", str(_write(tmp, "s_jax8.json", s_j)), "--slab", str(slab)])
    hist = _run(sample_surface, base, tmp, "port8", slab, **samp)
    asys_j = jcommon.assemble_system(s_j, j_read_cif(slab))
    return tmp / "jax8", tmp / "port8", hist, asys_j


def test_assemble_system_matches_jax(cu, tmp_path):
    """The spec (sites, slots, vocabulary), the fast-path potential and the
    hooks of JAX's assemble_system, with and without the symmetry
    reduction of the sites; rigid SW on its occupancy-algebra path."""
    tmp, slab, base = cu
    for symm in (False, True):
        s = json.loads(json.dumps(base))
        s["system_settings"]["symm_reduce"] = symm
        got = common.assemble_system(common.load_settings(_write(tmp_path, "a.json", s)),
                                     read_cif(slab), device="cpu")
        want = jcommon.assemble_system(jcommon.load_settings(_write(tmp_path, "a.json", s)),
                                       j_read_cif(slab))
        np.testing.assert_array_equal(got.spec.site_coords, want.spec.site_coords)
        assert got.spec.n_slots == want.spec.n_slots and got.spec.n_codes == want.spec.n_codes
        assert got.potential.name == want.potential.name == "eam-rigid"
        assert got.run.d.device.type == "cpu"
    assert len(got.spec.site_coords) < len(common.assemble_system(
        base, read_cif(slab), device="cpu").spec.site_coords)
    # rigid Stillinger-Weber goes onto the occupancy-algebra path, as in JAX
    from surface_sampling_tpu_torch.structure.slabs import surface_from_bulk

    si, _ = surface_from_bulk(bulk("Si", "diamond", a=5.431), (1, 1, 1), size=(2, 2),
                              layers=2, vacuum=10.0)
    sw = {"system_settings": {"surface_name": "Si_sw", "planar_distance": 1.6},
          "sampling_settings": {"adsorbates": ["Si"]}, "calc_settings": {"calc_name": "sw"}}
    got = common.assemble_system(json.loads(json.dumps(sw)), si, device="cpu")
    assert got.potential.name == "sw-rigid" and got.spec.n_sites > 0
    s = json.loads(json.dumps(base))
    s["calc_settings"].update(relax_atoms=True)
    got = common.assemble_system(s, read_cif(slab), device="cpu")
    assert got.potential.name == "eam" and got.run.relax is not None
    assert set(vars(got.potential)["local_relax_args"]) == {
        "spec", "static_nbr", "hops", "relax", "surface_energy_fn", "descent"}


def test_schedule_stats_and_artifacts_match_jax(cu_runs):
    """The anneal schedule and stats.csv's temp column (t_min floor
    included) bitwise JAX's; the stats header, history keys and shapes,
    sampling_quality keys and the artifact set equal."""
    jdir, pdir, hist, _ = cu_runs
    assert (pdir / "anneal_schedule.csv").read_text() == (jdir / "anneal_schedule.csv").read_text()
    prow = list(csv.reader((pdir / "stats.csv").read_text().splitlines()))
    jrow = list(csv.reader((jdir / "stats.csv").read_text().splitlines()))
    assert prow[0] == jrow[0] == common.STATS_HEADER.split(",")
    assert [r[:2] for r in prow] == [r[:2] for r in jrow]
    assert len(prow) == 9 and prow[-1][1] == "0.950000"
    jh = np.load(jdir / "history.npz")
    assert set(hist) == set(jh.files)
    for k in jh.files:
        assert hist[k].shape == jh[k].shape, k
    np.testing.assert_array_equal(hist["temps"], jh["temps"])
    assert json.loads((pdir / "sampling_quality.json").read_text()).keys() == \
        json.loads((jdir / "sampling_quality.json").read_text()).keys()
    names = {p.name.split("_-")[0] for p in pdir.iterdir()}
    assert names == {p.name.split("_-")[0] for p in jdir.iterdir()}
    assert {"stats.csv", "summary_stats.png", "checkpoint.npz", "history.npz",
            "sampling_quality.json", "anneal_schedule.csv", "mc.log", "best_energy"} <= names


def test_history_energies_match_jax_state_energy(cu_runs):
    """Every energy of the port's history is JAX's state_energy_fn of the
    same site state (EAM: 1e-4 eV), and the best CIF is the best state."""
    _, pdir, hist, asys_j = cu_runs
    want = _j_state_energies(asys_j.run, hist["site_state"])
    np.testing.assert_allclose(hist["energy"], want, rtol=0, atol=EAM_TOL)
    best = list(pdir.glob("best_energy_*.cif"))
    assert len(best) == 1 and best[0].name == f"best_energy_{hist['energy'].min():.3f}.cif"


def test_even_prefill_states_bitwise():
    slab = fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0)
    from surface_sampling_tpu_torch.core.spec import make_spec
    from surface_sampling_tpu_torch.structure import find_adsorption_sites

    site_coords = find_adsorption_sites(slab, planar_distance=1.5, near_reduce=0.01)["all"]
    spec = make_spec(slab, site_coords, ["O", "OH"], potential_numbers=[29], cutoff=5.0)
    got = common.even_prefill_states(spec, num_ads_atoms=4, n_chains=16, seed=3)
    want = jcommon.even_prefill_states(spec, num_ads_atoms=4, n_chains=16, seed=3)
    np.testing.assert_array_equal(got, want)
    assert (np.sum(got > 0, axis=1) == 4).all() and len({tuple(r) for r in got}) > 1


MODES = {
    "plain": {},
    "chunked": dict(checkpoint_interval=2),
    "tempering": dict(tempering=True, n_chains=4, t_min=0.3, t_max=1.5, checkpoint_interval=2),
    "population_annealing": dict(population_annealing=True, n_chains=4,
                                 resample_threshold=1.0, checkpoint_interval=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_resume_bitwise(cu, mode):
    """A 2-sweep run resumed in place to 6 sweeps is bitwise the tail of
    an uninterrupted 6-sweep run (the checkpoint carries the generator);
    stats.csv holds rows 1..6; resuming a finished run is refused."""
    tmp, slab, base = cu
    kw = MODES[mode]
    full = _run(sample_surface, base, tmp, f"full_{mode}", slab, total_sweeps=6, **kw)
    part = _run(sample_surface, base, tmp, f"part_{mode}", slab, total_sweeps=2, **kw)
    res = _run(sample_surface, base, tmp, f"part_{mode}", slab, resume=f"part_{mode}",
               total_sweeps=6, **kw)
    sweep_axis = 0 if mode in ("tempering", "population_annealing") else 1
    np.testing.assert_array_equal(part["energy"], np.take(full["energy"], [0, 1], sweep_axis))
    for k in ("energy", "site_state"):
        np.testing.assert_array_equal(res[k], np.take(full[k], range(2, 6), sweep_axis))
    start = "start_round" if mode == "tempering" else "start_sweep"
    assert int(res[start]) == 2
    rows = (tmp / f"part_{mode}" / "stats.csv").read_text().strip().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [str(i) for i in range(1, 7)]
    _, idx, _, extra, _ = load_checkpoint(tmp / f"part_{mode}" / "checkpoint.npz", "cpu")
    assert idx == 6 and str(extra["mode"]) == ("plain" if mode == "chunked" else mode)
    with pytest.raises(ValueError, match="already completed"):
        _run(sample_surface, base, tmp, f"part_{mode}", slab, resume=f"part_{mode}",
             total_sweeps=6, **kw)


def test_error_in_chunk_propagates_and_resume_reproduces(cu, monkeypatch):
    """chunk_retries replays nothing: an error in a chunk propagates, and
    --resume from the last chunk's checkpoint reproduces the uninterrupted
    run bitwise."""
    tmp, slab, base = cu
    kw = dict(total_sweeps=6, checkpoint_interval=2, chunk_retries=2)
    full = _run(sample_surface, base, tmp, "err_full", slab, **kw)
    real = common.make_chain_run
    calls = {"n": 0}

    def failing(run_fn, **k):
        crun = real(run_fn, **k)

        def wrapped(states, temps, gen):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected device fault")
            return crun(states, temps, gen)

        return wrapped

    monkeypatch.setattr(common, "make_chain_run", failing)
    with pytest.raises(RuntimeError, match="injected"):
        _run(sample_surface, base, tmp, "err", slab, **kw)
    monkeypatch.setattr(common, "make_chain_run", real)
    assert calls["n"] == 2
    _, idx, _, _, _ = load_checkpoint(tmp / "err" / "checkpoint.npz", "cpu")
    assert idx == 2
    assert "no effect" in (tmp / "err" / "mc.log").read_text()
    res = _run(sample_surface, base, tmp, "err", slab, resume="err", **kw)
    for k in ("energy", "site_state"):
        np.testing.assert_array_equal(res[k], full[k][:, 2:])
    rows = (tmp / "err" / "stats.csv").read_text().strip().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == [str(i) for i in range(1, 7)]


def test_refusals(cu, cu_runs, tmp_path):
    """A JAX checkpoint, a mode mismatch, a chain-count mismatch, a
    schedule mismatch, a missing checkpoint, bad settings files and
    incompatible modes are refused with clear errors."""
    tmp, slab, base = cu
    jdir = cu_runs[0]
    with pytest.raises(ValueError, match="JAX"):
        _run(sample_surface, base, tmp_path, "r1", slab, resume=str(jdir), total_sweeps=9)
    _run(sample_surface, base, tmp_path, "plain", slab, total_sweeps=2)
    with pytest.raises(ValueError, match="not written by a tempering run"):
        _run(sample_surface, base, tmp_path, "plain", slab, resume="plain", total_sweeps=4,
             tempering=True)
    with pytest.raises(ValueError, match="not written by a population-annealing run"):
        _run(sample_surface, base, tmp_path, "plain", slab, resume="plain", total_sweeps=4,
             population_annealing=True)
    _run(sample_surface, base, tmp_path, "pt", slab, total_sweeps=2, tempering=True,
         n_chains=2)
    with pytest.raises(ValueError, match="plain one"):
        _run(sample_surface, base, tmp_path, "pt", slab, resume="pt", total_sweeps=4,
             n_chains=2)
    with pytest.raises(ValueError, match="chains"):
        _run(sample_surface, base, tmp_path, "plain", slab, resume="plain", total_sweeps=4,
             n_chains=4)
    with pytest.raises(ValueError, match="schedule mismatch"):
        _run(sample_surface, base, tmp_path, "plain", slab, resume="plain", total_sweeps=4,
             alpha=0.9)
    with pytest.raises(FileNotFoundError):
        _run(sample_surface, base, tmp_path, "plain", slab, resume="nope", total_sweeps=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _run(sample_surface, base, tmp_path, "x", slab, tempering=True,
             population_annealing=True)
    with pytest.raises(ValueError, match="mtm_trials"):
        _run(sample_surface, base, tmp_path, "x", slab, tempering=True, mtm_trials=3)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(SystemExit, match="not valid JSON"):
        sample_surface(["--settings", str(bad), "--slab", str(slab)] + CPU)
    bad.write_text("[1, 2]")
    with pytest.raises(SystemExit, match="JSON object"):
        sample_surface(["--settings", str(bad), "--slab", str(slab)] + CPU)


@pytest.mark.parametrize("driver", ["sample_surface", "sample_pourbaix", "sample_bulk",
                                    "predict"])
def test_drivers_default_to_the_card(cu, tmp_path, monkeypatch, driver):
    """Without --device every driver runs on the card, and raises without
    one (nothing falls back to the CPU)."""
    tmp, slab, base = cu
    sp = _write(tmp_path, "s.json", _variant(base, tmp_path, "card"))
    argv = {"sample_surface": (sample_surface, ["--slab", str(slab)]),
            "sample_pourbaix": (sample_pourbaix, ["--slab", str(slab)]),
            "sample_bulk": (sample_bulk, ["--bulk", str(slab)]),
            "predict": (predict, ["--structures", str(slab), "--out",
                                  str(tmp_path / "p.npz")])}[driver]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if driver == "sample_pourbaix":
        s = json.loads(sp.read_text())
        s["calc_settings"].update(phase_diagram=PD, pourbaix_diagram=PBX,
                                  elements=["Sr", "Ir", "O"])
        sp.write_text(json.dumps(s))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        argv[0](["--settings", str(sp)] + argv[1])


def test_canonical_distance_decay_and_save_structures(cu):
    """A canonical run with distance-decay weights (prefill bounded and
    force-filled) exports one chain-0 frame a sweep through the native
    writer; a semigrand run's per-sweep best frames go frame by frame;
    both read back with their sweep count."""
    tmp, slab, base = cu
    _run(sample_surface, base, tmp, "sv_can", slab, canonical=True, num_ads_atoms=3,
         require_distance_decay=True, distance_decay_factor=0.8, prep_max_steps=100,
         prep_force_fill=True, save_structures="chain0")
    lines = (tmp / "sv_can" / "traj_chain0.xyz").read_text().splitlines()
    n0 = int(lines[0])
    assert sum(1 for ln in lines if ln.strip().isdigit() and int(ln) == n0) == 3
    hist = np.load(tmp / "sv_can" / "history.npz")
    assert ((hist["site_state"] > 0).sum(axis=-1) == 3).all()
    _run(sample_surface, base, tmp, "sv_best", slab, save_structures="best")
    traj = (tmp / "sv_best" / "traj_best.xyz").read_text().splitlines()
    i = frames = 0
    while i < len(traj):
        n = int(traj[i])
        assert "Lattice=" in traj[i + 1]
        i += 2 + n
        frames += 1
    assert frames == 3


def test_sample_bulk_matches_jax_energies(tmp_path):
    """Bulk-defect sampling: every lattice site prefilled and exchangeable;
    the history's energies are JAX's on the same states (exact EAM)."""
    from surface_sampling_tpu.core import MCMCRun as JMCMCRun
    from surface_sampling_tpu.core.spec import make_spec_sampling_surface_atoms as j_surf_spec

    write_cif(tmp_path / "bulk.cif", bulk("Cu", "fcc", 3.6147))
    save_tables_npz(tmp_path / "Cu_u3.eam.npz", builtin_eam("Cu_u3"))
    base = {"system_settings": {"cutoff": 4.95},
            "sampling_settings": {"total_sweeps": 2, "sweep_size": 2, "start_temp": 0.5,
                                  "adsorbates": ["Cu"], "n_chains": 2},
            "calc_settings": {"calc_name": "eam", "potential_file": str(tmp_path /
                                                                        "Cu_u3.eam.npz"),
                              "fast": False}}
    hist = _run(sample_bulk, base, tmp_path, "bulk", tmp_path / "bulk.cif", flag="--bulk")
    assert (tmp_path / "bulk" / "stats.csv").exists() and hist["energy"].shape == (2, 2)
    st = j_read_cif(tmp_path / "bulk.cif")
    pot, numbers, _ = jcommon.build_potential(base["calc_settings"], {})
    spec, _ = j_surf_spec(st, np.ones(len(st), bool), ["Cu"], potential_numbers=numbers,
                          cutoff=4.95, surface_name="Cu_bulk")
    run = JMCMCRun(spec, pot)
    want = _j_state_energies(run, hist["site_state"])
    np.testing.assert_allclose(hist["energy"], want, rtol=0, atol=EAM_TOL)


def test_sample_pourbaix_matches_jax(tmp_path):
    """The Pourbaix driver with surface-atom sampling on a toy SrIrO slab
    (Lennard-Jones backbone): its Pourbaix atoms file is JAX's, the run
    starts from the prefilled surface atoms, and every energy of its
    history is JAX's Pourbaix energy of the same state (1e-4 eV)."""
    from surface_sampling_tpu.core import MCMCRun as JMCMCRun
    from surface_sampling_tpu.core.spec import make_spec_sampling_surface_atoms as j_surf_spec
    from surface_sampling_tpu.pourbaix import generate_pourbaix_atoms as j_gen
    from surface_sampling_tpu.pourbaix import make_pourbaix_surface_energy as j_pbx_energy
    from surface_sampling_tpu.pourbaix import save_pourbaix_atoms as j_save
    from surface_sampling_tpu.structure import find_adsorption_sites as j_find_sites

    slab = Structure.from_symbols(
        ["Ir", "Ir", "Sr", "Sr", "O", "O"],
        [[0, 0, 5], [2, 0, 5], [0, 2, 5], [2, 2, 5], [0, 0, 6.6], [2, 2, 6.6]],
        np.diag([4.0, 4.0, 20.0]))
    write_cif(tmp_path / "slab.cif", slab)
    calc = {"calc_name": "lj", "epsilon": 0.3, "sigma": 1.8, "cutoff": 4.0,
            "phase_diagram": PD, "pourbaix_diagram": PBX, "phi": 0.5, "pH": 7.0,
            "elements": ["Sr", "Ir", "O"], "adsorbate_corrections": {"OH": 0.23}}
    base = {"system_settings": {"surface_name": "SrIrO_satoms", "planar_distance": 1.5,
                                "cutoff": 4.0, "surface_atom_tol": 1.0},
            "sampling_settings": {"total_sweeps": 3, "sweep_size": 3, "start_temp": 1.0,
                                  "perform_annealing": False, "adsorbates": ["O", "HO"],
                                  "n_chains": 2, "sample_surface_atoms": True},
            "calc_settings": calc}
    hist = _run(sample_pourbaix, base, tmp_path, "pbx", tmp_path / "slab.cif")
    assert np.isfinite(hist["energy"]).all() and hist["n_ads"].shape == (2, 3)
    assert len((tmp_path / "pbx" / "stats.csv").read_text().strip().splitlines()) == 4
    atoms = j_gen(PD, PBX, 0.5, 7.0, ["Sr", "Ir", "O"])
    j_save(tmp_path / "j_atoms.json", atoms)
    assert (tmp_path / "pbx" / "pourbaix_atoms.json").read_text() == \
        (tmp_path / "j_atoms.json").read_text()

    jslab = j_read_cif(tmp_path / "slab.cif")
    pot, numbers, _ = jcommon.build_potential(dict(calc), {})
    sites = j_find_sites(jslab, planar_distance=1.5, near_reduce=0.01,
                         no_obtuse_hollow=True)["all"]
    z = jslab.positions[:, 2]
    spec, ss0 = j_surf_spec(jslab, (z.max() - z) < 1.0, ["O", "HO"], potential_numbers=numbers,
                            cutoff=4.0, extra_site_coords=sites, surface_name="SrIrO_satoms")
    se = j_pbx_energy(spec, atoms, phi=0.5, pH=7.0, temp=0.0257,
                      adsorbate_corrections={"OH": 0.23})
    run = JMCMCRun(spec, pot, surface_energy_fn=se)
    want = _j_state_energies(run, hist["site_state"])
    np.testing.assert_allclose(hist["energy"], want, rtol=0, atol=EAM_TOL)
    assert int((np.asarray(ss0) > 0).sum()) == 2


def test_predict_matches_jax(cu, tmp_path):
    """predict on perturbed Cu slabs with EAM: energies, forces, n_atoms
    and the label metrics are JAX's (1e-4)."""
    tmp, slab, base = cu
    st = read_cif(slab)
    rng = np.random.default_rng(0)
    files, records = [], []
    for i in range(3):
        s2 = st.copy()
        s2.positions = s2.positions + rng.normal(0, 0.02, s2.positions.shape)
        write_cif(tmp_path / f"s{i}.cif", s2)
        files.append(str(tmp_path / f"s{i}.cif"))
        records.append({"numbers": s2.numbers.tolist(), "positions": s2.positions.tolist(),
                        "cell": np.asarray(s2.cell).tolist(), "energy": -20.0 - i})
    (tmp_path / "labels.json").write_text(json.dumps(records))
    sp = _write(tmp_path, "s.json", base)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    predict(["--structures", *files, "--settings", str(sp), "--out", str(tmp_path / "p/x.npz"),
             "--labels", str(tmp_path / "labels.json")] + CPU)
    j_predict(["--structures", *files, "--settings", str(sp), "--out",
               str(tmp_path / "j/x.npz"), "--labels", str(tmp_path / "labels.json")])
    got, want = np.load(tmp_path / "p/x.npz"), np.load(tmp_path / "j/x.npz")
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    gm = json.loads((tmp_path / "p/metrics.json").read_text())
    jm = json.loads((tmp_path / "j/metrics.json").read_text())
    assert gm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(gm[k], jm[k], rtol=0, atol=1e-4)


# ----------------------------------------------------------------------
# A tiny banded PaiNN: the delta, local-relax and frozen-far-field branches
# ----------------------------------------------------------------------
TINY = PaiNNConfig(feat_dim=16, n_rbf=6, cutoff=4.0, n_layers=2, readout_hidden=8,
                   max_neighbors=10, excl_vol=True, sigma=1.2, power=8.0)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The Ti strip of tests/test_cli.py (bands at a 4 A cutoff) and a
    one-model and a two-model tiny PaiNN saved in the JAX package's npz
    scheme; the settings ask JAX for its f32 routing."""
    tmp = tmp_path_factory.mktemp("tiny")
    rng = np.random.default_rng(5)
    xs = np.arange(21) * 2.0 + 0.3
    pos = np.stack([xs, np.full(21, 2.0), np.full(21, 5.0)], axis=1)
    pos[:, 1] += rng.uniform(-0.3, 0.3, 21)
    write_cif(tmp / "slab.cif", Structure.from_symbols(["Ti"] * 21, pos,
                                                       np.diag([42.0, 4.2, 16.0])))
    gen = torch.Generator().manual_seed(0)
    save_painn_npz(tmp / "toy_painn.npz", init_painn(gen, TINY), TINY)
    ens = init_ensemble(gen, TINY, 2)
    for m in range(2):
        save_painn_npz(tmp / f"toy_{m}.npz", ens, TINY, member=m)
    base = {
        "system_settings": {"surface_name": "toy_inc", "planar_distance": 1.9, "cutoff": 4.0},
        "sampling_settings": {"total_sweeps": 4, "sweep_size": 3, "start_temp": 1.0,
                              "alpha": 0.99, "adsorbates": ["O", "Sr"], "n_chains": 2,
                              "incremental": True},
        "calc_settings": {"calc_name": "nff", "model_paths": [str(tmp / "toy_painn.npz")],
                          "elements": ["Ti", "O", "Sr"], "model_units": "kcal/mol",
                          "pallas_routing": "f32"},
    }
    return tmp, tmp / "slab.cif", base


def _fresh_energies(asys, site_states) -> np.ndarray:
    e = asys.run.state_energy_fn(torch.as_tensor(np.asarray(site_states), dtype=torch.int64))
    return e.surface_energy.numpy()


def test_incremental_matches_jax_and_resumes_bitwise(tiny):
    """incremental=true drives the delta engine: the assembly carries its
    hook and the band; every history energy is JAX's state_energy_fn of
    the state (1e-3 eV, f32 path); the checkpoint's energies equal a fresh
    full evaluation; 2 sweeps resumed to 4 are bitwise the chunked run."""
    tmp, slab, base = tiny
    kw = dict(checkpoint_interval=2)
    full = _run(sample_surface, base, tmp, "inc_full", slab, **kw)
    assert full["energy"].shape == (2, 4) and np.isfinite(full["energy"]).all()
    asys = common.assemble_system(json.loads(json.dumps(base)), read_cif(slab), device="cpu")
    assert "inc_args" in vars(asys.potential)
    assert vars(asys.potential)["inc_args"]["band"] is not None
    asys_j = jcommon.assemble_system(json.loads(json.dumps(base)), j_read_cif(slab))
    np.testing.assert_array_equal(asys.spec.site_coords, asys_j.spec.site_coords)
    np.testing.assert_allclose(full["energy"], _j_state_energies(asys_j.run, full["site_state"]),
                               rtol=0, atol=PAINN_TOL)
    states, idx, _, _, _ = load_checkpoint(tmp / "inc_full" / "checkpoint.npz", "cpu")
    assert idx == 4
    np.testing.assert_allclose(states.energy.numpy(), _fresh_energies(asys, states.site_state),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(full["energy"][:, -1], states.energy.numpy())
    part = _run(sample_surface, base, tmp, "inc_part", slab, total_sweeps=2, **kw)
    np.testing.assert_array_equal(part["energy"], full["energy"][:, :2])
    res = _run(sample_surface, base, tmp, "inc_part", slab, resume="inc_part", **kw)
    for k in ("energy", "site_state"):
        np.testing.assert_array_equal(res[k], full[k][:, 2:])


def test_incremental_guards_and_tempering(tiny):
    """incremental=true refuses PA, MTM, other criteria and a potential
    without the hook (fast path off); with tempering it resumes bitwise and
    its replicas' checkpointed energies equal a fresh evaluation."""
    tmp, slab, base = tiny
    with pytest.raises(ValueError, match="population_annealing"):
        _run(sample_surface, base, tmp, "g_pa", slab, population_annealing=True)
    with pytest.raises(ValueError, match="mtm_trials"):
        _run(sample_surface, base, tmp, "g_mtm", slab, mtm_trials=4)
    with pytest.raises(ValueError, match="metropolis"):
        _run(sample_surface, base, tmp, "g_crit", slab, criterion="distance",
             filter_distance=1.0)
    nofast = json.loads(json.dumps(base))
    nofast["calc_settings"]["fast"] = False
    with pytest.raises(ValueError, match="inc_args"):
        _run(sample_surface, nofast, tmp, "g_nofast", slab)
    with pytest.raises(ValueError, match="inc_args"):
        _run(sample_surface, nofast, tmp, "g_tnofast", slab, tempering=True, n_chains=4)
    kw = dict(tempering=True, n_chains=4, t_min=0.3, t_max=1.5, checkpoint_interval=2)
    full = _run(sample_surface, base, tmp, "it_full", slab, **kw)
    assert full["energy"].shape == (4, 4) and full["swap_rate"].shape == (4,)
    asys = common.assemble_system(json.loads(json.dumps(base)), read_cif(slab), device="cpu")
    states, idx, _, _, _ = load_checkpoint(tmp / "it_full" / "checkpoint.npz", "cpu")
    assert idx == 4
    np.testing.assert_allclose(states.energy.numpy(), _fresh_energies(asys, states.site_state),
                               rtol=0, atol=1e-4)
    _run(sample_surface, base, tmp, "it_part", slab, total_sweeps=2, **kw)
    res = _run(sample_surface, base, tmp, "it_part", slab, resume="it_part", **kw)
    assert int(res["start_round"]) == 2
    for k in ("energy", "swap_rate", "site_state"):
        np.testing.assert_array_equal(res[k], full[k][2:])


def _relaxed_energies(asys, states) -> np.ndarray:
    """The potential's surface energies of the carried relaxed geometry."""
    from surface_sampling_tpu_torch.core.state import (
        element_counts,
        realize_alive,
        realize_type_idx,
    )

    d, ss = asys.run.d, states.site_state
    e = asys.potential.energy(states.relaxed_positions, realize_type_idx(d, ss),
                              realize_alive(d, ss), d.shifts)
    return asys.run.surface_energy_fn(e, element_counts(d, ss)).detach().numpy() \
        if asys.run.surface_energy_fn is not None else e.detach().numpy()


def test_local_relax_engine_resumes_bitwise(cu):
    """incremental=true with relax_atoms runs the warm-started ball-local
    engine (Cu EAM): the checkpointed energies are the potential's at the
    carried relaxed geometry, and a chunked run resumes bitwise."""
    tmp, slab, base0 = cu
    base = json.loads(json.dumps(base0))
    base["calc_settings"].update(relax_atoms=True, relax_steps=4, fmax=0.05,
                                 relax_ball_hops=1)
    kw = dict(total_sweeps=4, checkpoint_interval=2, incremental=True)
    full = _run(sample_surface, base, tmp, "lr_full", slab, **kw)
    assert full["energy"].shape == (2, 4) and np.isfinite(full["energy"]).all()
    asys = common.assemble_system(json.loads(json.dumps(base)), read_cif(slab), device="cpu")
    states, idx, _, _, _ = load_checkpoint(tmp / "lr_full" / "checkpoint.npz", "cpu")
    assert idx == 4
    np.testing.assert_allclose(states.energy.numpy(), _relaxed_energies(asys, states),
                               rtol=1e-5, atol=1e-4)
    part = _run(sample_surface, base, tmp, "lr_part", slab, **dict(kw, total_sweeps=2))
    np.testing.assert_array_equal(part["energy"], full["energy"][:, :2])
    res = _run(sample_surface, base, tmp, "lr_part", slab, resume="lr_part", **kw)
    for k in ("energy", "site_state"):
        np.testing.assert_array_equal(res[k], full[k][:, 2:])
    with pytest.raises(ValueError, match="mtm_trials"):
        _run(sample_surface, base, tmp, "lr_mtm", slab, **dict(kw, mtm_trials=4))
    ff = json.loads(json.dumps(base))
    ff["calc_settings"]["relax_descent"] = "frozen_far_field"
    with pytest.raises(ValueError, match="ff_pack"):
        _run(sample_surface, ff, tmp, "lr_ff", slab, **kw)


def test_ff_engine_resumes_bitwise(tiny):
    """relax_descent='frozen_far_field' runs the FF ball engine on the tiny
    PaiNN: acceptance energies are full-cell energies of the carried
    geometry, a chunked run resumes bitwise, and tempering is refused."""
    tmp, slab, base0 = tiny
    base = json.loads(json.dumps(base0))
    base["calc_settings"].update(relax_atoms=True, relax_steps=3, fmax=0.05,
                                 relax_ball_hops=1, relax_descent="frozen_far_field")
    kw = dict(total_sweeps=4, checkpoint_interval=2, sweep_size=2)
    full = _run(sample_surface, base, tmp, "ff_full", slab, **kw)
    assert full["energy"].shape == (2, 4) and np.isfinite(full["energy"]).all()
    asys = common.assemble_system(json.loads(json.dumps(base)), read_cif(slab), device="cpu")
    assert vars(asys.potential)["local_relax_args"]["descent"] == "frozen_far_field"
    states, idx, _, _, _ = load_checkpoint(tmp / "ff_full" / "checkpoint.npz", "cpu")
    assert idx == 4
    np.testing.assert_allclose(states.energy.numpy(), _relaxed_energies(asys, states),
                               rtol=1e-5, atol=1e-4)
    _run(sample_surface, base, tmp, "ff_part", slab, **dict(kw, total_sweeps=2))
    res = _run(sample_surface, base, tmp, "ff_part", slab, resume="ff_part", **kw)
    for k in ("energy", "site_state"):
        np.testing.assert_array_equal(res[k], full[k][:, 2:])
    with pytest.raises(ValueError, match="tempering"):
        _run(sample_surface, base, tmp, "ff_temp", slab, **dict(kw, tempering=True))


def test_predict_ensemble_matches_jax(tiny, tmp_path):
    """predict with a two-model PaiNN ensemble: energies, forces, the
    member spread and the pooled embeddings equal JAX's potential on the
    same structure, jitted (1e-4; edges by image search)."""
    from surface_sampling_tpu.ops.neighbors import pair_shifts_for as j_pair_shifts

    tmp, slab, _ = tiny
    calc = {"calc_name": "nff", "elements": ["Ti", "O", "Sr"],
            "model_paths": [str(tmp / "toy_0.npz"), str(tmp / "toy_1.npz")]}
    sp = _write(tmp_path, "s.json", {"calc_settings": calc})
    predict(["--structures", str(slab), "--settings", str(sp), "--out", str(tmp_path / "x.npz"),
             "--embeddings"] + CPU)
    got = np.load(tmp_path / "x.npz")
    assert set(got.files) == {"energies", "energy_std", "forces", "n_atoms", "embeddings"}

    pot, _, cutoff = jcommon.build_potential(dict(calc), {})
    st = j_read_cif(slab)
    args = (jnp.asarray(st.positions, jnp.float32), jnp.zeros(len(st), jnp.int32),
            jnp.ones(len(st), bool),
            jnp.asarray(j_pair_shifts(st.cell, st.scaled_positions, cutoff), jnp.float32))
    e, f = jax.jit(pot.energy_and_forces)(*args)
    out = jax.jit(pot.__dict__["outputs"])(*args)
    assert float(got["energy_std"][0]) > 0
    np.testing.assert_allclose(got["energies"], [float(e)], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["forces"][0], np.asarray(f), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["energy_std"], [float(out["energy_std"])], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["embeddings"][0], np.asarray(out["embedding"]).mean(axis=0),
                               rtol=0, atol=1e-4)
    assert int(got["n_atoms"][0]) == len(st)
