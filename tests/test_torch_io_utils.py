"""The port's host layers against the JAX package on the CPU: sampling
statistics, the workflow helpers of ``utils/`` (misc, logging, run folders,
figures, timing), ``io/checkpoint.py``, the native runtime and the site
symmetry reduction of ``structure/sites.py``, plus the distance-decay and
Boltzmann-weight analogs of ``tests/test_weighted_proposals.py``.

Tolerances: statistics and the distance-decay weights within 1e-12 on
seeded numpy inputs (the same float64 numpy / scipy code); host objects
(structures read back, neighbour lists, symmetry operations, site
representatives) equal; written files equal byte for byte; the empirical
draw ratio of the Boltzmann-weighted proposal within JAX's own bound.
"""

import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.analysis import statistics as jstats
from surface_sampling_tpu.io import save_checkpoint as j_save_checkpoint
from surface_sampling_tpu.parallel import chain_states as j_chain_states
from surface_sampling_tpu.runtime import native as jnative
from surface_sampling_tpu.core.spec import make_spec as j_make_spec
from surface_sampling_tpu.core.state import device_spec as j_device_spec
from surface_sampling_tpu.structure import Structure as JStructure
from surface_sampling_tpu.structure import sites as jsites
from surface_sampling_tpu.utils import misc as jmisc
from surface_sampling_tpu_torch.analysis import statistics as tstats
from surface_sampling_tpu_torch.core.engine import MCMCRun, make_generator
from surface_sampling_tpu_torch.core.energy import StateEnergy
from surface_sampling_tpu_torch.core.events import canonical_draws, make_canonical_step
from surface_sampling_tpu_torch.core.spec import make_spec
from surface_sampling_tpu_torch.core.state import initial_state, realize_positions
from surface_sampling_tpu_torch.io import load_checkpoint, save_checkpoint
from surface_sampling_tpu_torch.potentials.base import Potential
from surface_sampling_tpu_torch.potentials.pair import make_lennard_jones
from surface_sampling_tpu_torch.runtime import native
from surface_sampling_tpu_torch.structure import Structure, find_adsorption_sites, sites
from surface_sampling_tpu_torch.structure import io as tio
from surface_sampling_tpu_torch.structure.slabs import bulk, fcc100
from surface_sampling_tpu_torch.systems import SYSTEMS_DATA
from surface_sampling_tpu_torch.utils import SilenceLogger, misc, plot, setup_folders, setup_logger
from surface_sampling_tpu_torch.utils.tracing import PhaseTimer

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _jst(st: Structure) -> JStructure:
    return JStructure(st.numbers.copy(), st.positions.copy(), st.cell.copy())


def _same(a, b) -> None:
    np.testing.assert_array_equal(np.asarray(a.numbers), np.asarray(b.numbers))
    np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
    np.testing.assert_array_equal(np.asarray(a.cell), np.asarray(b.cell))


def _srtio3() -> Structure:
    d = np.load(SYSTEMS_DATA / "SrTiO3_001_2x2.npz")
    return Structure(d["numbers"], d["positions"], d["cell"])


# ----------------------------------------------------------------------
# analysis/statistics.py
# ----------------------------------------------------------------------
def _series():
    rng = np.random.default_rng(7)
    x = np.zeros(400)
    for i in range(1, 400):                       # AR(1): tau_int ~ 19
        x[i] = 0.9 * x[i - 1] + rng.standard_normal()
    return x, rng.standard_normal((6, 50)), rng.standard_normal(300) + 0.2


@pytest.mark.parametrize("name", ["distribution_summary", "compare_distributions",
                                  "autocorrelation", "integrated_autocorrelation_time",
                                  "effective_sample_size", "pooled_chain_energies"])
def test_statistics_match_jax(name):
    x, rec, y = _series()
    args = {"distribution_summary": (rec,), "compare_distributions": (x, y),
            "autocorrelation": (x,), "integrated_autocorrelation_time": (x,),
            "effective_sample_size": (x,), "pooled_chain_energies": (rec,)}[name]
    got, want = getattr(tstats, name)(*args), getattr(jstats, name)(*args)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # a frozen chain: the ACF estimator's degenerate case
    if name == "integrated_autocorrelation_time":
        assert tstats.integrated_autocorrelation_time(np.ones(20)) == \
            jstats.integrated_autocorrelation_time(np.ones(20)) == 1.0


# ----------------------------------------------------------------------
# utils/misc.py
# ----------------------------------------------------------------------
def test_distance_weight_matrix_matches_jax():
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, 8, (17, 3))
    for tau in (0.5, 1.0, 2.3):
        np.testing.assert_allclose(misc.compute_distance_weight_matrix(coords, tau),
                                   jmisc.compute_distance_weight_matrix(coords, tau),
                                   rtol=1e-12, atol=1e-12)


def test_misc_helpers_match_jax():
    slab = fcc100("Cu", size=(2, 2, 3), a=3.6147, vacuum=10.0)
    st = Structure.from_symbols(["O", "O", "Cu", "O"],
                                [[0, 0, 10], [1.2, 0, 10], [3, 3, 9], [6, 6, 10]],
                                np.diag([8.0, 8.0, 20.0]))
    for ads, cut in ((("O",), 1.5), (("O",), 1.0), (("Cu",), 1.5)):
        assert misc.filter_distances(st, ads, cut) == jmisc.filter_distances(_jst(st), ads, cut)
    for lattice in (True, False):
        got = misc.randomize_structure(slab, 0.1, lattice, rng=np.random.default_rng(5))
        want = jmisc.randomize_structure(_jst(slab), 0.1, lattice, rng=np.random.default_rng(5))
        _same(got, want)
    z = slab.positions[:, 2]
    for a, b in zip(misc.group_layers_with_indices(z), jmisc.group_layers_with_indices(z)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    for cut in (None, 1, 2):
        got = misc.preprocess_traj([slab, slab.translated([0, 0, 0.5])], z_cutoff=cut)
        want = jmisc.preprocess_traj([_jst(slab), _jst(slab.translated([0, 0, 0.5]))],
                                     z_cutoff=cut)
        for g, w in zip(got, want):
            _same(g, w)
    with pytest.raises(ValueError, match="z_cutoff"):
        misc.preprocess_traj([slab], z_cutoff=3)


def test_load_structures_any_matches_jax(tmp_path):
    a, b = fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0), bulk("Au", "fcc", 4.08)
    tio.write_cif(tmp_path / "a.cif", a)
    tio.write_xyz(tmp_path / "b.xyz", b)
    tio.save_structures_npz(tmp_path / "c.npz", [a, a.translated([0.0, 0.0, 0.7])])
    (tmp_path / "list.txt").write_text(f"{tmp_path / 'a.cif'}\n\n{tmp_path / 'c.npz'}\n")
    for name in ("a.cif", "b.xyz", "c.npz", "list.txt"):
        got, want = misc.load_structures_any(tmp_path / name), \
            jmisc.load_structures_any(tmp_path / name)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same(g, w)
    with pytest.raises(ValueError, match="unsupported"):
        misc.load_structures_any(tmp_path / "x.pdb")


# ----------------------------------------------------------------------
# utils: logging, folders, timing, figures
# ----------------------------------------------------------------------
def test_logger_folders_and_timing(tmp_path):
    log = setup_logger("t_port", tmp_path / "mc.log")
    log.info("hello")
    with SilenceLogger():
        log.info("muted")
    log = setup_logger("t_port", tmp_path / "mc.log")   # handlers replaced, not doubled
    log.info("again")
    text = (tmp_path / "mc.log").read_text()
    assert "hello" in text and "again" in text and "muted" not in text
    assert text.count("again") == 1
    assert logging.getLogger("t_port").handlers.__len__() == 2

    p = setup_folders("CuTest", canonical=True, total_sweeps=5, base_dir=tmp_path, tag="x")
    assert p.is_dir() and p.parent.name == "CuTest"
    assert p.name.endswith("_sweeps_5_start_temp_1.0_alpha_1.0_tag_x_canonical")
    assert setup_folders("CuTest", base_dir=tmp_path).name.endswith("_semigrand")

    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            pass
    with timer.phase("b"):
        pass
    assert list(timer.as_dict()) == ["a", "b"] and timer.counts == {"a": 2, "b": 1}
    assert timer.report().startswith("total ") and "a: " in timer.report()


def test_figures_and_their_absence(tmp_path):
    """Every figure of utils/plot.py is written where matplotlib is
    installed; the module imports without it and says so."""
    rng = np.random.default_rng(0)
    st = fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0)
    from scipy.cluster.hierarchy import linkage

    pts = rng.standard_normal((12, 2))
    calls = {
        "summary_stats.png": lambda: plot.plot_summary_stats(np.arange(5.), np.ones(5),
                                                             np.ones(5), 5, tmp_path),
        "energy_analysis.png": lambda: plot.plot_energy_analysis(np.arange(9.), None, tmp_path),
        "anneal_schedule.png": lambda: plot.plot_anneal_schedule(np.ones(4), tmp_path),
        "atom_type_histograms.png": lambda: plot.plot_atom_type_histograms(
            {"O": [1, 2, 2], "H": [0, 1]}, tmp_path),
        "clustering_results.png": lambda: plot.plot_clustering_results(
            pts, 3, np.arange(12) % 3, selected=[0, 1], save_folder=tmp_path),
        "p_dendrogram.png": lambda: plot.plot_dendrogram(linkage(pts, "ward"), tmp_path, "p_"),
        "distance_weight_matrix.png": lambda: plot.plot_distance_weight_matrix(
            np.eye(4), tmp_path),
        "decay_curve.png": lambda: plot.plot_decay_curve(np.arange(4.), np.ones(4), tmp_path),
        "specific_weights_iter_0003.png": lambda: plot.plot_specific_weights(
            pts, np.ones(12), 2, tmp_path, run_iter=3),
        "surfaces.png": lambda: plot.plot_surfaces([st, st, st], tmp_path),
    }
    assert plot.have_matplotlib()
    for name, call in calls.items():
        call()
        assert (tmp_path / name).exists(), name
    # without matplotlib a figure function logs the figure it skips and
    # returns None, writing nothing
    (tmp_path / "none").mkdir()
    code = ("import logging, sys; sys.modules['matplotlib'] = None\n"
            "logging.basicConfig(level=logging.INFO)\n"
            "from surface_sampling_tpu_torch.utils import plot\n"
            "print(plot.have_matplotlib(), "
            f"plot.plot_summary_stats([1.0], [0.5], [2], 1, {str(tmp_path / 'none')!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False None", out.stderr
    assert "plot_summary_stats not drawn" in out.stderr
    assert not list((tmp_path / "none").iterdir())


# ----------------------------------------------------------------------
# io/checkpoint.py
# ----------------------------------------------------------------------
def _cu_state():
    st = fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0)
    site_coords = find_adsorption_sites(st, planar_distance=1.5)["all"]
    spec = make_spec(st, site_coords, ["Cu"], potential_numbers=[29], cutoff=5.0)
    run = MCMCRun(spec, make_lennard_jones(0.1, 2.3, 5.0), device="cpu")
    rng = np.random.default_rng(2)
    jspec = j_make_spec(_jst(st), site_coords, ["Cu"], potential_numbers=[29], cutoff=5.0)
    return jspec, run.init_state(rng.integers(0, 2, (3, spec.n_sites)))


def test_checkpoint_keys_roundtrip_and_refusals(tmp_path, monkeypatch):
    """The JAX package's keys with ``key`` replaced by the generator's state
    and device type; a round trip restores the states and continues the
    generator's stream bitwise; a JAX checkpoint and one of another device
    type are refused, and without ``device`` the checkpoint loads onto the
    card, raising where there is none."""
    jspec, state = _cu_state()
    gen = make_generator(11, CPU)
    torch.rand(7, generator=gen)
    temps = np.geomspace(1.0, 0.1, 9)
    save_checkpoint(tmp_path / "p.npz", state, 4, temps, gen, extra={"mode": "plain", "x": 3})
    after = torch.rand(5, generator=gen)

    jstate = j_chain_states(j_device_spec(jspec), jax.random.PRNGKey(0), 3)
    j_save_checkpoint(tmp_path / "j.npz", jstate, 4, temps)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert set(p.files) == (set(j.files) - {"key"}) | {
            "generator_state", "generator_device", "extra_mode", "extra_x"}
        assert p["generator_state"].dtype == np.uint8
        assert str(p["generator_device"]) == "cpu"

    st2, idx, t2, extra, gen2 = load_checkpoint(tmp_path / "p.npz", "cpu")
    assert idx == 4 and str(extra["mode"]) == "plain" and int(extra["x"]) == 3
    np.testing.assert_array_equal(t2, temps)
    for a, b in zip(st2, state):
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(5, generator=gen2), after)

    with pytest.raises(ValueError, match="JAX"):
        load_checkpoint(tmp_path / "j.npz", "cpu")
    with np.load(tmp_path / "p.npz") as p:
        fake = {k: p[k] for k in p.files}
    fake["generator_device"] = np.asarray("cuda")
    np.savez(tmp_path / "card.npz", **fake)
    with pytest.raises(ValueError, match="--device cuda"):
        load_checkpoint(tmp_path / "card.npz", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(tmp_path / "card.npz")
    assert not list(tmp_path.glob("*.partial.npz"))


# ----------------------------------------------------------------------
# runtime/native.py
# ----------------------------------------------------------------------
def test_native_builds_into_build_dir_and_matches_jax(tmp_path):
    lib = native.load_library()
    assert lib is not None, "g++ expected in this environment"
    path = native.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "surface_sampling_tpu_torch"
    assert not list((REPO / "surface_sampling_tpu_torch" / "runtime").rglob("*.so"))

    a = 3.6147
    st = bulk("Cu", "fcc", a).repeat((3, 3, 3))
    for cutoff, cap in ((a * 0.8, 32), (3.7, 4)):
        got = native.cell_list_neighbors(st.positions, st.cell, cutoff, cap)
        want = jnative.cell_list_neighbors(st.positions, st.cell, cutoff, cap)
        ref = native.cell_list_neighbors_numpy(st.positions, st.cell, cutoff, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[3] == ref[3] and np.array_equal(got[2], ref[2])
    assert got[3] > 4 and np.all(got[2] <= 4)

    au = bulk("Au", "fcc", 4.08).repeat((2, 2, 2))
    sel = np.random.default_rng(0).choice(len(au), 10, replace=False)
    fast = native.min_selected_distance(au.positions, au.cell, sel)
    assert fast == jnative.min_selected_distance(au.positions, au.cell, sel)
    assert np.isclose(fast, native.min_selected_distance_numpy(au.positions, au.cell,
                                                               sel), atol=1e-10)


def test_write_xyz_frames_bytes(tmp_path):
    """The native writer, the Python writer and the JAX package's write the
    same bytes, and the port's reader reads each frame back."""
    st = fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0)
    numbers = st.numbers.copy()
    numbers[:2] = [8, 1]
    frames = np.stack([st.positions, st.positions + 0.1234567891, st.positions - 2.5])
    native.write_xyz_frames(tmp_path / "n.xyz", numbers, frames, st.cell)
    native.write_xyz_frames_python(tmp_path / "p.xyz", numbers, frames, st.cell)
    jnative.write_xyz_frames(tmp_path / "j.xyz", numbers, frames, st.cell)
    text = (tmp_path / "n.xyz").read_bytes()
    assert text == (tmp_path / "p.xyz").read_bytes() == (tmp_path / "j.xyz").read_bytes()
    back = tio.read_xyz(tmp_path / "n.xyz")
    np.testing.assert_array_equal(back.numbers, numbers)
    np.testing.assert_allclose(back.positions, frames[0], atol=1e-8)
    native.write_xyz_frames(tmp_path / "one.xyz", numbers, frames[0], st.cell)
    assert (tmp_path / "one.xyz").read_text().count("Lattice=") == 1
    with pytest.raises(ValueError, match="atoms"):
        native.write_xyz_frames(tmp_path / "bad.xyz", numbers[:-1], frames, st.cell)
    with pytest.raises(ValueError, match="out of range"):
        native.min_selected_distance(st.positions, st.cell, [0, len(st)])


# ----------------------------------------------------------------------
# structure/sites.py: symmetry reduction
# ----------------------------------------------------------------------
@pytest.mark.parametrize("slab_name", ["cu100", "cu111_like", "srtio3"])
def test_symmetry_reduction_matches_jax(slab_name):
    """The symmetry operations, the orbit representatives and the reduced
    site families are JAX's."""
    if slab_name == "cu100":
        slab = fcc100("Cu", size=(2, 2, 2), a=3.6147, vacuum=15.0)
    elif slab_name == "cu111_like":
        hexa = np.array([[2.556, 0, 0], [1.278, 2.2136, 0], [0, 0, 20.0]])
        slab = Structure([29, 29, 29], [[0, 0, 5.0], [1.278, 0.7379, 7.087],
                                        [2.556, 1.4757, 9.174]], hexa).repeat((2, 2, 1))
    else:
        slab = _srtio3()
    js = _jst(slab)
    ops, jops = sites.find_surface_symmetry_ops(slab), jsites.find_surface_symmetry_ops(js)
    assert len(ops) == len(jops) > 1
    for (w, t), (jw, jt) in zip(ops, jops):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(t, jt)
    all_sites = find_adsorption_sites(slab, planar_distance=1.5)["all"]
    np.testing.assert_array_equal(sites.symmetry_reduce_sites(slab, all_sites),
                                  jsites.symmetry_reduce_sites(js, all_sites))
    got = find_adsorption_sites(slab, planar_distance=1.5, symm_reduce=True)
    want = jsites.find_adsorption_sites(js, planar_distance=1.5, symm_reduce=True)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["all"]) < len(all_sites)
    assert len(sites.symmetry_reduce_sites(slab, np.zeros((0, 3)))) == 0


# ----------------------------------------------------------------------
# Weighted canonical proposals (analogs of tests/test_weighted_proposals.py)
# ----------------------------------------------------------------------
def _lj_system():
    slab = fcc100("Cu", size=(2, 2, 2), a=1.5 * 2**0.5, vacuum=10.0)
    site_coords = find_adsorption_sites(slab, planar_distance=1.2)["all"]
    spec = make_spec(slab, site_coords, ["Cu"], potential_numbers=[29], cutoff=3.0)
    pot = make_lennard_jones(epsilon=0.4, sigma=1.05, cutoff=3.0)
    return spec, MCMCRun(spec, pot, device="cpu")


def _zero_energy(d):
    def fn(ss):
        pos = realize_positions(d, ss)
        zero = torch.zeros(ss.shape[0])
        return StateEnergy(zero, zero, pos, torch.zeros(ss.shape[0], dtype=torch.bool))

    return fn


def test_distance_decay_prefers_nearby_swaps():
    """Distance-decay switch weights (``utils.misc.compute_distance_weight_matrix``,
    JAX's within 1e-12) keep a lone adsorbate's hops shorter than the mean
    site distance, over 60 steps of each of 16 chains."""
    spec, run = _lj_system()
    d = run.d
    dwm = misc.compute_distance_weight_matrix(spec.site_coords, distance_decay_factor=0.5)
    np.testing.assert_allclose(dwm, jmisc.compute_distance_weight_matrix(spec.site_coords, 0.5),
                               rtol=1e-12, atol=1e-12)
    assert np.allclose(dwm.sum(axis=1), 1.0)
    step = make_canonical_step(d, _zero_energy(d), criterion="testing",
                               require_distance_decay=True, distance_weight_matrix=dwm)
    S, C = spec.n_sites, 16
    ss0 = np.zeros((C, S), np.int64)
    ss0[:, 0] = 1
    state = initial_state(d, ss0)
    gen = make_generator(0, CPU)
    prev = np.zeros(C, np.int64)
    hops = []
    for _ in range(60):
        state, _ = step(state, 1.0, *canonical_draws(gen, C, S, d.n_codes))
        cur = state.site_state.argmax(dim=1).numpy()
        moved = cur != prev
        dist = np.linalg.norm(spec.site_coords[cur] - spec.site_coords[prev], axis=1)
        hops += dist[moved].tolist()
        prev = cur
    all_d = np.linalg.norm(spec.site_coords[None] - spec.site_coords[:, None], axis=-1)
    assert len(hops) > 100
    assert np.mean(hops) < all_d[all_d > 0].mean()


def test_boltzmann_weights_match_reference_vector():
    """(a) softmax(+E/T) reproduces the reference's pinned weights
    0.1850956 / 0.30517106 for per-atom energies [1.0, 0.5, 1.0, 0.6];
    (b) the canonical step's occupied-site draws follow those weights: over
    600 chains stepped once, the Ga site of E = 1.0 moves e^0.5 times as
    often as the one of E = 0.5 (JAX's bound, 0.45)."""
    w = torch.softmax(torch.tensor([1.0, 0.5, 1.0, 0.6], dtype=torch.float64), 0).numpy()
    assert abs(w[1] - 0.1850956) < 1e-6
    assert abs(w[0] - 0.30517106) < 1e-6
    np.testing.assert_allclose(w, np.asarray(jax.nn.softmax(jnp.asarray([1.0, 0.5, 1.0, 0.6]))),
                               rtol=1e-6)

    slab = Structure.from_symbols(["Cu"], [[0.0, 0.0, 0.0]], np.eye(3) * 30.0)
    site_coords = np.array([[4.0, 4, 3], [8.0, 8, 3], [12.0, 12, 3], [16.0, 16, 3]])
    spec = make_spec(slab, site_coords, ["Ga", "As"], potential_numbers=[29], cutoff=3.0,
                     surface_name="wtest")
    run = MCMCRun(spec, make_lennard_jones(epsilon=0.1, sigma=1.0, cutoff=3.0), device="cpu")
    d = run.d
    n_p = spec.n_pristine
    pa_vec = torch.zeros(n_p + 4)
    pa_vec[n_p], pa_vec[n_p + 1] = 1.0, 0.5
    stub = Potential(energy=lambda *a: torch.zeros(a[0].shape[0]),
                     per_atom_energy=lambda pos, ti, alive, sh: pa_vec * alive,
                     cutoff=3.0, name="stub")
    step = make_canonical_step(d, _zero_energy(d), criterion="testing",
                               require_per_atom_energies=True, potential=stub)
    C = 600
    ss0 = np.tile(np.array([1, 1, 2, 0]), (C, 1))
    state = initial_state(d, ss0)
    state, _ = step(state, 1.0, *canonical_draws(make_generator(0, CPU), C, 4, d.n_codes))
    new = state.site_state.numpy()
    picked = [int((new[:, 0] != 1).sum()), int(((new[:, 0] == 1) & (new[:, 1] != 1)).sum())]
    ratio = picked[0] / max(picked[1], 1)
    want = float(np.exp(1.0 - 0.5))
    assert abs(ratio - want) < 0.45, (picked, ratio, want)
