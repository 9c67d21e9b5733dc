"""The rest of the port's ``structure/slabs.py`` and its structure-tool CLIs
(``cut_surfaces``, ``filter_stoichiometries``, ``perturb_structures``,
``create_surface_formation_entries``, ``clustering``) against the JAX
package's on the CPU (``--device cpu``), and example 08's selection round.

Inputs: those of ``tests/test_cli.py`` (bulk Cu, the Ir-O-H / Mn-O-H
three-atom cells with Lennard-Jones, six jittered SrTiO3(001) 2x2 slabs
with the flagship PaiNN) and example 05's SrTiO3 slabs. Tolerances: slab
numbers exact, positions and cells 1e-12 A; CIF text, kept sets, perturbed
positions and corrections exact; energies 1e-3 eV (relaxed 5e-3);
clustering embeddings 1e-4 x max|jax|, the same partition and the same
selected indices.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from surface_sampling_tpu.structure import bulk as j_bulk
from surface_sampling_tpu.structure import find_adsorption_sites as j_sites
from surface_sampling_tpu.structure import slabs as jslabs
from surface_sampling_tpu.structure.io import load_structures_npz as j_load
from surface_sampling_tpu.structure.io import write_cif as j_write_cif
from surface_sampling_tpu_torch.structure import (
    Structure,
    SupercellSurfaceGenerator,
    bulk,
    fcc110,
    fcc111,
    find_adsorption_sites,
    surface_from_bulk,
    symmetrize_slab,
)
from surface_sampling_tpu_torch.structure.io import load_structures_npz, write_cif

REPO = Path(__file__).resolve().parent.parent
PD = str(REPO / "tests/data/pourbaix/pd_dict.json")
E_TOL, RELAX_TOL, POS_TOL = 1e-3, 5e-3, 1e-12
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_structure(a, b, tol=POS_TOL):
    np.testing.assert_array_equal(a.numbers, b.numbers)
    np.testing.assert_allclose(a.positions, b.positions, rtol=0, atol=tol)
    np.testing.assert_allclose(a.cell, b.cell, rtol=0, atol=tol)


def test_structures_npz_layouts(tmp_path):
    """Structures of one size keep the JAX package's stacked layout (its
    loader reads the port's file); structures of different sizes, which the
    JAX writer refuses, round-trip through the ragged layout."""
    from surface_sampling_tpu.structure.io import save_structures_npz as j_save
    from surface_sampling_tpu_torch.structure.io import save_structures_npz

    rng = np.random.default_rng(0)
    same = [Structure(rng.integers(1, 30, 4), rng.normal(size=(4, 3)), np.eye(3) * 6)
            for _ in range(3)]
    save_structures_npz(tmp_path / "same.npz", same, energies=[1.0, 2.0, 3.0])
    j_save(tmp_path / "same_jax.npz", [jslabs.Structure(s.numbers, s.positions, s.cell)
                                       for s in same], energies=[1.0, 2.0, 3.0])
    for path in (tmp_path / "same.npz", tmp_path / "same_jax.npz"):
        theirs, e = j_load(path)
        ours, e2 = load_structures_npz(path)
        np.testing.assert_array_equal(e, e2)
        for a, b, c in zip(ours, theirs, same):
            _same_structure(a, b, 0.0)
            _same_structure(a, c, 0.0)
    ragged = [Structure(rng.integers(1, 30, n), rng.normal(size=(n, 3)), np.eye(3) * n)
              for n in (3, 5, 4)]
    with pytest.raises(ValueError):
        j_save(tmp_path / "ragged_jax.npz", [jslabs.Structure(s.numbers, s.positions, s.cell)
                                             for s in ragged])
    save_structures_npz(tmp_path / "ragged.npz", ragged, energies=[0.5, 1.5, 2.5])
    back, e = load_structures_npz(tmp_path / "ragged.npz")
    np.testing.assert_array_equal(e, [0.5, 1.5, 2.5])
    for a, b in zip(back, ragged):
        _same_structure(a, b, 0.0)


@pytest.mark.parametrize("face", ["fcc110", "fcc111"])
def test_fcc_slabs_match_jax(face):
    ours = {"fcc110": fcc110, "fcc111": fcc111}[face]
    theirs = getattr(jslabs, face)
    for size, a, vac in (((2, 3, 4), 3.6147, 10.0), ((3, 3, 3), 4.078, 12.5)):
        _same_structure(ours("Cu", size, a, vac), theirs("Cu", size, a, vac))


def test_symmetrize_slab_matches_jax():
    rng = np.random.default_rng(0)
    slab = fcc111("Pt", (2, 2, 4), 3.92, 10.0)
    slab.positions = slab.positions + 0.05 * rng.normal(size=slab.positions.shape)
    jslab = jslabs.Structure(slab.numbers, slab.positions, slab.cell)
    for n_base, sort in ((4, True), (8, False)):
        _same_structure(symmetrize_slab(slab, n_base, sort),
                        jslabs.symmetrize_slab(jslab, n_base, sort))


def test_example05_slabs_match_jax(tmp_path):
    """Example 05: SrTiO3 bulk, the 2x2x4 (001) slab and its sites, the
    SupercellSurfaceGenerator slab (and rotated, odd-sized ones), POSCAR."""
    sto, jsto = bulk(["Sr", "Ti", "O"], "perovskite", a=3.905), \
        j_bulk(["Sr", "Ti", "O"], "perovskite", a=3.905)
    slab, mask = surface_from_bulk(sto, (0, 0, 1), size=(2, 2), layers=4, vacuum=12.0)
    jslab, jmask = jslabs.surface_from_bulk(jsto, (0, 0, 1), size=(2, 2), layers=4,
                                            vacuum=12.0)
    _same_structure(slab, jslab)
    np.testing.assert_array_equal(mask, jmask)
    sites, jsites = find_adsorption_sites(slab, planar_distance=1.5), \
        j_sites(jslab, planar_distance=1.5)
    for fam in ("ontop", "bridge", "hollow"):
        np.testing.assert_allclose(sites[fam], jsites[fam], rtol=0, atol=POS_TOL)
    gen = SupercellSurfaceGenerator(sto, (0, 0, 1), min_slab_layers=3)
    jgen = jslabs.SupercellSurfaceGenerator(jsto, (0, 0, 1), min_slab_layers=3)
    for args in ((2.0, 2.0, 0.0), (3.0, 2.0, 45.0), (2.0, 2.0, 90.0)):
        _same_structure(gen.get_supercell_slab(*args), jgen.get_supercell_slab(*args))
    assert gen.hkl_to_hkil == jgen.hkl_to_hkil == (0, 0, 0, 1)
    sc = gen.get_supercell_slab(2.0, 2.0)
    assert len(sc) == 4 * len(gen.get_primitive_slab())
    gen.save_slab(sc, tmp_path / "POSCAR")
    jgen.save_slab(jgen.get_supercell_slab(2.0, 2.0), tmp_path / "POSCAR_jax")
    assert (tmp_path / "POSCAR").read_text() == (tmp_path / "POSCAR_jax").read_text()


def test_cut_surfaces_cli_matches_jax(tmp_path):
    from surface_sampling_tpu.cli.cut_surfaces import main as j_main
    from surface_sampling_tpu_torch.cli.cut_surfaces import main

    write_cif(tmp_path / "cu.cif", bulk("Cu", "fcc", 3.6147))
    write_cif(tmp_path / "sto.cif", bulk(["Sr", "Ti", "O"], "perovskite", a=3.905))
    for miller, size in ((["1", "0", "0"], ["2", "2"]), (["1", "1", "1"], ["1", "2"])):
        argv = ["--bulk", str(tmp_path / "cu.cif"), str(tmp_path / "sto.cif"),
                "--miller", *miller, "--size", *size, "--layers", "3"]
        main(argv + ["--out", str(tmp_path / "p")])
        j_main(argv + ["--out", str(tmp_path / "j")])
    ours = sorted((tmp_path / "p").glob("*.cif"))
    assert len(ours) == 4
    assert [p.name for p in ours] == [p.name for p in sorted((tmp_path / "j").glob("*.cif"))]
    for p in ours:
        assert p.read_text() == (tmp_path / "j" / p.name).read_text()


def test_perturb_and_filter_cli_match_jax(tmp_path):
    from surface_sampling_tpu.cli.filter_stoichiometries import main as j_filter
    from surface_sampling_tpu.cli.perturb_structures import main as j_perturb
    from surface_sampling_tpu_torch.cli.filter_stoichiometries import main as filter_main
    from surface_sampling_tpu_torch.cli.perturb_structures import main as perturb_main

    p = tmp_path / "bulk.cif"
    write_cif(p, bulk("Cu", "fcc", 3.6147))
    st = Structure.from_symbols(["Ir", "O", "H", "H"],
                                [[0, 0, 0], [0, 0, 2], [0, 0, 3], [0, 1.5, 2.5]], np.eye(3) * 10)
    write_cif(tmp_path / "iroh.cif", st)
    sp = tmp_path / "settings.json"
    sp.write_text(json.dumps({"calc_settings": {"calc_name": "lj", "epsilon": 0.1,
                                                "sigma": 1.5, "cutoff": 4.0}}))
    argv = ["--structures", str(p), str(tmp_path / "iroh.cif"), "--amplitude", "0.05",
            "--n-perturb", "3", "--displace-lattice", "--seed", "3", "--settings", str(sp)]
    perturb_main(argv + ["--out", str(tmp_path / "pp")] + CPU)
    j_perturb(argv + ["--out", str(tmp_path / "jp")])
    ours, e_ours = load_structures_npz(tmp_path / "pp" / "perturbed.npz")
    theirs, e_theirs = j_load(tmp_path / "jp" / "perturbed.npz")
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.cell, b.cell)
    np.testing.assert_allclose(e_ours, e_theirs, rtol=0, atol=E_TOL)
    # no --settings: no energies, no device
    perturb_main(["--structures", str(p), "--n-perturb", "2", "--out", str(tmp_path / "nn")])
    assert np.isnan(load_structures_npz(tmp_path / "nn" / "perturbed.npz")[1]).all()

    src = str(tmp_path / "pp" / "perturbed.npz")
    for ranges in ({"Cu": [4, 4]}, {"Cu": [0, 1]}, {"O": [1, 1], "H": [0, 2]}):
        filter_main(["--structures", src, "--ranges", json.dumps(ranges),
                     "--out", str(tmp_path / "f.npz")])
        j_filter(["--structures", src, "--ranges", json.dumps(ranges),
                  "--out", str(tmp_path / "jf.npz")])
        kept, jkept = load_structures_npz(tmp_path / "f.npz")[0], j_load(tmp_path / "jf.npz")[0]
        assert [s.formula for s in kept] == [s.formula for s in jkept]
        for a, b in zip(kept, jkept):
            np.testing.assert_array_equal(a.positions, b.positions)
    (tmp_path / "r.json").write_text(json.dumps({"Cu": [4, 4]}))
    filter_main(["--structures", src, "--ranges", str(tmp_path / "r.json"),
                 "--out", str(tmp_path / "f2.npz")])
    assert len(load_structures_npz(tmp_path / "f2.npz")[0]) == 3


@pytest.mark.parametrize("flags", [["--oh-correction"],
                                   ["--oh-correction", "--oxide-correction"],
                                   ["--mp2020", "--aqueous", "--oh-correction"],
                                   ["--relax", "--relax-steps", "10", "--mp2020"]])
def test_formation_entries_cli_matches_jax(tmp_path, flags):
    from surface_sampling_tpu.cli.create_surface_formation_entries import main as j_main
    from surface_sampling_tpu_torch.cli.create_surface_formation_entries import main

    paths = []
    for syms in (["Ir", "O", "H"], ["Mn", "O", "H"]):
        st = Structure.from_symbols(syms, [[0, 0, 0], [0, 0, 2], [0, 0, 3]], np.eye(3) * 10)
        paths.append(str(tmp_path / f"{syms[0]}.cif"))
        write_cif(paths[-1], st)
    sp = tmp_path / "settings.json"
    sp.write_text(json.dumps({"calc_settings": {"calc_name": "lj", "epsilon": 0.1,
                                                "sigma": 1.5, "cutoff": 4.0}}))
    argv = ["--structures", *paths, "--settings", str(sp), "--phase-diagram", PD] + flags
    main(argv + ["--out", str(tmp_path / "p.json")] + CPU)
    j_main(argv + ["--out", str(tmp_path / "j.json")])
    ours = json.loads((tmp_path / "p.json").read_text())
    theirs = json.loads((tmp_path / "j.json").read_text())
    tol = RELAX_TOL if "--relax" in flags else E_TOL
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        assert a["composition"] == b["composition"]
        assert a["corrections"] == b["corrections"]
        assert a["parameters"] == b["parameters"]
        assert abs(a["energy"] - b["energy"]) <= tol
        assert abs(a["formation_energy"] - b["formation_energy"]) <= tol


@pytest.fixture(scope="module")
def sto_structures(tmp_path_factory):
    from surface_sampling_tpu_torch.structure.io import save_structures_npz

    tmp = tmp_path_factory.mktemp("clust")
    with np.load(REPO / "surface_sampling_tpu/systems_data/SrTiO3_001_2x2.npz") as data:
        base = Structure(data["numbers"], data["positions"], data["cell"])
    rng = np.random.default_rng(0)
    sts = []
    for k in range(6):
        st = base.copy()
        st.positions = st.positions + 0.05 * k * rng.standard_normal(st.positions.shape)
        sts.append(st)
    save_structures_npz(tmp / "structs.npz", sts)
    sp = tmp / "settings.json"
    sp.write_text(json.dumps({"calc_settings": {
        "calc_name": "nff",
        "model_paths": [str(REPO / f"surface_sampling_tpu/models/data/srtio3_painn_0{i}.npz")
                        for i in (1, 2, 3)],
        "elements": ["Sr", "Ti", "O"],
        "model_units": "kcal/mol",
    }}))
    return tmp, sts, sp


def test_clustering_cli_matches_jax(sto_structures, tmp_path):
    """The flagship ensemble's embeddings of six jittered slabs: the same
    partition, the same representatives, the artifacts of the JAX CLI."""
    from surface_sampling_tpu.cli.clustering import main as j_main
    from surface_sampling_tpu_torch.cli.clustering import main

    tmp, _, sp = sto_structures
    argv = ["--structures", str(tmp / "structs.npz"), "--settings", str(sp),
            "--metric", "energy", "--criterion", "maxclust", "--cutoff", "3"]
    main(argv + ["--out", str(tmp_path / "p")] + CPU)
    j_main(argv + ["--out", str(tmp_path / "j")])
    d, jd = np.load(tmp_path / "p" / "clustering.npz"), np.load(tmp_path / "j" / "clustering.npz")
    assert sorted(d.files) == sorted(jd.files)
    scale = float(np.abs(jd["embeddings"]).max())
    np.testing.assert_allclose(d["embeddings"], jd["embeddings"], rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(d["metrics"], jd["metrics"], rtol=0, atol=E_TOL)
    np.testing.assert_array_equal(d["labels"], jd["labels"])
    np.testing.assert_array_equal(d["selected"], jd["selected"])
    assert len(d["selected"]) == len(np.unique(d["labels"])) <= 3
    ours, e = load_structures_npz(tmp_path / "p" / "clustered.npz")
    assert len(ours) == len(d["selected"])
    np.testing.assert_allclose(e, d["metrics"][d["selected"]])


def test_clustering_metrics_match_jax(sto_structures):
    """force_std reads the ensemble's energy_std (as JAX does); random is
    JAX's default_rng(0) draw; gmm fits by EM on the device (JAX below
    20,000 structures: sklearn) and scores every structure finitely."""
    from surface_sampling_tpu.cli.clustering import compute_embeddings_and_metric as j_cem
    from surface_sampling_tpu_torch.cli.clustering import compute_embeddings_and_metric

    _, sts, sp = sto_structures
    calc = json.loads(sp.read_text())["calc_settings"]
    jsts = [jslabs.Structure(s.numbers, s.positions, s.cell) for s in sts[:3]]
    emb, m = compute_embeddings_and_metric(sts[:3], calc, "force_std", "cpu")
    jemb, jm = j_cem(jsts, calc, "force_std")
    np.testing.assert_allclose(m, jm, rtol=0, atol=E_TOL)
    assert (m > 0).all()
    _, m_r = compute_embeddings_and_metric(sts[:3], calc, "random", "cpu")
    np.testing.assert_array_equal(m_r, j_cem(jsts, calc, "random")[1])
    emb_g, m_g = compute_embeddings_and_metric(sts[:3], calc, "gmm", "cpu")
    assert m_g.shape == (3,) and np.isfinite(m_g).all()
    np.testing.assert_array_equal(emb_g, emb)


def test_example08_round_picks_jax_representatives():
    """Example 08's round (embed every sampled state over its alive atoms,
    cluster with maxclust 3, pick the most uncertain member per cluster)
    on JAX's trained parameters and JAX's sampled site states, carried
    over by ``models.weights.from_jax_params``: the same partition, spreads
    within 1e-5 eV, the same representative structures."""
    import jax
    import jax.numpy as jnp

    from surface_sampling_tpu.analysis import perform_clustering as j_cluster
    from surface_sampling_tpu.analysis import select_representatives as j_select
    from surface_sampling_tpu.core import EngineConfig as JEngineConfig
    from surface_sampling_tpu.core import MCMCRun as JMCMCRun
    from surface_sampling_tpu.core import geometric_schedule
    from surface_sampling_tpu.core import make_spec as j_make_spec
    from surface_sampling_tpu.core.state import realize_alive as j_alive
    from surface_sampling_tpu.core.state import realize_positions as j_pos
    from surface_sampling_tpu.models import PaiNNConfig as JPaiNNConfig
    from surface_sampling_tpu.models.ensemble import ensemble_apply as j_ensemble_apply
    from surface_sampling_tpu.models.nn_calculator import make_painn_potential as j_make_pot
    from surface_sampling_tpu.core.state import device_spec as device_spec_j
    from surface_sampling_tpu.models.train import TrainConfig, pad_structures, train_painn
    from surface_sampling_tpu.models.train import init_ensemble as j_init_ensemble
    from surface_sampling_tpu.potentials import make_lennard_jones
    from surface_sampling_tpu_torch.analysis import perform_clustering, select_representatives
    from surface_sampling_tpu_torch.core.spec import make_spec
    from surface_sampling_tpu_torch.core.state import device_spec, realize_alive, realize_positions
    from surface_sampling_tpu_torch.models.ensemble import ensemble_apply
    from surface_sampling_tpu_torch.models.painn import PaiNNConfig
    from surface_sampling_tpu_torch.models.weights import from_jax_params
    from surface_sampling_tpu_torch.ops.neighbors import image_search_edges

    a = 3.6147
    jslab = jslabs.fcc100("Cu", size=(3, 3, 2), a=a, vacuum=10.0)
    jsites_ = j_sites(jslab, planar_distance=2.0)["ontop"]
    jspec = j_make_spec(jslab, jsites_, ["Cu"], potential_numbers=[29], cutoff=5.0)
    kw = dict(feat_dim=16, n_rbf=8, cutoff=5.0, n_layers=2, readout_hidden=8, max_neighbors=32)
    jparams = j_init_ensemble(jax.random.PRNGKey(0), JPaiNNConfig(**kw), 2)
    # the round's training, on 16 random occupancies labelled by the LJ truth
    # (example 08 trains 40 epochs; a few suffice for the selection's inputs)
    truth = make_lennard_jones(epsilon=0.4, sigma=2.3, cutoff=5.0)
    dj = device_spec_j(jspec)
    frames, es, fs = [], [], []
    for occ in np.random.default_rng(0).integers(0, 2, (16, len(jsites_))):
        # every slot with the alive mask: one shape, one compilation
        ssj = jnp.asarray(occ, jnp.int32)
        alive, pos = j_alive(dj, ssj), j_pos(dj, ssj)
        e, f = truth.energy_and_forces(pos, jnp.zeros(len(pos), jnp.int32), alive,
                                       jnp.asarray(jspec.shifts, jnp.float32))
        alive = np.asarray(alive)
        frames.append(jslabs.Structure(np.full(int(alive.sum()), 29), np.asarray(pos)[alive],
                                       jspec.cell))
        es.append(float(e))
        fs.append(np.asarray(f)[alive])
    batch = pad_structures(frames, es, fs, 5.0, n_max=jspec.n_slots)
    jparams, hist = train_painn(jparams, JPaiNNConfig(**kw), [batch],
                                TrainConfig(epochs=4, learning_rate=3e-3), ensemble=True)
    assert hist[-1] < hist[0]
    jpot = j_make_pot(jparams, JPaiNNConfig(**kw), [29], units="eV", ensemble=True)
    run = JMCMCRun(jspec, jpot)
    _, rec = run.run(jax.random.PRNGKey(1), geometric_schedule(1.0, 8, 0.97),
                     cfg=JEngineConfig(sweep_size=6, record_positions=False))
    states = np.asarray(rec.site_state)
    d, shifts_j = run.d, jnp.asarray(jspec.shifts, jnp.float32)
    jembs, juncs = [], []
    for ss in states:
        ssj = jnp.asarray(ss)
        alive = j_alive(d, ssj)
        out = j_ensemble_apply(jparams, JPaiNNConfig(**kw), j_pos(d, ssj),
                               jnp.where(alive, 29, 0).astype(jnp.int32), alive, shifts_j)
        jembs.append(np.asarray(out["embedding"])[np.asarray(alive)].mean(axis=0))
        juncs.append(float(out["energy_std"]))
    jpicks = j_select(j_cluster(np.stack(jembs), 3, "maxclust"), np.asarray(juncs), "force_std")

    slab = Structure(jslab.numbers, jslab.positions, jslab.cell)
    spec = make_spec(slab, find_adsorption_sites(slab, planar_distance=2.0)["ontop"], ["Cu"],
                     potential_numbers=[29], cutoff=5.0)
    dspec, cfg = device_spec(spec, torch.device("cpu")), PaiNNConfig(**kw)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    shifts = torch.as_tensor(spec.shifts, dtype=torch.float32)
    ss = torch.as_tensor(np.array(states), dtype=torch.int64)
    pos, alive = realize_positions(dspec, ss), realize_alive(dspec, ss)
    edges = image_search_edges(pos, alive, shifts, cfg.cutoff, cfg.max_neighbors)
    with torch.no_grad():
        out = ensemble_apply(params, cfg, torch.where(alive, 29, 0), alive, edges)
    embs = [out["embedding"][i][alive[i]].mean(dim=0) for i in range(len(states))]
    labels = perform_clustering(torch.stack(embs), 3, "maxclust")
    picks = select_representatives(labels, out["energy_std"], "force_std")
    np.testing.assert_allclose(torch.stack(embs).numpy(), np.stack(jembs), rtol=0,
                               atol=1e-4 * float(np.abs(jembs).max()))
    np.testing.assert_array_equal(labels, j_cluster(np.stack(jembs), 3, "maxclust"))
    np.testing.assert_allclose(out["energy_std"].numpy(), juncs, rtol=0, atol=1e-5)
    # the same structures: a chain that stays put records one state twice,
    # and the two copies' spreads tie up to f32 rounding
    # the same representative wherever a cluster's largest spread is unique;
    # where symmetry-equivalent states tie up to f32 rounding, a member of
    # the tie (its JAX spread the cluster's largest within 1e-5 eV)
    juncs = np.asarray(juncs)
    for c, p, jp in zip(np.unique(labels), picks, jpicks):
        members = np.where(labels == c)[0]
        ties = members[juncs[members] >= juncs[jp] - 1e-5]
        assert p in ties, (c, p, jp, juncs[members])
        if len(ties) == 1:
            assert p == jp
    assert len(np.unique(labels)) == len(picks) <= 3
