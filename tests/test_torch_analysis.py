"""The port's analysis layer (``analysis/clustering.py``,
``analysis/uncertainty.py``) against the JAX package's on the CPU.

The same inputs, made from a seed with numpy, go through both packages.
Tolerances: the host numpy / scipy functions (PCA, Ward clustering,
representative selection, cluster centres, conformal ``qhat``) are held
equal; ``reduce_order`` on numpy arrays equal, on tensors 1e-12 (f64);
``log_prob`` 1e-5 relative (f32 einsums); the chunked EM fit 1e-4 relative
in the mean log-likelihood and 1e-3 x the data's spread in the means; the
EM's log-likelihood at least sklearn's less 0.05 (JAX's own bar). Where
JAX's EM returns NaN (tight, far-apart clusters), the port's converges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_sampling_tpu.analysis import clustering as jclust
from surface_sampling_tpu.analysis import uncertainty as junc
from surface_sampling_tpu_torch.analysis import (
    ConformalPrediction,
    EnsembleUncertainty,
    GMMUncertainty,
    Uncertainty,
    find_closest_points_indices,
    fit_gmm_em,
    get_cluster_centers,
    get_unc_class,
    pca_whiten,
    perform_clustering,
    reduce_order,
    select_data_and_save,
    select_representatives,
)
from surface_sampling_tpu_torch.analysis.uncertainty import ORDERS

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed=3, n=30, dim=64):
    rng = np.random.default_rng(seed)
    centers = np.zeros((4, dim))
    centers[1, 0], centers[2, 1], centers[3, 2] = 50.0, 50.0, 50.0
    return np.concatenate([c + rng.normal(0, 1.0, (n, dim)) for c in centers])


@pytest.mark.parametrize("order", ORDERS)
def test_reduce_order_matches_jax(order):
    v = np.random.default_rng(0).normal(size=(5, 7))
    ref = np.asarray(junc.reduce_order(v, order))
    np.testing.assert_array_equal(reduce_order(v, order), ref)
    got = reduce_order(torch.as_tensor(v), order)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        reduce_order(v, "system_median")


def test_conformal_prediction_qhat_exact():
    rng = np.random.default_rng(0)
    unc = rng.uniform(0.5, 2.0, 1000)
    resid = unc * rng.normal(0, 1.0, 1000)
    ours, theirs = ConformalPrediction(alpha=0.05), junc.ConformalPrediction(alpha=0.05)
    ours.fit(resid, unc)
    theirs.fit(resid, unc)
    assert ours.qhat == theirs.qhat
    assert 1.7 < ours.qhat < 2.3
    scaled, _ = ours.predict(torch.as_tensor(unc))
    assert float(np.mean(np.abs(resid) <= scaled.numpy())) > 0.9
    # tensors fit too, to the same quantile
    cp_t = ConformalPrediction(alpha=0.05)
    cp_t.fit(torch.as_tensor(resid), torch.as_tensor(unc))
    assert cp_t.qhat == theirs.qhat


def test_ensemble_uncertainty_matches_jax():
    rng = np.random.default_rng(4)
    fstd = np.abs(rng.normal(size=(10, 3))).astype(np.float32)
    for order in ("system_mean", "system_max", "atomic"):
        ours = EnsembleUncertainty(order=order, quantity="forces")
        theirs = junc.EnsembleUncertainty(order=order, quantity="forces")
        np.testing.assert_allclose(
            np.asarray(ours.get_uncertainty(forces_std=torch.as_tensor(fstd))),
            np.asarray(theirs.get_uncertainty(forces_std=jnp.asarray(fstd))), rtol=1e-6)
    me = np.array([1.0, 2.0, 3.0], np.float32)
    u_e = EnsembleUncertainty(order="system_mean", quantity="energy")
    assert np.isclose(float(u_e.get_uncertainty(member_energy=torch.as_tensor(me))),
                      np.std([1, 2, 3]))
    # min-uncertainty shift and conformal scaling, as the base class does
    cal = EnsembleUncertainty(order="system_mean", calibrate=True, min_uncertainty=0.1)
    cal.fit_conformal_prediction(np.array([1.0, 2, 1.5]), np.array([1.0, 1, 1]))
    jcal = junc.EnsembleUncertainty(order="system_mean", calibrate=True, min_uncertainty=0.1)
    jcal.fit_conformal_prediction(np.array([1.0, 2, 1.5]), np.array([1.0, 1, 1]))
    assert np.isclose(float(cal(forces_std=torch.as_tensor(fstd))),
                      float(jcal(forces_std=jnp.asarray(fstd))), rtol=1e-6)
    assert isinstance(get_unc_class("ensemble", order="system_sum"), EnsembleUncertainty)


def _gmm_params(seed=2, c=3, d=6):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 2.0, (c, d))
    a = rng.normal(size=(c, d, d))
    cov = a @ a.transpose(0, 2, 1) + d * np.eye(d)
    prec_chol = np.linalg.inv(np.linalg.cholesky(cov)).transpose(0, 2, 1)
    w = rng.uniform(0.5, 1.5, c)
    return {"means": means, "precisions_cholesky": prec_chol, "weights": w / w.sum()}


def test_log_prob_matches_jax():
    p = _gmm_params()
    x = np.random.default_rng(5).normal(0, 3.0, (40, 6))
    ours = GMMUncertainty(n_components=3, gmm_params=p)
    theirs = junc.GMMUncertainty(n_components=3, gmm_params=p)
    lp = ours.log_prob(torch.as_tensor(x))
    assert lp.dtype == torch.float32 and lp.shape == (40,)
    np.testing.assert_allclose(lp.numpy(), np.asarray(theirs.log_prob(x)), rtol=1e-5)
    # the scored uncertainty under an order, and bic / aic
    for order in ("atomic", "system_mean"):
        ours.order = theirs.order = order
        np.testing.assert_allclose(np.asarray(ours.get_uncertainty(x)),
                                   np.asarray(theirs.get_uncertainty(x)), rtol=1e-5)
    assert np.isclose(ours.bic(x), theirs.bic(x), rtol=1e-5)
    assert np.isclose(ours.aic(x), theirs.aic(x), rtol=1e-5)


@pytest.mark.parametrize("chunk", [128, 4096])
def test_fit_gmm_em_matches_jax(chunk):
    rng = np.random.default_rng(0)
    centers = np.array([[0.0, 0.0, 0.0], [6.0, 0.0, 0.0], [0.0, 7.0, 0.0]])
    X = np.concatenate([c + 0.5 * rng.standard_normal((400, 3)) for c in centers]) + 40.0
    ours, info = fit_gmm_em(X, 3, chunk=chunk, seed=1, device="cpu", return_info=True)
    theirs = junc.fit_gmm_em(X, 3, chunk=chunk, seed=1)
    assert 1 <= info["n_iter"] <= 60
    ll_o = float(GMMUncertainty(n_components=3, gmm_params=ours).log_prob(X).mean())
    ll_t = float(np.mean(np.asarray(junc.GMMUncertainty(
        n_components=3, gmm_params=theirs).log_prob(X))))
    assert abs(ll_o - ll_t) <= 1e-4 * abs(ll_t), (ll_o, ll_t)
    np.testing.assert_allclose(ours["means"], theirs["means"], rtol=0,
                               atol=1e-3 * float(X.std(axis=0).max()))
    np.testing.assert_allclose(ours["weights"], theirs["weights"], atol=1e-4)
    for c in centers:
        assert np.min(np.linalg.norm(ours["means"] - 40.0 - c, axis=1)) < 0.2
    # a tensor input fits on its own device, to the same parameters
    again = fit_gmm_em(torch.as_tensor(X), 3, chunk=chunk, seed=1)
    for k in ours:
        np.testing.assert_array_equal(again[k], ours[k])


def test_fit_gmm_em_on_tight_far_apart_clusters():
    """Per-atom embeddings gather in tight, far-apart clusters of repeated
    environments: JAX's float32 scatter and Cholesky lose positive
    definiteness there and its fit comes back NaN (a reference-side gap);
    the port's float64 pass converges to finite parameters that score the
    data."""
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.normal(size=(6, 32))
    X = np.concatenate([(c + 0.01 * rng.normal(size=(40, 32)))[rng.integers(0, 40, 400)]
                        for c in centers]) + 5.0
    theirs = junc.fit_gmm_em(X, 8, chunk=512)
    assert np.isnan(theirs["means"]).any()
    ours, info = fit_gmm_em(X, 8, chunk=512, device="cpu", return_info=True)
    assert all(np.isfinite(v).all() for v in ours.values())
    assert info["n_iter"] < 60 and np.isfinite(info["mean_log_likelihood"])
    lp = GMMUncertainty(n_components=8, gmm_params=ours).log_prob(X)
    assert torch.isfinite(lp).all()
    for c in centers:
        assert np.min(np.linalg.norm(ours["means"] - 5.0 - c, axis=1)) < 0.05


def test_gmm_em_fit_matches_sklearn_quality():
    """The EM fit reaches sklearn's log-likelihood on the same data (the
    bar of the JAX package's test of its own EM), and the fit_gmm front
    door scores out-of-distribution points far lower."""
    from sklearn.mixture import GaussianMixture

    rng = np.random.default_rng(0)
    centers = np.array([[0.0, 0.0, 0.0], [6.0, 0.0, 0.0], [0.0, 7.0, 0.0]])
    X = np.concatenate([c + 0.5 * rng.standard_normal((400, 3)) for c in centers])
    gu = GMMUncertainty(n_components=3, order="atomic")
    gu.fit_gmm(X, method="em", chunk=256, device="cpu")
    ll_em = float(gu.log_prob(X).mean())
    ll_sk = float(GaussianMixture(n_components=3, random_state=0).fit(X).score(X))
    assert ll_em > ll_sk - 0.05, (ll_em, ll_sk)
    nll_in = float(gu.get_uncertainty(X[:50]).mean())
    nll_out = float(gu.get_uncertainty(X[:50] + np.array([30.0, 0, 0])).mean())
    assert nll_out > nll_in + 10
    # the sklearn fit on request, scored by the same torch log_prob
    gs = GMMUncertainty(n_components=3)
    gs.fit_gmm(X, method="sklearn")
    np.testing.assert_allclose(gs.log_prob(X[:20]).numpy(),
                               GaussianMixture(n_components=3, random_state=0).fit(X)
                               .score_samples(X[:20]), atol=1e-4)


def test_fit_gmm_refusals(monkeypatch):
    import builtins

    gu = GMMUncertainty(n_components=2)
    with pytest.raises(ValueError, match="unknown GMM fit method"):
        gu.fit_gmm(np.zeros((4, 2)), method="kmeans")
    with pytest.raises(RuntimeError, match="call fit_gmm first"):
        gu.get_uncertainty(np.zeros((4, 2)))
    real_import = builtins.__import__

    def no_sklearn(name, *a, **kw):
        if name.startswith("sklearn"):
            raise ImportError("no sklearn")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    with pytest.raises(ImportError, match="method='em'"):
        gu.fit_gmm(np.zeros((4, 2)), method="sklearn")
    # numpy data fits on the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gu.fit_gmm(np.random.default_rng(0).normal(size=(20, 2)))


def test_gmm_bic_aic_prefer_true_component_count():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 1, (300, 3)), rng.normal(8, 1, (300, 3))])
    bics, aics = {}, {}
    for k in (1, 2, 5):
        gu = GMMUncertainty(n_components=k)
        gu.fit_gmm(X, device="cpu")
        bics[k], aics[k] = gu.bic(X), gu.aic(X)
    assert bics[2] < bics[1] and bics[2] < bics[5]
    assert aics[2] < aics[1]


def test_gmm_uncertainty_separates_ood():
    rng = np.random.default_rng(1)
    gu = GMMUncertainty(order="atomic", n_components=4)
    gu.fit_gmm(rng.normal(0, 1.0, (500, 8)), device="cpu")
    nll_in = gu.get_uncertainty(rng.normal(0, 1.0, (50, 8))).numpy()
    nll_out = gu.get_uncertainty(rng.normal(8.0, 1.0, (50, 8))).numpy()
    assert nll_out.mean() > nll_in.mean() + 10


def test_uncertainty_save_load(tmp_path):
    eu = EnsembleUncertainty(order="system_max", calibrate=True)
    eu.fit_conformal_prediction(np.array([1.0, 2, 1.5]), np.array([1.0, 1, 1]))
    eu.save(tmp_path / "unc.pkl")
    back = Uncertainty.load(tmp_path / "unc.pkl")
    assert back.order == "system_max" and back.cp.qhat == eu.cp.qhat
    gu = GMMUncertainty(n_components=3, gmm_params=_gmm_params())
    gu.save(tmp_path / "gmm.pkl")
    x = np.random.default_rng(1).normal(size=(5, 6))
    np.testing.assert_array_equal(Uncertainty.load(tmp_path / "gmm.pkl").log_prob(x).numpy(),
                                  gu.log_prob(x).numpy())


def test_pca_and_clustering_identical_to_jax():
    X = _blobs()
    X_r, evr = pca_whiten(X, 32)
    jX_r, jevr = jclust.pca_whiten(X, 32)
    np.testing.assert_array_equal(X_r, jX_r)
    np.testing.assert_array_equal(evr, jevr)
    for cut, crit in ((4, "maxclust"), (5.0, "distance")):
        labels = perform_clustering(X, clustering_cutoff=cut, cutoff_criterion=crit)
        np.testing.assert_array_equal(
            labels, jclust.perform_clustering(X, clustering_cutoff=cut, cutoff_criterion=crit))
    labels = perform_clustering(torch.as_tensor(X), 4, "maxclust")
    assert len(np.unique(labels)) == 4
    for i in range(4):
        assert len(np.unique(labels[i * 30:(i + 1) * 30])) == 1
    bad = X.copy()
    bad[3, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        pca_whiten(bad)


def test_select_representatives_identical_to_jax():
    rng = np.random.default_rng(7)
    labels = rng.integers(1, 6, 40)
    metric = rng.normal(size=40)
    for m in ("force_std", "energy", "gmm"):
        np.testing.assert_array_equal(select_representatives(labels, metric, m),
                                      jclust.select_representatives(labels, metric, m))
    np.testing.assert_array_equal(
        select_representatives(torch.as_tensor(labels), torch.as_tensor(metric), "energy"),
        jclust.select_representatives(labels, metric, "energy"))
    np.testing.assert_array_equal(
        select_representatives(labels, metric, "random", rng=np.random.default_rng(0)),
        jclust.select_representatives(labels, metric, "random", rng=np.random.default_rng(0)))
    assert select_representatives([1, 1, 2, 2, 3], [0.1, 0.9, 0.5, 0.2, 0.7]).tolist() == [1, 2, 4]


def test_cluster_centers_identical_to_jax():
    rng = np.random.default_rng(8)
    pts = np.concatenate([c + 0.3 * rng.normal(size=(6, 2))
                          for c in ([0, 0], [5, 5], [10, 0], [0, 9])])
    centers, labels = get_cluster_centers(pts, 4)
    jcenters, jlabels = jclust.get_cluster_centers(pts, 4)
    np.testing.assert_array_equal(centers, jcenters)
    np.testing.assert_array_equal(labels, jlabels)
    idx = find_closest_points_indices(pts, centers, labels)
    np.testing.assert_array_equal(idx, jclust.find_closest_points_indices(pts, jcenters, jlabels))
    assert len(np.unique(idx)) == 4


def test_select_data_and_save_matches_jax(tmp_path):
    from surface_sampling_tpu.structure import Structure as JStructure
    from surface_sampling_tpu.structure.io import load_structures_npz as j_load
    from surface_sampling_tpu_torch.structure import Structure

    rng = np.random.default_rng(9)
    sts = [Structure(rng.integers(1, 30, 3), rng.normal(size=(3, 3)), np.eye(3) * 5)
           for _ in range(8)]
    jsts = [JStructure(s.numbers, s.positions, s.cell) for s in sts]
    labels = np.array([1, 1, 2, 2, 2, 3, 3, 1])
    metric = rng.normal(size=8)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    idx = jclust.select_data_and_save(jsts, labels, metric, "energy", tmp_path / "j")
    np.testing.assert_array_equal(
        idx, select_data_and_save(sts, labels, metric, "energy", tmp_path / "p"))
    a, ea = j_load(tmp_path / "p" / "clustered.npz")
    b, eb = j_load(tmp_path / "j" / "clustered.npz")
    np.testing.assert_array_equal(ea, eb)
    for s, t in zip(a, b):
        np.testing.assert_array_equal(s.positions, t.positions)
        np.testing.assert_array_equal(s.numbers, t.numbers)
    # representatives of different sizes (a semigrand run): the JAX writer
    # refuses them, the port writes its ragged layout
    ragged = [Structure(rng.integers(1, 30, n), rng.normal(size=(n, 3)), np.eye(3) * 5)
              for n in (3, 4, 3, 5, 4, 3, 6, 3)]
    with pytest.raises(ValueError):
        jclust.select_data_and_save([JStructure(s.numbers, s.positions, s.cell)
                                     for s in ragged], labels, metric, "energy", tmp_path / "j")
    idx = select_data_and_save(ragged, labels, metric, "energy", tmp_path / "p", "r_")
    from surface_sampling_tpu_torch.structure.io import load_structures_npz

    back, e = load_structures_npz(tmp_path / "p" / "r_clustered.npz")
    assert [len(st) for st in back] == [len(ragged[i]) for i in idx]
    np.testing.assert_array_equal(e, metric[idx])
