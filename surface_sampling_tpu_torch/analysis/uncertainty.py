"""Uncertainty quantification for active-learning structure selection.

The counterpart of ``surface_sampling_tpu/analysis/uncertainty.py`` (a
re-design of mcmc/uncertainty/uncertainty.py): ensemble-variance and
GMM-NLL uncertainties with conformal-prediction calibration. Scoring is
plain torch on the device of its input; the GMM fit is :func:`fit_gmm_em`,
a chunked float64 EM in torch on the data's device (the card unless the
caller asks for the CPU). sklearn's ``GaussianMixture`` is taken only when the
caller asks for it (``fit_gmm(method="sklearn")``); the fitted parameters
are sklearn's (means, cholesky precisions, weights) either way, so that
fitting and scoring stay interchangeable.
"""

from __future__ import annotations

import math
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch

from surface_sampling_tpu_torch.analysis.clustering import _host
from surface_sampling_tpu_torch.device import resolve_device

ORDERS = (
    "atomic",
    "system_sum",
    "system_mean",
    "system_max",
    "system_min",
    "system_mean_squared",
    "system_root_mean_squared",
)


def reduce_order(values, order: str, axis=-1):
    """Per-system reduction of per-atom values (uncertainty.py orders), for
    numpy arrays and tensors alike."""
    is_t = isinstance(values, torch.Tensor)
    if order == "atomic":
        return values
    if order == "system_sum":
        return values.sum(axis)
    if order == "system_mean":
        return values.mean(axis)
    if order == "system_max":
        return values.amax(axis) if is_t else values.max(axis)
    if order == "system_min":
        return values.amin(axis) if is_t else values.min(axis)
    if order == "system_mean_squared":
        return (values**2).mean(axis)
    if order == "system_root_mean_squared":
        ms = (values**2).mean(axis)
        return torch.sqrt(ms) if is_t else np.sqrt(ms)
    raise ValueError(f"unknown order {order!r}")


@dataclass
class ConformalPrediction:
    """Quantile calibration of a heuristic uncertainty (amptorch scheme,
    uncertainty.py:113-141): qhat = Q_{ceil((n+1)(1-a))/n}(|res|/unc)."""

    alpha: float = 0.05
    qhat: float | None = None

    def fit(self, residuals, heuristic_uncertainty) -> None:
        scores = np.abs(_host(residuals) / _host(heuristic_uncertainty))
        n = len(scores)
        q = min(np.ceil((n + 1) * (1 - self.alpha)) / n, 1.0)
        self.qhat = float(np.quantile(scores, q, method="linear"))

    def predict(self, heuristic_uncertainty):
        if self.qhat is None:
            raise RuntimeError("ConformalPrediction not fitted")
        return heuristic_uncertainty * self.qhat, self.qhat


@dataclass
class Uncertainty:
    """Base: order reduction + optional min-uncertainty shift + CP scaling."""

    order: str = "atomic"
    calibrate: bool = False
    cp_alpha: float = 0.05
    min_uncertainty: float | None = None
    cp: ConformalPrediction = field(default=None)

    def __post_init__(self):
        assert self.order in ORDERS, f"{self.order} not implemented"
        if self.calibrate and self.cp is None:
            self.cp = ConformalPrediction(alpha=self.cp_alpha)

    def scale_to_min_uncertainty(self, u):
        if self.min_uncertainty is not None:
            shift = (
                self.min_uncertainty**2
                if self.order == "system_mean_squared"
                else self.min_uncertainty
            )
            u = u - shift
        return u

    def fit_conformal_prediction(self, residuals, heuristic_uncertainty) -> None:
        self.cp.fit(residuals, heuristic_uncertainty)

    def calibrate_uncertainty(self, u):
        out, _ = self.cp.predict(u)
        return out

    def finalize(self, u):
        u = self.scale_to_min_uncertainty(u)
        if self.calibrate and self.cp is not None and self.cp.qhat is not None:
            u = self.calibrate_uncertainty(u)
        return u

    def __call__(self, *a, **kw):
        return self.get_uncertainty(*a, **kw)

    # persistence (uncertainty.py:90-110)
    def save(self, path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path) -> "Uncertainty":
        with open(path, "rb") as f:
            return pickle.load(f)


@dataclass
class EnsembleUncertainty(Uncertainty):
    """Std/variance across NN-ensemble members (uncertainty.py:144-235), in
    torch on the input's device.

    quantity: 'energy' (population std of member energies) or 'forces'
    (per-atom norm of the member force std, e.g.
    ``models.ensemble.ensemble_forces_std``, reduced by ``order``).
    """

    quantity: str = "forces"

    def get_uncertainty(self, member_energy=None, forces_std=None):
        if self.quantity == "energy":
            u = torch.as_tensor(member_energy).std(unbiased=False)
        else:
            u = torch.linalg.norm(torch.as_tensor(forces_std), dim=-1)   # (..., N)
            u = reduce_order(u, self.order)
        return self.finalize(u)


@dataclass
class GMMUncertainty(Uncertainty):
    """Negative log-likelihood under a GMM fit on training embeddings
    (uncertainty.py:238-456 + the vendored gmm.py). Fit by :func:`fit_gmm_em`
    (or sklearn on request); scored in torch on the embeddings' device from
    (means, cholesky precisions, weights)."""

    n_components: int = 8
    covariance_type: str = "full"
    gmm_params: dict | None = None

    def fit_gmm(self, train_embeddings, random_state: int = 0, method: str = "em",
                **em_kwargs) -> None:
        """Fit the mixture. ``method="em"`` (the default): the chunked torch
        EM :func:`fit_gmm_em` on the data's device (a tensor's own, else
        ``em_kwargs["device"]``, the card by default). ``method="sklearn"``:
        sklearn's ``GaussianMixture`` on the host, which must be installed."""
        if method == "em":
            self.gmm_params = fit_gmm_em(train_embeddings, self.n_components,
                                         seed=random_state, **em_kwargs)
            return
        if method != "sklearn":
            raise ValueError(f"unknown GMM fit method {method!r}; use 'em' or 'sklearn'")
        try:
            from sklearn.mixture import GaussianMixture
        except ImportError as e:
            raise ImportError("fit_gmm(method='sklearn') needs scikit-learn, which is not "
                              "installed; fit with method='em' instead") from e
        gm = GaussianMixture(
            n_components=self.n_components,
            covariance_type=self.covariance_type,
            random_state=random_state,
        ).fit(_host(train_embeddings))
        self.gmm_params = {
            "means": gm.means_,
            "precisions_cholesky": gm.precisions_cholesky_,
            "weights": gm.weights_,
        }

    def log_prob(self, x):
        """(B,) GMM log-likelihood of x (B, D) in f32 on x's device."""
        x = torch.atleast_2d(torch.as_tensor(x))
        resolve_device(x.device)
        x = x.to(torch.float32)
        p = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=x.device)
             for k, v in self.gmm_params.items()
             if k in ("means", "precisions_cholesky", "weights")}
        return _log_prob(x, p["means"], p["precisions_cholesky"], torch.log(p["weights"]))

    def get_uncertainty(self, embeddings):
        """embeddings: (N_atoms, D) per-atom (or (B, D) per-structure)."""
        if self.gmm_params is None:
            raise RuntimeError("GMMUncertainty: call fit_gmm first")
        nll = -self.log_prob(embeddings)
        u = reduce_order(nll, self.order) if self.order != "atomic" else nll
        return self.finalize(u)

    def _n_parameters(self, d: int) -> int:
        """Free parameters of a full-covariance GMM (gmm.py bic/aic)."""
        cov = self.n_components * d * (d + 1) // 2
        return int(cov + self.n_components * d + self.n_components - 1)

    def _mean_log_prob(self, x) -> tuple[float, int, int]:
        x = torch.atleast_2d(torch.as_tensor(x))
        return float(self.log_prob(x).mean()), x.shape[0], x.shape[1]

    def bic(self, x) -> float:
        """Bayesian information criterion (vendored gmm.py:739 analog)."""
        ll, n, d = self._mean_log_prob(x)
        return -2.0 * ll * n + self._n_parameters(d) * np.log(n)

    def aic(self, x) -> float:
        """Akaike information criterion (vendored gmm.py:755 analog)."""
        ll, n, d = self._mean_log_prob(x)
        return -2.0 * ll * n + 2.0 * self._n_parameters(d)


def _log_prob_components(x, mu, prec_chol, logw):
    """(B, C) per-component log densities plus log weights: y = (x - mu) @
    prec_chol per component, the Mahalanobis term, the diagonal
    log-determinant."""
    d = x.shape[-1]
    y = torch.einsum("bd,cde->bce", x, prec_chol) - torch.einsum(
        "cd,cde->ce", mu, prec_chol)[None]
    maha = (y * y).sum(-1)
    logdet = torch.log(torch.diagonal(prec_chol, dim1=-2, dim2=-1).abs()).sum(-1)
    return -0.5 * (d * math.log(2 * math.pi) + maha) + logdet[None] + logw[None]


def _log_prob(x, mu, prec_chol, logw):
    return torch.logsumexp(_log_prob_components(x, mu, prec_chol, logw), dim=-1)


def _prec_chol_of(cov):
    """sklearn's parameterization: solve L y = I with L = chol(cov);
    precisions_cholesky = y^T (upper triangular)."""
    L = torch.linalg.cholesky(cov)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device).expand_as(cov)
    return torch.linalg.solve_triangular(L, eye, upper=False).transpose(-1, -2)


def fit_gmm_em(x, n_components: int, n_iter: int = 60, chunk: int = 4096,
               reg_covar: float = 1e-6, seed: int = 0, tol: float = 1e-4,
               device: str | torch.device | None = None, return_info: bool = False):
    """Full-covariance GMM EM with CHUNKED sufficient statistics, on the
    data's device.

    The counterpart of the JAX package's ``fit_gmm_em`` (the stand-in for
    the reference's vendored huge-matrix GaussianMixture, gmm.py:27-60,
    427-781), step for step: the data centred on the host, farthest-point
    initial means drawn from ``np.random.default_rng(seed)`` (JAX's draws),
    a shared diagonal initial covariance and uniform weights; rows padded to
    a chunk multiple with weight-0 rows; per iteration one pass over the
    chunks (E-step responsibilities from the current cholesky precisions,
    M-step sufficient statistics (Nk, r^T X, per-component weighted scatter)
    summed over the chunks in a fixed order), and an early stop when the
    mean log-likelihood changes by less than ``tol``. Peak memory is
    O(chunk * C * D + C * D^2) whatever N: the scatter is one batched
    product over the components, no (chunk, C, D, D) temporary.

    One choice differs from JAX's: the pass runs in float64, where JAX's
    runs in float32. At D = 128 with ``reg_covar`` 1e-6 a component's
    covariance has a condition number near 1/eps of float32: per-atom
    embeddings gather in tight, far-apart clusters (one per species and
    site, many rows repeated), where the f32 scatter E[xx^T] - mu mu^T
    and the Cholesky lose positive definiteness. JAX's Cholesky then
    returns NaN, and so does its whole fit. (An H100's float64 peak is
    its float32 peak without TF32, 67 TFLOP/s on the data sheet.)

    ``x`` is (N, D), numpy or a tensor; a tensor runs on its own device,
    numpy on ``device`` (the card by default, through
    ``device.resolve_device``). Returns {means, precisions_cholesky,
    weights} as float64 numpy arrays in sklearn's parameterization, with
    ``return_info`` also {"n_iter", "mean_log_likelihood"} (the last
    iteration's, of the parameters it started from).
    """
    if isinstance(x, torch.Tensor):
        dev = resolve_device(x.device)
    else:
        dev = resolve_device("cuda" if device is None else device)
    x = _host(x).astype(np.float64)
    # centre first: E[xx^T] - mu mu^T cancels when embedding magnitudes
    # dwarf their spread; covariances are translation-invariant, and the
    # offset is added back to the returned means
    x_center = x.mean(axis=0)
    x = x - x_center
    n, d = x.shape
    c = n_components
    rng = np.random.default_rng(seed)

    # init: farthest-point means (each row's least squared distance to the
    # means so far, kept as a running minimum: JAX's values and draws),
    # shared diagonal covariance
    means = [x[rng.integers(n)]]
    d2 = np.full(n, np.inf)
    for _ in range(c - 1):
        d2 = np.minimum(d2, np.sum((x - means[-1]) ** 2, axis=1))
        p = d2 / max(d2.sum(), 1e-300)
        means.append(x[rng.choice(n, p=p)])
    mu0 = np.stack(means)                                   # (C, D)
    var0 = np.maximum(x.var(axis=0), reg_covar)             # (D,)
    cov0 = np.broadcast_to(np.diag(var0), (c, d, d)).copy()

    # pad rows to a chunk multiple; dummy rows carry weight 0
    n_pad = (-n) % chunk
    xp = np.concatenate([x, np.zeros((n_pad, d))]) if n_pad else x
    row_w = np.concatenate([np.ones(n), np.zeros(n_pad)]) if n_pad else np.ones(n)
    f64 = dict(dtype=torch.float64, device=dev)
    xc = torch.as_tensor(xp.reshape(-1, chunk, d), **f64)  # (S, chunk, D)
    wc = torch.as_tensor(row_w.reshape(-1, chunk), **f64)  # (S, chunk)
    eye = torch.eye(d, **f64)

    def em_step(mu, cov, w):
        pch = _prec_chol_of(cov)
        logw = torch.log(w)
        nk = torch.zeros(c, **f64)
        sx = torch.zeros((c, d), **f64)
        sxx = torch.zeros((c, d, d), **f64)
        ll = torch.zeros((), **f64)
        for xb, wb in zip(xc, wc):                          # fixed order
            lp = _log_prob_components(xb, mu, pch, logw)    # (chunk, C)
            ll_rows = torch.logsumexp(lp, dim=-1)
            r = torch.exp(lp - ll_rows[:, None]) * wb[:, None]
            nk = nk + r.sum(0)
            sx = sx + r.T @ xb
            # sum_b r_bc x_bd x_be as one product batched over components
            sxx = sxx + (r.T[:, :, None] * xb[None]).transpose(1, 2) @ xb
            ll = ll + (ll_rows * wb).sum()
        nk = nk.clamp_min(1e-10)
        mu_new = sx / nk[:, None]
        cov_new = sxx / nk[:, None, None] - mu_new[:, :, None] * mu_new[:, None, :]
        cov_new = cov_new + reg_covar * eye[None]
        return mu_new, cov_new, nk / nk.sum(), ll / n

    mu = torch.as_tensor(mu0, **f64)
    cov = torch.as_tensor(cov0, **f64)
    w = torch.full((c,), 1.0 / c, **f64)
    prev_ll, it = -np.inf, 0
    for it in range(1, n_iter + 1):
        mu, cov, w, ll = em_step(mu, cov, w)
        ll = float(ll)
        if abs(ll - prev_ll) < tol:
            break
        prev_ll = ll
    params = {
        "means": mu.cpu().numpy() + x_center,
        "precisions_cholesky": _prec_chol_of(cov).cpu().numpy(),
        "weights": w.cpu().numpy(),
    }
    if return_info:
        return params, {"n_iter": it, "mean_log_likelihood": ll}
    return params


UNC_DICT = {"ensemble": EnsembleUncertainty, "gmm": GMMUncertainty}


def get_unc_class(name: str, **kwargs) -> Uncertainty:
    """Factory mirroring uncertainty.py:458-532."""
    return UNC_DICT[name](**kwargs)
