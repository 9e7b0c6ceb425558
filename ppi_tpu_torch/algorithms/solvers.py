"""The PPI solver zoo: CEM, iCEM, REPS, MORE, MPPI(+cov), AIS, LBPS, ESSPS.

Port of ``ppi_tpu/algorithms/solvers.py``. Every ``update`` maps
(family, policy state, batch) to (policy state, stats) on the device; the
temperature searches are the grid zooms of ``ops/scalar_opt.py`` and
indices are taken with ``index_select``, so no update waits for the card.

Weight conventions (as the JAX package's):
  * elite methods use log-weights 0 for elites, -1e12 otherwise;
  * temperature methods use log w = -alpha * normalized costs;
  * invalid (NaN-cost) lanes additionally get -inf (see algorithms.base).
"""

import dataclasses
import math
from typing import Tuple

import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.algorithms.base import (
    Batch, masked_max, masked_min, minmax_normalize)
from ppi_tpu_torch.ops.scalar_opt import (
    ALPHA_LOWER, ALPHA_UPPER, grid_zoom_min, grid_zoom_root_decreasing,
    minimize_newton)

ELITE_NEG = -1e12


def _log_weight_diagnostics(log_w):
    log_nw = ops.normalize_log_weights(log_w)
    return ops.effective_sample_size(log_nw), ops.weight_entropy(log_nw)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _snis_log_w(alpha, costs_n, log_valid):
    """(n_candidates, N) log-weights of the candidate temperatures."""
    return -alpha[:, None] * costs_n[None, :] + log_valid


@dataclasses.dataclass(frozen=True)
class SolverBase:
    """Default no-op reset; subclasses override update()."""

    def reset(self, family, state):
        return state

    def update(self, family, state, batch: Batch) -> Tuple:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Cem(SolverBase):
    """Cross-entropy method: uniform weight on the top-k elite samples."""

    n_elites: int = 10

    name = "CEM"

    def reset(self, family, state):
        return family.reset_covariance(state)

    def _elite_log_weights(self, batch: Batch):
        screened = torch.where(batch.valid, batch.costs, torch.inf)
        _, elite_idx = torch.topk(-screened, self.n_elites)
        log_w = torch.full_like(batch.costs, ELITE_NEG).index_fill(
            0, elite_idx, 0.0)
        return log_w + batch.log_valid, elite_idx

    def _elite_update(self, family, state, batch: Batch):
        log_w, elite_idx = self._elite_log_weights(batch)
        state, ess, kl = family.weighted_update(state, log_w, batch.params)
        best = torch.index_select(batch.params, 0, elite_idx[:1])[0]
        state = family.set_map_sequence(state, best)
        _, weight_ent = _log_weight_diagnostics(log_w)
        stats = {"ess": ess, "kl": kl, "weight_ent": weight_ent,
                 "alpha": _scalar(0.0, ess)}
        return state, stats, elite_idx

    def update(self, family, state, batch: Batch):
        state, stats, _ = self._elite_update(family, state, batch)
        return state, stats


@dataclasses.dataclass(frozen=True)
class ICem(Cem):
    """iCEM: CEM plus elite reuse -- the top ``sample_reuse_pc * n_elites``
    samples are stored as particles and injected into the next batch's
    base draws."""

    sample_reuse_pc: float = 0.33

    name = "iCEM"

    @property
    def n_reuse(self) -> int:
        return int(self.sample_reuse_pc * self.n_elites)

    def update(self, family, state, batch: Batch):
        state, stats, elite_idx = self._elite_update(family, state, batch)
        if self.n_reuse > 0:
            state = family.set_particles(
                state, torch.index_select(batch.params, 0,
                                          elite_idx[:self.n_reuse]),
                self.n_reuse)
        return state, stats


@dataclasses.dataclass(frozen=True)
class Reps(SolverBase):
    """Relative entropy policy search: the temperature minimizes the
    KL-bounded dual g(a) = eps/a + log(mean e^{-a c}) / a."""

    epsilon: float = 1.0

    name = "REPS"

    def update(self, family, state, batch: Batch):
        costs_n = minmax_normalize(batch.costs, batch.valid)
        log_n_valid = torch.log(torch.sum(batch.valid).to(torch.float32))

        def dual(alpha):
            log_w = _snis_log_w(alpha, costs_n, batch.log_valid)
            log_mean_w = torch.logsumexp(log_w, dim=1) - log_n_valid
            return self.epsilon / alpha + log_mean_w / alpha

        alpha = grid_zoom_min(dual, ALPHA_LOWER, ALPHA_UPPER,
                              device=costs_n.device)
        log_w = -alpha * costs_n + batch.log_valid
        state, ess, kl = family.weighted_update(state, log_w, batch.params)
        return state, {"ess": ess, "kl": kl, "alpha": alpha}


@dataclasses.dataclass(frozen=True)
class MppiBase(SolverBase):
    """Model-predictive path integral: a fixed inverse temperature on
    min-shifted costs."""

    alpha: float = 10.0

    update_covariance = False
    name = "MPPI"

    def update(self, family, state, batch: Batch):
        shifted = batch.costs - masked_min(batch.costs, batch.valid)
        log_w = -self.alpha * shifted + batch.log_valid
        state, ess, kl = family.weighted_update(
            state, log_w, batch.params,
            update_covariance=self.update_covariance)
        return state, {"ess": ess, "kl": kl,
                       "alpha": _scalar(self.alpha, ess)}


@dataclasses.dataclass(frozen=True)
class Mppi(MppiBase):
    update_covariance = False


@dataclasses.dataclass(frozen=True)
class MppiUpdateCovariance(MppiBase):
    update_covariance = True
    name = "MPPI-cov"


@dataclasses.dataclass(frozen=True)
class Ais(SolverBase):
    """Adaptive importance sampling: a fixed temperature on min-max
    normalized costs."""

    alpha: float = 10.0

    name = "AIS"

    def update(self, family, state, batch: Batch):
        costs_n = minmax_normalize(batch.costs, batch.valid)
        log_w = -self.alpha * costs_n + batch.log_valid
        state, ess, kl = family.weighted_update(state, log_w, batch.params)
        return state, {"ess": ess, "kl": kl,
                       "alpha": _scalar(self.alpha, ess)}


@dataclasses.dataclass(frozen=True)
class Lbps(SolverBase):
    """Lower-bound policy search ("SNISLB"): pick the temperature minimizing
    the SNIS concentration bound E_w[c] + lambda / sqrt(ESS) with
    lambda = sqrt((1-delta)/delta)."""

    delta: float = 0.9

    name = "SNISLB"

    def update(self, family, state, batch: Batch):
        costs_n = minmax_normalize(batch.costs, batch.valid)
        lam = math.sqrt((1.0 - self.delta) / self.delta)

        def lower_bound(alpha):  # (n_candidates,) -> (n_candidates,)
            log_w = _snis_log_w(alpha, costs_n, batch.log_valid)
            log_nw = log_w - torch.logsumexp(log_w, dim=1, keepdim=True)
            nw = torch.exp(log_nw)
            ess = torch.exp(-torch.logsumexp(2.0 * log_nw, dim=1))
            expected_cost = torch.sum(nw * costs_n[None, :], dim=1)
            return expected_cost + lam / torch.sqrt(ess)

        alpha = grid_zoom_min(lower_bound, ALPHA_LOWER, ALPHA_UPPER,
                              device=costs_n.device)
        log_w = -alpha * costs_n + batch.log_valid
        state, ess, kl = family.weighted_update(state, log_w, batch.params)
        return state, {"ess": ess, "kl": kl, "alpha": alpha}


@dataclasses.dataclass(frozen=True)
class Essps(SolverBase):
    """Effective-sample-size policy search: the temperature whose SNIS ESS
    matches a target elite count (a monotone root find)."""

    n_elites: int = 10

    name = "ESSPS"

    def update(self, family, state, batch: Batch):
        costs_n = minmax_normalize(batch.costs, batch.valid)

        def ess_of(alpha):
            log_w = _snis_log_w(alpha, costs_n, batch.log_valid)
            log_nw = log_w - torch.logsumexp(log_w, dim=1, keepdim=True)
            return torch.exp(-torch.logsumexp(2.0 * log_nw, dim=1))

        alpha = grid_zoom_root_decreasing(
            ess_of, float(self.n_elites), ALPHA_LOWER, ALPHA_UPPER,
            device=costs_n.device)
        log_w = -alpha * costs_n + batch.log_valid
        state, ess, kl = family.weighted_update(state, log_w, batch.params)
        _, weight_ent = _log_weight_diagnostics(log_w)
        return state, {"ess": ess, "kl": kl, "alpha": alpha,
                       "weight_ent": weight_ent}


# ---- MORE ----------------------------------------------------------------------

def _quadratic_features(w: torch.Tensor):
    """[1, x, upper-triangle(x x^T)] feature map (PolynomialFeatures(2))."""
    n, d = w.shape
    iu, ju = torch.triu_indices(d, d, device=w.device)
    quad = w[:, iu] * w[:, ju]
    return torch.cat([torch.ones((n, 1), dtype=w.dtype, device=w.device), w,
                      quad], dim=1), (iu, ju)


@dataclasses.dataclass(frozen=True)
class More(SolverBase):
    """Model-based relative entropy stochastic search.

    Fits a quadratic reward surrogate by closed-form ridge regression,
    solves the 2-parameter (eta, omega) dual of the KL- and
    entropy-constrained Gaussian update by damped Newton, and applies a
    PD-guarded interpolated update: of the candidates t = 1, 0.5, 0.25 the
    first PD one with KL <= epsilon, else the previous policy (the JAX
    package's reading of the reference's guard)."""

    epsilon: float = 0.1
    base_entropy: float = -100.0
    entropy_rate: float = 0.99
    dimension: int = 2
    ridge_coeff: float = 1e-5

    name = "MORE"

    def _fit_quadratic(self, w, rewards, valid):
        d = self.dimension
        feats, (iu, ju) = _quadratic_features(w)
        vf = valid.to(w.dtype)
        fmask = feats * vf[:, None]
        gram = fmask.T @ fmask + self.ridge_coeff * torch.eye(
            feats.shape[1], dtype=w.dtype, device=w.device)
        coef = torch.linalg.solve_ex(gram, fmask.T @ (rewards * vf))[0]
        r0, r_lin, c_quad = coef[0], coef[1:1 + d], coef[1 + d:]
        r_mat = torch.zeros((d, d), dtype=w.dtype, device=w.device)
        r_mat = r_mat.index_put((iu, ju), c_quad)
        # symmetric; halves the off-diagonals, keeps the diagonal
        r_mat = 0.5 * (r_mat + r_mat.T)
        pred = torch.einsum("bi,ij,bj->b", w, r_mat, w) + w @ r_lin + r0
        resid = torch.where(valid, rewards - pred, 0.0)
        rmse = torch.sqrt(torch.sum(resid ** 2)
                          / torch.clamp(torch.sum(valid), min=1))
        return r0, r_lin, r_mat, rmse

    def update(self, family, state, batch: Batch):
        d = self.dimension
        w = batch.params
        rewards = -batch.costs
        rewards = rewards - masked_max(rewards, batch.valid)
        rewards = rewards / (masked_max(torch.abs(rewards), batch.valid)
                             + torch.finfo(rewards.dtype).tiny)
        rewards = rewards * 100.0
        # invalid lanes carry NaN/inf through the arithmetic above; zero
        # them so the masked ridge fit stays NaN-free (NaN * 0 is NaN)
        rewards = torch.where(batch.valid, rewards, 0.0)

        r0, r_lin, r_mat, rmse = self._fit_quadratic(w, rewards, batch.valid)
        # strictly negative-definite projection of the curvature
        evals, evecs = torch.linalg.eigh(r_mat)
        evals = torch.clamp(evals, max=-1e-9)
        r_nd = (evecs * evals[None, :]) @ evecs.T

        q_cov, b_mean, q_chol = state.sigma, state.mu, state.chol
        eye = torch.eye(d, dtype=q_cov.dtype, device=q_cov.device)
        q_inv = torch.cholesky_solve(eye, q_chol)
        q_inv_b = torch.cholesky_solve(b_mean[:, None], q_chol)[:, 0]
        ent_n = ops.multivariate_gaussian_entropy(q_cov, d)
        beta = (self.entropy_rate * (ent_n - self.base_entropy)
                + self.base_entropy)
        logdet_q = 2.0 * torch.sum(torch.log(torch.diagonal(q_chol)))
        ent_q = d * math.log(2.0 * math.pi) + logdet_q
        b_q_b = b_mean @ q_inv_b

        def dual(x):
            eta, omega = torch.exp(x[0]), torch.exp(x[1])
            f_cov = torch.linalg.inv(eta * q_inv - 2.0 * r_nd)
            f_vec = eta * q_inv_b + r_lin
            f_f_f = f_vec @ f_cov @ f_vec
            eta_omega = eta + omega
            ld = torch.linalg.slogdet(2.0 * math.pi * eta_omega * f_cov)[1]
            return (self.epsilon * eta - beta * omega
                    + 0.5 * (f_f_f - b_q_b * eta - eta * ent_q
                             + ld * eta_omega))

        x, _ = minimize_newton(dual, torch.zeros(2, device=w.device),
                               iters=30)
        x = torch.clamp(x, math.log(ALPHA_LOWER), math.log(ALPHA_UPPER))
        eta, omega = torch.exp(x[0]), torch.exp(x[1])

        f_cov = torch.linalg.inv(eta * q_inv - 2.0 * r_nd)
        mu_f = f_cov @ (eta * q_inv_b + r_lin)
        sigma_f = ops.symmetric((eta + omega) * f_cov)

        # PD-guarded interpolated update over three candidates
        sigma_f_inv = torch.linalg.inv(sigma_f)
        g_mat = q_inv - sigma_f_inv
        m_mat = g_mat @ q_cov @ g_mat
        nu, nu_f = q_inv @ b_mean, sigma_f_inv @ mu_f
        mus, sigmas, kls, oks = [], [], [], []
        for t in (1.0, 0.5, 0.25):
            prec_t = (1 - t) * q_inv + t * sigma_f_inv + 0.5 * t * t * m_mat
            sigma_t = torch.linalg.inv(ops.symmetric(prec_t))
            mu_t = sigma_t @ ((1 - t) * nu + t * nu_f)
            _, pd = ops.safe_cholesky(ops.symmetric(sigma_t), jitter=0.0)
            kl_t = ops.multivariate_gaussian_kl(mu_t, sigma_t, b_mean, q_cov)
            mus.append(mu_t)
            sigmas.append(sigma_t)
            kls.append(kl_t)
            oks.append(pd & (kl_t <= self.epsilon)
                       & torch.all(torch.isfinite(mu_t)))
        oks = torch.stack(oks)
        first = torch.argmax(oks.to(torch.int32)).reshape(1)  # first True
        any_ok = torch.any(oks)
        pick = lambda xs: torch.index_select(torch.stack(xs), 0, first)[0]
        mu_sel = torch.where(any_ok, pick(mus), b_mean)
        sigma_sel = torch.where(any_ok, pick(sigmas), q_cov)
        kl = torch.where(any_ok, pick(kls), 0.0)
        state = family.smooth_update(state, mu_sel, sigma_sel, 1.0)

        log_w = rewards / eta + batch.log_valid
        ess, _ = _log_weight_diagnostics(log_w)
        ent = ops.multivariate_gaussian_entropy(sigma_sel, d)
        stats = {"alpha": 1.0 / eta, "omega": omega, "kl": kl, "ent": ent,
                 "ess": ess, "fit": rmse}
        return state, stats
