"""Function-space (GP kernel) trajectory priors.

Port of ``ppi_tpu/policies/kernels.py``: squared-exponential, Matern
1/2, 3/2 and 5/2, periodic, white-noise and the linear-Gaussian dynamical
system (integrator chain) kernel. The prior over an action sequence is a
GP on the H planning timesteps, so U = K(t, t) is (H, H); the
receding-horizon shift conditions through the cached prior Cholesky with
triangular solves. The LGDS Gram is closed form: one masked (H, H) product
of the chain's impulse responses. The hyperparameters live in the state
(``hyper``), so their marginal-likelihood fit (``optimize_hyper``, a fixed
Adam loop on ``hyper_nll`` within ``param_bounds``) differentiates through
the Gram with ``torch.autograd``.
"""

import dataclasses
import math

import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.policies.design import clip_actions
from ppi_tpu_torch.policies.primitives import (
    MatrixNormalState, MatrixPolicyBase, init_particle_buffer)


@dataclasses.dataclass(frozen=True)
class KernelState(MatrixNormalState):
    hyper: torch.Tensor = None       # (sigma[, lengthscale[, period]])
    cov_prior: torch.Tensor = None   # K(t, t) prior on the current window
    chol_prior: torch.Tensor = None


def k_squared_exponential(hyper, t1, t2):
    """sigma * exp(-0.5 ((t1 - t2) / ls)^2), plus 1e-3 sigma I whenever the
    two time vectors have the same length -- the cross-covariance between
    two equal-length windows included, as in the reference."""
    sigma, ls = hyper[0], hyper[1]
    d = (t1[:, None] - t2[None, :]) / ls
    k = sigma * torch.exp(-0.5 * d * d)
    if t1.shape[0] == t2.shape[0]:
        k = k + 1e-3 * sigma * torch.eye(t1.shape[0], device=t1.device)
    return k


SQRT3, SQRT5 = math.sqrt(3.0), math.sqrt(5.0)


def _abs_diff_safe(t1, t2, eps):
    ad = torch.abs(t1[:, None] - t2[None, :])
    return torch.where(ad == 0.0, eps, ad)


def k_matern12(hyper, t1, t2, eps=1e-8):
    sigma, ls = hyper[0], hyper[1]
    return sigma * torch.exp(-_abs_diff_safe(t1, t2, eps) / ls)


def k_matern32(hyper, t1, t2, eps=1e-8):
    sigma, ls = hyper[0], hyper[1]
    d = SQRT3 * _abs_diff_safe(t1, t2, eps) / ls
    return sigma * (1.0 + d) * torch.exp(-d)


def k_matern52(hyper, t1, t2, eps=1e-8):
    sigma, ls = hyper[0], hyper[1]
    d = SQRT5 * _abs_diff_safe(t1, t2, eps) / ls
    return sigma * (1.0 + d + d * d / 3.0) * torch.exp(-d)


def k_periodic(hyper, t1, t2, eps=1e-8):
    sigma, ls, period = hyper[0], hyper[1], hyper[2]
    ad = _abs_diff_safe(t1, t2, eps)
    s = torch.sin(math.pi * ad / period)
    k = sigma * torch.exp(-2.0 * s * s / ls)
    if t1.shape[0] == t2.shape[0]:
        k = k + 1e-3 * sigma * torch.eye(t1.shape[0], device=t1.device)
    return k


def k_white(hyper, t1, t2):
    """sigma where the two times are equal, bit for bit, else 0."""
    return hyper[0] * time_remap_matrix(t1, t2)


def lgds_phi(order: int, j_dt):
    """First row of the integrator chain's transition matrix A^j as a
    function of the elapsed time j dt: [1, j dt, (j dt)^2 / 2][:order]. A is
    unipotent, so A^j is the exact flow over j dt."""
    cols = [torch.ones_like(j_dt)]
    if order >= 2:
        cols.append(j_dt)
    if order >= 3:
        cols.append(0.5 * j_dt * j_dt)
    return torch.stack(cols, dim=-1)  # (..., order)


def k_lgds(hyper, t1, t2, order: int = 2, q0_scale: float = 1e-3,
           disturbance: float = 1e-6):
    """Gram matrix of the position component of an integrator-chain GP.

    The chain x_{k+1} = A x_k + w_k with process noise only on the highest
    derivative gives, for the position at steps r, c of a uniform grid,

      K[r, c] = q0 phi(r) . phi(c)                          (initial cov.)
              + sigma sum_{k=1..min(r,c)} g(r - k) g(c - k)   (process noise)
              + disturbance delta_rc

    with phi(j) the first row of A^j and g(j) its last entry. The sum over
    k is a masked outer product of lower-triangular impulse-response
    matrices. Defined on one uniform time grid only (``t1`` is ``t2``)."""
    del t2
    sigma = hyper[0]
    n = t1.shape[0]
    dt = t1[1] - t1[0] if n > 1 else torch.ones((), dtype=t1.dtype,
                                                device=t1.device)
    idx = torch.arange(n, device=t1.device)
    phi = lgds_phi(order, idx.to(t1.dtype) * dt)          # (n, order)
    # g[r, k] = g(r - k) for 1 <= k <= r, else 0: the response at step r to
    # noise injected at step k
    rr, kk = idx[:, None], idx[None, :]
    lag = (rr - kk).to(t1.dtype) * dt
    g = lgds_phi(order, lag)[..., order - 1]
    g = torch.where((rr >= kk) & (kk >= 1), g, 0.0)
    return (q0_scale * (phi @ phi.T) + sigma * (g @ g.T)
            + disturbance * torch.eye(n, dtype=t1.dtype, device=t1.device))


# name -> (Gram function, number of hyperparameters)
KERNELS = {
    "SquaredExponentialKernel": (k_squared_exponential, 2),
    "Matern12Kernel": (k_matern12, 2),
    "Matern32Kernel": (k_matern32, 2),
    "Matern52Kernel": (k_matern52, 2),
    "PeriodicKernel": (k_periodic, 3),
    "WhiteNoiseKernel": (k_white, 1),
}
LGDS = "LinearGaussianDynamicalSystemKernel"


def time_remap_matrix(t_new, t_old):
    """(H, H) 0/1 matrix R with R[i, j] = 1 iff t_new[i] == t_old[j]: the
    index remap of delta-correlated priors on a shifted window."""
    return (torch.abs(t_new[:, None] - t_old[None, :]) == 0.0).to(
        t_new.dtype)


def _cho_solve(chol, b):
    """(L L^T)^-1 b for lower-triangular L."""
    return torch.cholesky_solve(b, chol, upper=False)


@dataclasses.dataclass(frozen=True)
class BaseKernel(MatrixPolicyBase):
    """GP trajectory prior with receding-horizon conditioning."""

    kernel: str = "SquaredExponentialKernel"
    lgds_order: int = 2  # only used by the LGDS family
    shift_eps: float = 1e-5

    name = "BaseKernel"

    def __post_init__(self):
        if self.kernel not in KERNELS and self.kernel != LGDS:
            raise ValueError(f"unknown kernel {self.kernel!r}; expected one "
                             f"of {[*KERNELS, LGDS]}")

    @property
    def param_bounds(self):
        """Box of each hyperparameter for the marginal-likelihood fit."""
        return {
            "SquaredExponentialKernel": ((1e-5, 1e6), (1e-5, 1e3)),
            "PeriodicKernel": ((1e-3, 1e6), (1e-4, 1e3), (1e-3, 1e3)),
            "WhiteNoiseKernel": ((1e-5, 1e6),),
        }.get(self.kernel, ((1e-5, 1e6), (1e-3, 1e3)))

    @property
    def dim_features(self) -> int:
        return self.horizon

    def k(self, state: KernelState, t1, t2):
        if self.kernel == LGDS:
            return k_lgds(state.hyper, t1, t2, order=self.lgds_order)
        return KERNELS[self.kernel][0](state.hyper, t1, t2)

    def _eye(self, like):
        return torch.eye(self.horizon, dtype=like.dtype, device=like.device)

    # ---- construction -----------------------------------------------------

    def init(self, time_sequence, mean, covariance_in, covariance_out,
             lengthscale=1.0, period=1.0, lower=None,
             upper=None) -> KernelState:
        """``covariance_in`` is the scalar kernel variance (shape (1,)). All
        tensors live on ``time_sequence.device``."""
        d_a, h = self.action_dim, self.horizon
        dev = time_sequence.device
        if time_sequence.shape[0] != h:
            raise ValueError(f"time_sequence has {time_sequence.shape[0]} "
                             f"steps; the horizon is {h}")
        if lower is None:
            lower = torch.full((d_a,), -torch.inf, device=dev)
            upper = torch.full((d_a,), torch.inf, device=dev)
        sigma = covariance_in.reshape(())
        n_hyper = 1 if self.kernel == LGDS else KERNELS[self.kernel][1]
        hyper = torch.stack([sigma, torch.full_like(sigma, lengthscale),
                             torch.full_like(sigma, period)][:n_hyper])
        chol_out, _ = ops.safe_cholesky(covariance_out, jitter=0.0)
        particles, n_particles = init_particle_buffer(
            self.max_particles, h, d_a, dev)
        eye = torch.eye(h, device=dev)
        state = KernelState(
            t=time_sequence, mean=torch.zeros((h, d_a), device=dev),
            cov_in=eye, chol_in=eye, cov_out=covariance_out,
            chol_out=chol_out, cov_in_init=eye, mean_fn=mean,
            lower=lower, upper=upper,
            map_sequence=torch.zeros((h, d_a), device=dev),
            particles=particles, n_particles=n_particles,
            hyper=hyper, cov_prior=eye, chol_prior=eye)
        cov = self.k(state, time_sequence, time_sequence)
        chol, _ = ops.safe_cholesky(cov, jitter=0.0)
        return state.replace(cov_in=cov, chol_in=chol, cov_in_init=cov,
                             cov_prior=cov, chol_prior=chol)

    # ---- sampling / update ------------------------------------------------

    def sample(self, state: KernelState, generator, n: int):
        z = self.base_sample(state, generator, n)
        xs = state.mean_fn[None, None, :] + self.transform_base(state, z)
        xs = clip_actions(xs, state.lower, state.upper)
        return xs, xs

    def weighted_update(self, state, log_w, params, update_covariance=True):
        # function-space fit on mean-corrected samples; the MAP sequence is
        # tracked and the mean does NOT revert on PD failure
        state = state.replace(
            map_sequence=ops.select_row(params, log_w)
            - state.mean_fn[None, :])
        corrected = params - state.mean_fn[None, None, :]
        return self.mavn_update(state, log_w, corrected,
                                update_covariance=update_covariance,
                                revert_mean_on_failure=False)

    def predict_mean(self, state: KernelState):
        mu = state.mean_fn[None, :] + state.mean
        return clip_actions(mu, state.lower, state.upper)

    def predict(self, state: KernelState):
        """(mean (H, d_a), sigma_in (H, H), sigma_out (d_a, d_a), std (H,
        d_a))."""
        mu = state.mean_fn[None, :] + state.mean
        std = torch.sqrt(torch.outer(torch.diagonal(state.cov_in),
                                     torch.diagonal(state.cov_out)))
        return mu, state.cov_in, state.cov_out, std

    def map_action_sequence(self, state: KernelState):
        return state.mean_fn[None, :] + state.map_sequence

    # ---- receding horizon -------------------------------------------------

    def compute_prior(self, state: KernelState, t):
        """The prior gram + Cholesky on the planning window."""
        cov_prior = self.k(state, t, t)
        chol_prior, _ = ops.safe_cholesky(cov_prior, jitter=0.0)
        return state.replace(t=t, cov_prior=cov_prior, chol_prior=chol_prior)

    def update_timesteps(self, state: KernelState, t, anneal=1.0, same=None):
        """Shift the GP posterior onto the window ``t``.

        The posterior (mean, cov_in) on the old window maps onto ``t``
        through the prior cross-covariances, its information annealed toward
        the prior. ``same`` says whether ``t`` is the current window (then
        only ``t`` is replaced); the MPC agent decides it from its integer
        time index. ``None`` compares the tensors, which waits for the
        device."""
        if same is None:
            same = torch.equal(t, state.t)
        if same:
            return state.replace(t=t)
        p_chol = state.chol_prior
        solve = lambda b: _cho_solve(p_chol, b)
        # information gained relative to the prior, sandwiched by P^-1
        gain = solve(solve(state.cov_prior - state.cov_in).T).T
        cross = self.k(state, t, state.t)
        mean_new = cross @ solve(state.mean)
        # the prior mean function carries the actuator-range offset: clip in
        # action space, then remove the offset again
        mean_new = clip_actions(mean_new + state.mean_fn[None, :],
                                state.lower, state.upper) - state.mean_fn[None, :]
        sigma = state.hyper[0]
        prior_new = self.k(state, t, t)
        cov_new = (prior_new
                   - anneal * cross @ gain @ cross.T
                   + self.shift_eps * sigma * self._eye(prior_new))
        chol_new, pd_ok = ops.safe_cholesky(cov_new, jitter=0.0)
        # if the shifted covariance lost PD, fall back to the prior
        prior_chol, _ = ops.safe_cholesky(prior_new, jitter=0.0)
        cov_new = torch.where(pd_ok, cov_new, prior_new)
        chol_new = torch.where(pd_ok, chol_new, prior_chol)
        return state.replace(t=t, mean=mean_new, cov_in=cov_new,
                             chol_in=chol_new)

    # ---- conditioning / likelihood ---------------------------------------

    def _conditioned(self, state: KernelState, cov_p, cov_tp, action):
        """The posterior given ``action`` at points with Gram ``cov_p``
        (q, q) and cross-covariance ``cov_tp`` (H, q) to the window."""
        sol = torch.linalg.solve_ex(cov_p, cov_tp.T)[0]      # (q, H)
        mean = sol.T @ (action - state.mean_fn[None, :])
        cov = ops.symmetric(state.cov_in - cov_tp @ sol)
        chol, _ = ops.safe_cholesky(cov)
        return state.replace(mean=mean, cov_in=chol @ chol.T, chol_in=chol)

    def condition(self, state: KernelState, t, action):
        """Exact GP conditioning of the prior on (t, action) observations."""
        return self._conditioned(state, self.k(state, t, t),
                                 self.k(state, state.t, t), action)

    def optimize_hyper(self, state: KernelState, target_matrix,
                       steps: int = 200, lr: float = 0.05) -> KernelState:
        """Fit the hyperparameters to a target (H, d_a) action matrix:
        ``steps`` Adam steps (0.9, 0.999, 1e-8) on ``hyper_nll`` over
        log-hyper, each clamped to ``param_bounds``, a non-finite gradient
        taken as 0; then the prior grams rebuilt at the optimum."""
        bounds = torch.tensor(self.param_bounds, dtype=torch.float32,
                              device=state.hyper.device)
        lo, hi = bounds[:state.hyper.shape[0]].unbind(1)
        target = target_matrix.detach()
        x = torch.log(torch.clamp(state.hyper, lo, hi))
        m, v = torch.zeros_like(x), torch.zeros_like(x)
        for i in range(steps):
            x_ = x.detach().requires_grad_(True)
            hyper = torch.clamp(torch.exp(x_), lo, hi)
            g, = torch.autograd.grad(self.hyper_nll(state, hyper, target),
                                     x_)
            g = torch.where(torch.isfinite(g), g, 0.0)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mhat = m / (1.0 - 0.9 ** (i + 1))
            vhat = v / (1.0 - 0.999 ** (i + 1))
            x = x - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        trial = state.replace(hyper=torch.clamp(torch.exp(x), lo, hi))
        cov = self.k(trial, state.t, state.t)
        chol, _ = ops.safe_cholesky(cov, jitter=0.0)
        return trial.replace(cov_in=cov, chol_in=chol, cov_in_init=cov,
                             cov_prior=cov, chol_prior=chol)

    def hyper_nll(self, state: KernelState, hyper, target_matrix):
        """Negative log-density of a target (H, d_a) matrix under MN(0,
        K_hyper(t, t), V): a function of ``hyper`` that autograd
        differentiates."""
        d_a, h = self.action_dim, self.horizon
        chol_in, _ = ops.safe_cholesky(
            self.k(state.replace(hyper=hyper), state.t, state.t))
        v_inv = _cho_solve(state.chol_out, torch.eye(
            d_a, dtype=target_matrix.dtype, device=target_matrix.device))
        quad = torch.sum(target_matrix
                         * (_cho_solve(chol_in, target_matrix) @ v_inv))
        logdet = lambda chol: 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        return 0.5 * (quad + d_a * logdet(chol_in) + h * logdet(state.chol_out)
                      + self.dim_sample * math.log(2.0 * math.pi))

    def loglikelihood(self, state: KernelState, x):
        """Average matrix-normal log-likelihood of (n, H, d_a) samples."""
        n, h, d_a = x.shape[0], self.horizon, self.action_dim
        diff = x - state.mean[None] - state.mean_fn[None, None, :]
        u_inv_diff = _cho_solve(
            state.chol_in, diff.permute(1, 0, 2).reshape(h, -1))
        u_inv_diff = u_inv_diff.reshape(h, n, d_a).permute(1, 0, 2)
        v_inv = _cho_solve(state.chol_out, torch.eye(
            d_a, dtype=x.dtype, device=x.device))
        quad = torch.einsum("bij,bik,kj->", diff, u_inv_diff, v_inv)
        logdet = lambda chol: 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        return (-0.5 * quad / n
                - 0.5 * self.dim_sample * math.log(2.0 * math.pi)
                - 0.5 * d_a * logdet(state.chol_in)
                - 0.5 * h * logdet(state.chol_out))


@dataclasses.dataclass(frozen=True)
class WhiteNoiseKernelPolicy(BaseKernel):
    """Delta-correlated GP prior: the horizon shift is an index remap, not
    a conditioning solve."""

    kernel: str = "WhiteNoiseKernel"
    name = "WhiteNoiseKernel"

    def update_timesteps(self, state: KernelState, t, anneal=1.0, same=None):
        if same is None:
            same = torch.equal(t, state.t)
        if same:
            return state.replace(t=t)
        eye = self._eye(state.cov_in)
        remap = time_remap_matrix(t, state.t)
        cov_new = self.k(state, t, t)
        cov = remap @ state.cov_in @ remap.T
        cov = ops.symmetric(cov + (eye - remap @ remap.T) @ cov_new)
        chol, pd_ok = ops.safe_cholesky(cov)
        fallback, _ = ops.safe_cholesky(cov_new, jitter=1e-6)
        return state.replace(t=t, mean=remap @ state.mean,
                             cov_in=torch.where(pd_ok, cov, cov_new),
                             chol_in=torch.where(pd_ok, chol, fallback))


@dataclasses.dataclass(frozen=True)
class LgdsKernelPolicy(BaseKernel):
    """Integrator-chain (GP-prior-linear) kernel policy."""

    kernel: str = LGDS
    name = LGDS

    def condition(self, state: KernelState, t, action):
        """Condition on actions at timesteps of the current grid: the LGDS
        Gram is only defined there, so conditioning selects sub-blocks of
        the covariance by time match."""
        sel = time_remap_matrix(t, state.t)          # (q, H)
        return self._conditioned(state, sel @ state.cov_in @ sel.T,
                                 state.cov_in @ sel.T, action)
