"""Function-space (GP kernel) trajectory prior, squared-exponential kernel.

Port of ``KernelState``, ``k_squared_exponential`` and the SE path of
``BaseKernel`` from ``ppi_tpu/policies/kernels.py``. The prior over an
action sequence is a GP on the H planning timesteps, so U = K(t, t) is
(H, H); the receding-horizon shift conditions through the cached prior
Cholesky with triangular solves. The other kernels are ROADMAP queue 1
item 11.
"""

import dataclasses

import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.policies.design import clip_actions
from ppi_tpu_torch.policies.primitives import (
    MatrixNormalState, MatrixPolicyBase, init_particle_buffer)


@dataclasses.dataclass(frozen=True)
class KernelState(MatrixNormalState):
    hyper: torch.Tensor = None       # (sigma, lengthscale)
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
    """GP trajectory prior with receding-horizon conditioning (SE kernel)."""

    kernel: str = "SquaredExponentialKernel"
    shift_eps: float = 1e-5

    name = "BaseKernel"

    def __post_init__(self):
        if self.kernel != "SquaredExponentialKernel":
            raise ValueError(f"kernel {self.kernel!r} is not ported yet "
                             "(ROADMAP queue 1 item 11)")

    @property
    def dim_features(self) -> int:
        return self.horizon

    def k(self, state: KernelState, t1, t2):
        return k_squared_exponential(state.hyper, t1, t2)

    def _eye(self, like):
        return torch.eye(self.horizon, dtype=like.dtype, device=like.device)

    # ---- construction -----------------------------------------------------

    def init(self, time_sequence, mean, covariance_in, covariance_out,
             lengthscale=1.0, lower=None, upper=None) -> KernelState:
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
        hyper = torch.stack([sigma, torch.full_like(sigma, lengthscale)])
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
