"""Weight-space (feature) trajectory priors: RBF and quadrature-RFF.

Port of ``ppi_tpu/policies/features.py``. Actions are a linear model
``a(t) = mean_fn + Phi(t) W`` with a matrix-normal prior on W; an optional
derivative channel appends ``dPhi(t) W``. Feature matrices are (H, m) and
the per-sample trajectory synthesis is one batched (H, m) x (n, m, d_a)
product, in f32. With m << H features, sampling and conditioning cost
O(m^3) + O(H m) instead of the kernel policies' O(H^3).

The basis constants (the RBF centres, the Gauss-Hermite nodes and weights)
are computed in float64 numpy, cast to f32 once and kept per device, so
``feat`` copies nothing to the card.
"""

import dataclasses
import functools
import math

import numpy as np
import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.policies.design import clip_actions
from ppi_tpu_torch.policies.primitives import (
    MatrixNormalState, MatrixPolicyBase, init_particle_buffer)


@dataclasses.dataclass(frozen=True)
class FeatureState(MatrixNormalState):
    pass


@functools.lru_cache(maxsize=32)
def _rbf_centres(t_min: float, t_max: float, n: int, device):
    return torch.tensor(np.linspace(t_min, t_max, n), dtype=torch.float32,
                        device=device)


@functools.lru_cache(maxsize=32)
def _hermite_nodes(order: int, lengthscale: float, device):
    """(frequencies, weights) of the positive Gauss-Hermite nodes."""
    x, w = np.polynomial.hermite.hermgauss(2 * order)
    freqs = np.sqrt(2.0) * x[order:] / lengthscale
    weights = 2.0 * w[order:] / np.sqrt(np.pi)
    as_f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return as_f32(freqs), as_f32(weights)


@dataclasses.dataclass(frozen=True)
class BaseFeatures(MatrixPolicyBase):
    """Common sampling, update and conditioning of the feature families."""

    add_bias: bool = False

    # ---- family-specific basis functions ---------------------------------
    def feat(self, state: FeatureState, t):
        raise NotImplementedError

    def dfeat(self, state: FeatureState, t):
        raise NotImplementedError

    def _with_bias(self, blocks, t, d_dt: bool):
        """Append the bias column (ones for feat, zeros for dfeat)."""
        if self.add_bias:
            col = torch.zeros_like(t) if d_dt else torch.ones_like(t)
            blocks = blocks + (col[:, None],)
        return torch.cat(blocks, dim=1)

    # ---- API --------------------------------------------------------------
    def init(self, time_sequence, mean, covariance_in, covariance_out,
             lower=None, upper=None) -> FeatureState:
        """``covariance_in`` is the scalar weight variance (shape (1,)).
        All tensors live on ``time_sequence.device``."""
        if not self.lengthscale > 0.0:
            raise ValueError(f"lengthscale {self.lengthscale} must be "
                             "positive")
        m, d_a = self.dim_features, self.action_dim
        dev = time_sequence.device
        if lower is None:
            lower = torch.full((d_a,), -torch.inf, device=dev)
            upper = torch.full((d_a,), torch.inf, device=dev)
        cov_in = covariance_in.reshape(()) * torch.eye(m, device=dev)
        chol_in, _ = ops.safe_cholesky(cov_in, jitter=0.0)
        chol_out, _ = ops.safe_cholesky(covariance_out, jitter=0.0)
        particles, n_particles = init_particle_buffer(
            self.max_particles, m, d_a, dev)
        return FeatureState(
            t=time_sequence, mean=torch.zeros((m, d_a), device=dev),
            cov_in=cov_in, chol_in=chol_in, cov_out=covariance_out,
            chol_out=chol_out, cov_in_init=cov_in, mean_fn=mean,
            lower=lower, upper=upper,
            map_sequence=torch.zeros((m, d_a), device=dev),
            particles=particles, n_particles=n_particles)

    def sample(self, state: FeatureState, generator, n: int):
        """Returns (actions (n, H, d_out), params = weight samples (n, m,
        d_a)); d_out = 2 d_a with the derivative channel, else d_a."""
        z = self.base_sample(state, generator, n)
        ws = self.transform_base(state, z)
        feat_t = self.feat(state, state.t)             # (H, m)
        xs = state.mean_fn[None, None, :] + torch.einsum(
            "ki,bij->bkj", feat_t, ws)                 # (n, H, d_a)
        if self.use_derivatives:
            dxs = torch.einsum("ki,bij->bkj", self.dfeat(state, state.t), ws)
            xs = torch.cat([xs, dxs], dim=-1)
        return clip_actions(xs, state.lower, state.upper), ws

    def weighted_update(self, state, log_w, params, update_covariance=True):
        # feature policies fit in weight space; the mean reverts on PD
        # failure
        return self.mavn_update(state, log_w, params,
                                update_covariance=update_covariance,
                                revert_mean_on_failure=True)

    def _mapped(self, state: FeatureState, weights):
        mu = state.mean_fn[None, :] + self.feat(state, state.t) @ weights
        return clip_actions(mu, state.lower, state.upper)

    def predict_mean(self, state: FeatureState):
        return self._mapped(state, state.mean)

    def map_action_sequence(self, state: FeatureState):
        """The MAP/elite sample mapped from weight space to actions (the
        elite solvers store weight samples for feature policies)."""
        return self._mapped(state, state.map_sequence)

    def predict(self, state: FeatureState):
        """(mean (H, d_a), sigma_in (H, H), sigma_out (d_a, d_a), std (H,
        d_a))."""
        feat_t = self.feat(state, state.t)
        sigma_in = feat_t @ state.cov_in @ feat_t.T
        std = torch.sqrt(torch.outer(torch.diagonal(sigma_in),
                                     torch.diagonal(state.cov_out)))
        return self.predict_mean(state), sigma_in, state.cov_out, std

    def condition(self, state: FeatureState, t, action):
        """Bayesian linear conditioning of the weight prior on (t, action)
        pairs (Minka's linear-Gaussian update)."""
        f = self.feat(state, t)                       # (q, m)
        cov0_inv = torch.linalg.inv_ex(state.cov_in)[0]
        s_xx = f.T @ f + cov0_inv
        s_yx = (action - state.mean_fn[None, :]).T @ f \
            + state.mean.T @ cov0_inv
        mean_new = torch.linalg.solve_ex(s_xx, s_yx.T)[0]
        cov_new = ops.symmetric(torch.linalg.inv_ex(s_xx)[0])
        chol, _ = ops.safe_cholesky(cov_new, jitter=0.0)
        return state.replace(mean=mean_new, cov_in=cov_new, chol_in=chol)

    def update_timesteps(self, state: FeatureState, t, anneal=1.0,
                         same=None):
        """Receding-horizon shift: features are global in time, so only the
        window moves; annealing pulls the weight covariance back toward the
        prior. ``same`` (the kernel families' no-op test) is not needed."""
        del same
        cov = anneal * state.cov_in + (1.0 - anneal) * state.cov_in_init
        chol, _ = ops.safe_cholesky(cov, jitter=0.0)
        return state.replace(t=t, cov_in=cov, chol_in=chol)


@dataclasses.dataclass(frozen=True)
class RbfFeatures(BaseFeatures):
    """Normalized radial-basis features with uniformly spaced centres."""

    n_features: int = 10
    lengthscale: float = 1.0
    # the centres are anchored to the initial full time range at
    # construction: the MPC window in state.t shifts, the basis does not
    t_min: float = 0.0
    t_max: float = 1.0

    name = "RbfFeatures"

    @property
    def dim_features(self) -> int:
        return self.n_features + (1 if self.add_bias else 0)

    @property
    def _ls(self) -> float:
        return self.lengthscale / math.sqrt(2.0)

    @property
    def _norm(self) -> float:
        return 1.0 / math.sqrt(math.sqrt(math.pi) * self.n_features
                               * self._ls)

    def with_time_range(self, time_sequence) -> "RbfFeatures":
        return dataclasses.replace(
            self, t_min=float(time_sequence[0]),
            t_max=float(time_sequence[-1]))

    def _centres(self, device):
        return _rbf_centres(self.t_min, self.t_max, self.n_features, device)

    def feat(self, state, t):
        diff = (t[:, None] - self._centres(t.device)[None, :]) / self._ls
        f = self._norm * torch.exp(-0.5 * diff * diff)
        return self._with_bias((f,), t, d_dt=False)

    def dfeat(self, state, t):
        diff = t[:, None] - self._centres(t.device)[None, :]
        g = diff / self._ls
        f = -self._norm * diff / (self._ls ** 2) * torch.exp(-0.5 * g * g)
        return self._with_bias((f,), t, d_dt=True)


@dataclasses.dataclass(frozen=True)
class RffFeatures(BaseFeatures):
    """Gauss-Hermite quadrature random Fourier features of the SE kernel:
    cos/sin features at the positive Hermite nodes, weighted by the
    quadrature weights; a deterministic m-feature approximation."""

    order: int = 10
    lengthscale: float = 1.0

    name = "RffFeatures"

    @property
    def dim_features(self) -> int:
        return 2 * self.order + (1 if self.add_bias else 0)

    def _nodes(self, device):
        return _hermite_nodes(self.order, self.lengthscale, device)

    def feat(self, state, t):
        freqs, weights = self._nodes(t.device)
        phase = t[:, None] * freqs[None, :]
        sw = torch.sqrt(weights)[None, :]
        return self._with_bias(
            (torch.cos(phase) * sw, torch.sin(phase) * sw), t, d_dt=False)

    def dfeat(self, state, t):
        freqs, weights = self._nodes(t.device)
        phase = t[:, None] * freqs[None, :]
        fw = (freqs * torch.sqrt(weights))[None, :]
        return self._with_bias(
            (-torch.sin(phase) * fw, torch.cos(phase) * fw), t, d_dt=True)
