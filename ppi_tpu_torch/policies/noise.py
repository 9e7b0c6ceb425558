"""Diagonal per-timestep noise priors: white, coloured, smoothed.

Port of ``ppi_tpu/policies/noise.py``. These priors keep an independent
(mean, std) per (timestep, action) cell: the cheap baseline family of
MPPI/CEM-style MPC. Coloured 1/f^beta noise comes from ``ops/fftnoise.py``;
the causal smoothing ``ema_smooth`` is a loop over the H steps. Sampling and
the update read nothing back from the device.
"""

import dataclasses
import math

import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.ops.fftnoise import powerlaw_psd_gaussian
from ppi_tpu_torch.policies.design import clip_actions
from ppi_tpu_torch.policies.kernels import time_remap_matrix
from ppi_tpu_torch.samplers import SamplerKind, inject_particles


@dataclasses.dataclass(frozen=True)
class NoiseState:
    t: torch.Tensor             # (H,)
    mean: torch.Tensor          # (H, d_a) offset from mean_fn
    std: torch.Tensor           # (H, d_a)
    sigma_row: torch.Tensor     # (d_a,) per-action std of the prior
    mean_fn: torch.Tensor       # (d_a,)
    lower: torch.Tensor
    upper: torch.Tensor
    map_sequence: torch.Tensor  # (H, d_a) actions of the best sample
    particles: torch.Tensor     # (K, H, d_a)
    n_particles: torch.Tensor   # () int32

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def ema_smooth(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Causal first-order smoothing along axis -2 (time):
    y_0 = x_0; y_t = (1 - beta) y_{t-1} + beta x_t."""
    ys = [x[..., 0, :]]
    for t in range(1, x.shape[-2]):
        ys.append((1.0 - beta) * ys[-1] + beta * x[..., t, :])
    return torch.stack(ys, -2)


@dataclasses.dataclass(frozen=True)
class WhiteNoiseIid:
    """Independent Gaussian exploration noise per (t, action) cell."""

    horizon: int
    action_dim: int
    sampler: SamplerKind = SamplerKind.MONTE_CARLO
    max_particles: int = 1
    beta: float = 2.0  # colour exponent / smoothing coefficient (subfamilies)

    name = "WhiteNoiseIid"

    @property
    def dim_features(self) -> int:
        return self.horizon

    @property
    def dim_sample(self) -> int:
        return self.horizon * self.action_dim

    def init(self, time_sequence, mean, covariance_in, covariance_out,
             lower=None, upper=None) -> NoiseState:
        """All tensors live on ``time_sequence.device``."""
        h, d_a = self.horizon, self.action_dim
        dev = time_sequence.device
        if lower is None:
            lower = torch.full((d_a,), -torch.inf, device=dev)
            upper = torch.full((d_a,), torch.inf, device=dev)
        sigma_row = torch.sqrt(torch.diagonal(covariance_out)
                               * covariance_in.reshape(()))
        k = max(1, self.max_particles)
        return NoiseState(
            t=time_sequence, mean=torch.zeros((h, d_a), device=dev),
            std=sigma_row[None, :].repeat(h, 1), sigma_row=sigma_row,
            mean_fn=mean, lower=lower, upper=upper,
            map_sequence=torch.zeros((h, d_a), device=dev),
            particles=torch.zeros((k, h, d_a), device=dev),
            n_particles=torch.zeros((), dtype=torch.int32, device=dev))

    # ---- noise synthesis (overridden by subfamilies) ----------------------

    def _normal(self, state: NoiseState, generator, n: int):
        return torch.randn(n, self.horizon, self.action_dim,
                           generator=generator, device=state.mean.device)

    def _inject(self, state: NoiseState, z):
        if self.sampler == SamplerKind.PARTICLES:
            z = inject_particles(z, state.particles, state.n_particles)
        return z

    def base_noise(self, state: NoiseState, generator, n: int):
        return self._inject(state, self._normal(state, generator, n))

    def synth(self, state: NoiseState, z):
        xs = state.mean_fn[None, None, :] + state.mean[None] \
            + state.std[None] * z
        return clip_actions(xs, state.lower, state.upper)

    def sample(self, state: NoiseState, generator, n: int):
        xs = self.synth(state, self.base_noise(state, generator, n))
        return xs, xs

    # ---- update -----------------------------------------------------------

    def weighted_update(self, state: NoiseState, log_w, params,
                        update_covariance: bool = True):
        _, nw, ess = ops.log_weight_stats(log_w)
        state = state.replace(map_sequence=ops.select_row(params, log_w))
        corrected = params - state.mean_fn[None, None, :]
        mean = torch.einsum("b,bij->ij", nw, corrected)
        if update_covariance:
            diff = corrected - mean[None]
            std = torch.sqrt(torch.einsum("b,bij->ij", nw, diff * diff))
        else:
            std = state.std
        return (state.replace(mean=mean, std=std), ess,
                torch.zeros((), device=ess.device))

    # ---- diagnostics / resets ---------------------------------------------

    def entropy(self, state: NoiseState):
        """Entropy of the (H d_a)-dimensional diagonal Gaussian."""
        var = torch.clamp(state.std ** 2, min=1e-30)
        d = self.dim_sample
        return 0.5 * torch.sum(torch.log(var)) \
            + (d / 2.0) * (1.0 + math.log(2.0 * math.pi))

    def reset_covariance(self, state: NoiseState):
        return state.replace(std=state.sigma_row[None, :].repeat(
            self.horizon, 1))

    def predict_mean(self, state: NoiseState):
        return state.mean_fn[None, :] + state.mean

    def predict(self, state: NoiseState):
        """(mean (H, d_a), variance (H, d_a)) of the per-cell prior."""
        return self.predict_mean(state), state.std ** 2

    def map_action_sequence(self, state: NoiseState):
        return state.map_sequence

    def set_map_sequence(self, state: NoiseState, seq):
        return state.replace(map_sequence=seq)

    def set_particles(self, state: NoiseState, particles, n_live: int):
        """Store reuse particles (elite action sequences) in the buffer."""
        k = state.particles.shape[0]
        take = min(k, particles.shape[0])
        buf = torch.cat([particles[:take],
                         torch.zeros_like(state.particles[take:])])
        n = torch.full((), min(n_live, k), dtype=torch.int32,
                       device=state.particles.device)
        return state.replace(particles=buf, n_particles=n)

    def compute_prior(self, state: NoiseState, t):
        return state.replace(t=t)

    # ---- receding horizon -------------------------------------------------

    def update_timesteps(self, state: NoiseState, t, anneal=1.0, same=None):
        """Index-remap the overlapping window; newly exposed steps get the
        prior's std, and the std is annealed toward the prior. On the same
        window the remap is the identity and the anneal still applies, so
        ``same`` (the MPC agent's hint) changes nothing here."""
        del same
        remap = time_remap_matrix(t, state.t)
        std_prior = state.sigma_row[None, :].repeat(self.horizon, 1)
        mean = remap @ state.mean
        eye = torch.eye(self.horizon, device=remap.device)
        fresh = (eye - remap @ remap.T) @ std_prior
        std = torch.sqrt((remap @ state.std) ** 2 + fresh ** 2)
        std = anneal * std + (1.0 - anneal) * std_prior
        return state.replace(t=t, mean=mean, std=std)


@dataclasses.dataclass(frozen=True)
class ColouredNoise(WhiteNoiseIid):
    """1/f^beta-correlated exploration noise; beta=2 (the default) gives
    red/Brownian noise, the iCEM exploration prior."""

    name = "ColouredNoise"

    def base_noise(self, state: NoiseState, generator, n: int):
        if self.horizon == 1:
            return super().base_noise(state, generator, n)
        # correlations along the last (FFT) axis, then time back to axis -2
        z = powerlaw_psd_gaussian(generator, self.beta,
                                  (n, self.action_dim, self.horizon),
                                  state.mean.device)
        return self._inject(state, z.transpose(1, 2))

    def update_timesteps(self, state: NoiseState, t, anneal=1.0, same=None):
        state = super().update_timesteps(state, t, anneal)
        if self.sampler == SamplerKind.PARTICLES:
            # shift the reuse particles one step forward in time, repeating
            # the final action
            p = state.particles
            state = state.replace(particles=torch.cat([p[:, 1:], p[:, -1:]],
                                                      dim=1))
        return state


@dataclasses.dataclass(frozen=True)
class SmoothExplorationNoise(WhiteNoiseIid):
    """Causally smoothed *noise*: the EMA filter runs on the standard-normal
    draws before scaling; beta in (0, 1) is the filter coefficient."""

    beta: float = 0.5
    name = "SmoothExplorationNoise"

    def __post_init__(self):
        if not 0.0 < self.beta < 1.0:
            raise ValueError(f"smoothing beta must be in (0, 1), got "
                             f"{self.beta}")

    def base_noise(self, state: NoiseState, generator, n: int):
        z = ema_smooth(self._normal(state, generator, n), self.beta)
        return self._inject(state, z)


@dataclasses.dataclass(frozen=True)
class SmoothActionNoise(SmoothExplorationNoise):
    """Causally smoothed *actions*: the filter runs on the whole action
    sequence, mean included."""

    name = "SmoothActionNoise"

    def base_noise(self, state: NoiseState, generator, n: int):
        return self._inject(state, self._normal(state, generator, n))

    def synth(self, state: NoiseState, z):
        xs = state.mean_fn[None, None, :] + state.mean[None] \
            + state.std[None] * z
        return clip_actions(ema_smooth(xs, self.beta), state.lower,
                            state.upper)
