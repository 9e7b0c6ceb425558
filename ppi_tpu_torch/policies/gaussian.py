"""Vector-valued Gaussian policy for episodic (black-box) optimization.

Port of ``Gaussian`` and ``GaussianState`` from
``ppi_tpu/policies/gaussian.py``. The state is a frozen dataclass of
tensors and every operation returns a new state. The weighted update's
guards are branchless (``torch.where`` on 0-dim bools from
``cholesky_ex``), so an update never waits for the device.
"""

import dataclasses

import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.samplers import SamplerKind, draw_base, inject_particles

SIGMA_MIN = 1e-6
# Pivot-conditioning threshold of the degenerate-covariance rank guard,
# calibrated in the JAX package: a rank-deficient weighted fit whose
# Cholesky "succeeds" leaves its smallest pivot near 5e-4 of the largest,
# while healthy anisotropic fits stay above ~1e-3 up to std ratios of 1000.
RANK_TOL = 2e-3


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """The Cholesky factor without an error check (no host sync)."""
    return torch.linalg.cholesky_ex(a)[0]


@dataclasses.dataclass(frozen=True)
class GaussianState:
    mu: torch.Tensor            # (d,)
    sigma: torch.Tensor         # (d, d)
    chol: torch.Tensor          # (d, d) Cholesky factor of sigma
    sigma_init: torch.Tensor    # (d, d)
    map_sequence: torch.Tensor  # (d,) best sample seen by elite methods
    particles: torch.Tensor     # (K, d) iCEM reuse buffer (K >= 1)
    n_particles: torch.Tensor   # () int32: live rows in the buffer

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Family config (static); all numbers live in ``GaussianState``."""

    dim: int
    sampler: SamplerKind = SamplerKind.MONTE_CARLO
    diagonal: bool = False  # factorized covariance (CEM convention)
    max_particles: int = 1  # iCEM reuse buffer capacity

    name = "Gaussian"

    def init(self, mu: torch.Tensor, sigma: torch.Tensor) -> GaussianState:
        """All state tensors live on ``mu.device``."""
        k = max(1, self.max_particles)
        return GaussianState(
            mu=mu, sigma=sigma, chol=_cholesky(sigma), sigma_init=sigma,
            map_sequence=mu,
            particles=torch.zeros((k, self.dim), dtype=sigma.dtype,
                                  device=mu.device),
            n_particles=torch.zeros((), dtype=torch.int32, device=mu.device))

    def sample(self, state: GaussianState, generator, n: int):
        """Returns (samples, params); params are what weighted_update
        consumes (the same tensor for the plain Gaussian)."""
        z = draw_base(self.sampler, generator, n, self.dim, state.mu.device)
        if self.sampler == SamplerKind.PARTICLES:
            # iCEM elite reuse: elites re-enter through the base batch
            z = inject_particles(z, state.particles, state.n_particles)
        samples = state.mu[None, :] + z @ state.chol.T
        return samples, samples

    def set_particles(self, state: GaussianState, particles, n_live: int):
        """Store reuse particles (elite params) in the fixed-size buffer."""
        k = state.particles.shape[0]
        take = min(k, particles.shape[0])
        buf = torch.cat([particles[:take],
                         torch.zeros_like(state.particles[take:])])
        n = torch.full((), min(n_live, k), dtype=torch.int32,
                       device=state.particles.device)
        return state.replace(particles=buf, n_particles=n)

    def weighted_update(self, state: GaussianState, log_w, params,
                        update_covariance: bool = True):
        mu_new, sigma_new, ess = ops.m_projection(log_w, params)
        if self.diagonal:
            sigma_new = ops.factorized(sigma_new)
        if update_covariance:
            chol_new, ok = ops.safe_cholesky(sigma_new, jitter=0.0)
            # Rank guard: a weight-collapsed batch (ESS near d or below)
            # fits a numerically singular sigma whose Cholesky can still
            # "succeed" with ~0 pivots. Treat small relative pivots as a
            # failure, so an exactly rank-deficient fit (for example two
            # effective samples in d=3) is repaired the same way whichever
            # side of the success/failure rounding edge it falls on.
            pivots = torch.diagonal(chol_new)
            degenerate = ~(torch.min(pivots) > RANK_TOL * torch.max(pivots))
            ok = ok & ~degenerate
            # PD guard: on failure keep the previous covariance, regularized
            sigma_reg = state.sigma + SIGMA_MIN * torch.eye(
                self.dim, dtype=state.sigma.dtype, device=state.sigma.device)
            sigma_sel = torch.where(ok, sigma_new, sigma_reg)
            chol_sel = torch.where(ok, chol_new, _cholesky(sigma_reg))
        else:
            sigma_sel, chol_sel = state.sigma, state.chol
        kl = ops.multivariate_gaussian_kl(mu_new, sigma_sel, state.mu,
                                          state.sigma)
        return state.replace(mu=mu_new, sigma=sigma_sel, chol=chol_sel), \
            ess, kl

    def smooth_update(self, state: GaussianState, mu, sigma, alpha):
        mu_s = alpha * mu + (1.0 - alpha) * state.mu
        sigma_s = alpha * sigma + (1.0 - alpha) * state.sigma
        chol, _ = ops.safe_cholesky(sigma_s, jitter=0.0)
        return state.replace(mu=mu_s, sigma=sigma_s, chol=chol)

    def entropy(self, state: GaussianState):
        return ops.multivariate_gaussian_entropy(state.sigma, self.dim)

    def reset_covariance(self, state: GaussianState) -> GaussianState:
        return state.replace(sigma=state.sigma_init,
                             chol=_cholesky(state.sigma_init))

    def predict_mean(self, state: GaussianState):
        return state.mu

    def set_map_sequence(self, state: GaussianState, seq) -> GaussianState:
        return state.replace(map_sequence=seq)

    # Episodic vector policies have no time axis; these no-ops keep the
    # interface of the matrix-valued families.
    def compute_prior(self, state, t):
        return state

    def update_timesteps(self, state, t, anneal=1.0, same=None):
        return state
