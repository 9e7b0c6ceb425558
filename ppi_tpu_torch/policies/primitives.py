"""Shared machinery for matrix-valued (trajectory) policies.

Port of ``ppi_tpu/policies/primitives.py``. A policy over action sequences
A in R^{H x d_a} is a matrix normal MN(M, U, V); its state is a frozen
dataclass of tensors and every operation returns a new state. The PD guard
is branchless (``torch.where`` on a 0-dim bool), so an update never waits
for the device.
"""

import dataclasses

import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.samplers import SamplerKind, draw_base, inject_particles


@dataclasses.dataclass(frozen=True)
class MatrixNormalState:
    """Moments + auxiliaries of a matrix-normal trajectory prior."""

    t: torch.Tensor             # (H,) time window
    mean: torch.Tensor          # (m, d_a) weight-/function-space mean offset
    cov_in: torch.Tensor        # (m, m)
    chol_in: torch.Tensor       # (m, m)
    cov_out: torch.Tensor       # (d_a, d_a)
    chol_out: torch.Tensor      # (d_a, d_a)
    cov_in_init: torch.Tensor   # (m, m) for covariance resets
    mean_fn: torch.Tensor       # (d_a,) constant mean function
    lower: torch.Tensor         # (d_a,) actuator bounds (±inf when unbounded)
    upper: torch.Tensor
    map_sequence: torch.Tensor  # MAP/elite sample in *param* space (m, d_a)
    particles: torch.Tensor     # (K, m, d_a) reuse buffer (K >= 1)
    n_particles: torch.Tensor   # () int32: live rows in the buffer

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class MatrixPolicyBase:
    """Static configuration shared by the matrix-normal families."""

    horizon: int
    action_dim: int
    sampler: SamplerKind = SamplerKind.MONTE_CARLO
    use_derivatives: bool = False
    max_particles: int = 1
    track_entropy: bool = False  # matrix-normal entropy is O(m^3)
    track_kl: bool = False
    mavn_iterations: int = 1

    @property
    def dim_features(self) -> int:
        raise NotImplementedError

    @property
    def dim_sample(self) -> int:
        return self.dim_features * self.action_dim

    # ---- sampling ---------------------------------------------------------

    def base_sample(self, state: MatrixNormalState, generator, n: int):
        """(n, m, d_a) standard-normal base draws with particle injection."""
        z = draw_base(self.sampler, generator, n, self.dim_sample,
                      state.mean.device).reshape(
                          n, self.dim_features, self.action_dim)
        if self.sampler == SamplerKind.PARTICLES:
            z = inject_particles(z, state.particles, state.n_particles)
        return z

    def transform_base(self, state: MatrixNormalState, z):
        """M + L_U Z L_V^T; (n, m, d_a)."""
        zz = torch.einsum("ki,bij->bkj", state.chol_in, z)
        return state.mean[None] + zz @ state.chol_out.T

    # ---- posterior update -------------------------------------------------

    def mavn_update(self, state: MatrixNormalState, log_w, samples,
                    update_covariance: bool = True,
                    revert_mean_on_failure: bool = True):
        """Matrix-normal moment match with a branchless PD guard: if the
        fitted input covariance is not PD, keep the previous covariance (and,
        for feature policies, the previous mean)."""
        mean_new, cov_in_new, _, ess = ops.m_projection_mavn(
            log_w, samples, state.cov_in, state.cov_out,
            iterations=self.mavn_iterations, update_out=False)
        jitter = 1e-12 if cov_in_new.dtype == torch.float64 else 1e-6
        cov_in_new = cov_in_new + jitter * torch.eye(
            self.dim_features, dtype=cov_in_new.dtype,
            device=cov_in_new.device)
        chol_new, pd_ok = ops.safe_cholesky(cov_in_new, jitter=0.0)

        if update_covariance:
            cov_in_sel = torch.where(pd_ok, cov_in_new, state.cov_in)
            chol_sel = torch.where(pd_ok, chol_new, state.chol_in)
        else:
            cov_in_sel, chol_sel = state.cov_in, state.chol_in
        if revert_mean_on_failure:
            mean_sel = torch.where(pd_ok, mean_new, state.mean)
        else:
            mean_sel = mean_new
        ess = torch.where(pd_ok, ess, float(samples.shape[0]))
        if self.track_kl:
            kl = ops.matrix_gaussian_kl(
                mean_sel, cov_in_sel, state.cov_out,
                state.mean, state.cov_in, state.cov_out)
            kl = torch.where(pd_ok, kl, 0.0)
        else:
            kl = torch.zeros((), device=ess.device)
        new_state = state.replace(mean=mean_sel, cov_in=cov_in_sel,
                                  chol_in=chol_sel)
        return new_state, ess, kl

    def smooth_update(self, state: MatrixNormalState, mean, cov_in, alpha):
        mean_s = alpha * mean + (1.0 - alpha) * state.mean
        cov_s = alpha * cov_in + (1.0 - alpha) * state.cov_in
        chol, _ = ops.safe_cholesky(cov_s, jitter=0.0)
        return state.replace(mean=mean_s, cov_in=cov_s, chol_in=chol)

    # ---- diagnostics ------------------------------------------------------

    def entropy(self, state: MatrixNormalState):
        """The matrix-normal entropy with ``track_entropy``, else 0."""
        if not self.track_entropy:
            return torch.zeros((), device=state.mean.device)
        return ops.matrix_normal_entropy(
            state.cov_in, state.cov_out, self.dim_features, self.action_dim)

    def reset_covariance(self, state: MatrixNormalState):
        chol, _ = ops.safe_cholesky(state.cov_in_init, jitter=0.0)
        return state.replace(cov_in=state.cov_in_init, chol_in=chol)

    def set_map_sequence(self, state: MatrixNormalState, seq):
        return state.replace(map_sequence=seq)

    def set_particles(self, state: MatrixNormalState, particles, n_live: int):
        """Store reuse particles (elite params) in the fixed-size buffer."""
        k = state.particles.shape[0]
        take = min(k, particles.shape[0])
        buf = torch.cat([particles[:take],
                         torch.zeros_like(state.particles[take:])])
        n = torch.full((), min(n_live, k), dtype=torch.int32,
                       device=state.particles.device)
        return state.replace(particles=buf, n_particles=n)

    def compute_prior(self, state: MatrixNormalState, t):
        return state.replace(t=t)

    # Families override:
    def sample(self, state, generator, n):
        raise NotImplementedError

    def weighted_update(self, state, log_w, params, update_covariance=True):
        raise NotImplementedError

    def update_timesteps(self, state, t, anneal=1.0, same=None):
        raise NotImplementedError


def init_particle_buffer(max_particles: int, m: int, d_a: int, device=None):
    k = max(1, max_particles)
    return (torch.zeros((k, m, d_a), device=device),
            torch.zeros((), dtype=torch.int32, device=device))
