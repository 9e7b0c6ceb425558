"""Base-sample generators with explicit ``torch.Generator`` threading.

Port of ``ppi_tpu/samplers.py``:

  * ``MONTE_CARLO``       -- i.i.d. standard normal draws;
  * ``QUASI_MONTE_CARLO`` -- scrambled Sobol + inverse CDF (``ops/qmc.py``);
  * ``CUBATURE``          -- the 2d deterministic sigma points sqrt(d) [I; -I];
  * ``PARTICLES``         -- Monte Carlo draws; the policy then overwrites the
                             first lanes with its stored elites
                             (``inject_particles``, iCEM sample reuse).

Every generator returns standard-normal base samples; the affine map to the
policy's distribution happens in the policy layer.
"""

import enum
import math

import torch

from ppi_tpu_torch.ops.qmc import sobol_normal


class SamplerKind(enum.Enum):
    MONTE_CARLO = "MonteCarlo"
    QUASI_MONTE_CARLO = "QuasiMonteCarlo"
    CUBATURE = "CubatureQuadrature"
    PARTICLES = "Particles"  # Monte Carlo + elite-particle injection


BY_NAME = {k.value: k for k in SamplerKind}
BY_NAME.update({"mc": SamplerKind.MONTE_CARLO,
                "qmc": SamplerKind.QUASI_MONTE_CARLO,
                "quad": SamplerKind.CUBATURE})


def cubature_points(dim: int, device=None) -> torch.Tensor:
    """(2 dim, dim) cubature sigma points sqrt(dim) [+e_i; -e_i]."""
    eye = torch.eye(dim, device=device)
    return math.sqrt(dim) * torch.cat([eye, -eye])


def draw_base(kind: SamplerKind, generator: torch.Generator, n: int,
              dim: int, device) -> torch.Tensor:
    """(n, dim) standard-normal(-structured) base samples drawn from
    ``generator`` (which must live on ``device``)."""
    if kind in (SamplerKind.MONTE_CARLO, SamplerKind.PARTICLES):
        return torch.randn(n, dim, generator=generator, device=device)
    if kind == SamplerKind.QUASI_MONTE_CARLO:
        return sobol_normal(generator, n, dim, device)
    if kind == SamplerKind.CUBATURE:
        if n != 2 * dim:
            raise ValueError(
                f"Cubature quadrature produces exactly 2*dim={2 * dim} "
                f"samples; got n_samples={n}. Set n_samples accordingly.")
        return cubature_points(dim, device)
    raise ValueError(f"Unknown sampler kind {kind}")


def inject_particles(samples: torch.Tensor, particles: torch.Tensor,
                     n_particles: torch.Tensor) -> torch.Tensor:
    """Overwrite the first ``n_particles`` lanes of ``samples`` with the rows
    of the fixed-size (K, ...) buffer ``particles`` (``n_particles``: a
    0-dim int tensor of live rows). No host sync."""
    n, k = samples.shape[0], particles.shape[0]
    lane = torch.arange(n, device=samples.device)
    use = lane < torch.clamp(n_particles, max=min(k, n))
    src = torch.index_select(particles, 0, torch.clamp(lane, max=k - 1))
    return torch.where(use.reshape((-1,) + (1,) * (samples.dim() - 1)), src,
                       samples)
