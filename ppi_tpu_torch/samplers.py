"""Base-sample generators with explicit ``torch.Generator`` threading.

Port of ``SamplerKind`` and ``draw_base`` from ``ppi_tpu/samplers.py`` for
the Monte Carlo kind. Every generator returns standard-normal base samples;
the affine map to the policy's distribution happens in the policy layer.
"""

import enum

import torch


class SamplerKind(enum.Enum):
    MONTE_CARLO = "MonteCarlo"
    QUASI_MONTE_CARLO = "QuasiMonteCarlo"
    CUBATURE = "CubatureQuadrature"
    PARTICLES = "Particles"  # Monte Carlo + elite-particle injection


BY_NAME = {k.value: k for k in SamplerKind}
BY_NAME.update({"mc": SamplerKind.MONTE_CARLO,
                "qmc": SamplerKind.QUASI_MONTE_CARLO,
                "quad": SamplerKind.CUBATURE})


def draw_base(kind: SamplerKind, generator: torch.Generator, n: int,
              dim: int, device) -> torch.Tensor:
    """(n, dim) standard-normal base samples drawn from ``generator``
    (which must live on ``device``)."""
    if kind == SamplerKind.MONTE_CARLO:
        return torch.randn(n, dim, generator=generator, device=device)
    raise NotImplementedError(
        f"sampler {kind.value} is not ported yet (ROADMAP queue 1 item 11; "
        "Particles with the iCEM solver in item 10)")
