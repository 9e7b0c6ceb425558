"""Policy/prior library: the squared-exponential GP kernel prior and the
vector Gaussian of black-box optimization.

``make_policy`` keeps the JAX package's name-based factory for the
trajectory priors; the other kernel, feature and noise families are ROADMAP
queue 1 item 11.
"""

import torch

from ppi_tpu_torch.policies.design import (
    clip_actions, design_moments, unbounded_like)
from ppi_tpu_torch.policies.gaussian import Gaussian, GaussianState
from ppi_tpu_torch.policies.kernels import BaseKernel, KernelState
from ppi_tpu_torch.samplers import BY_NAME as SAMPLERS_BY_NAME
from ppi_tpu_torch.samplers import SamplerKind

__all__ = ["BaseKernel", "KernelState", "Gaussian", "GaussianState",
           "clip_actions", "design_moments", "unbounded_like", "make_policy",
           "POLICY_NAMES"]

POLICY_NAMES = ["SquaredExponentialKernel"]


def make_policy(name: str, time_sequence, action_dimension: int, mean,
                covariance_in, covariance_out, lengthscale: float = 1.0,
                sampler="MonteCarlo", lower=None, upper=None,
                max_particles: int = 1, device="cpu"):
    """Build (family, state) for a policy family by reference-compatible
    name, with every state tensor on ``device``."""
    if name not in POLICY_NAMES:
        raise ValueError(f"policy family {name!r} is not ported yet "
                         "(ROADMAP queue 1 item 11); ported: "
                         f"{POLICY_NAMES}")
    sampler_kind = (sampler if isinstance(sampler, SamplerKind)
                    else SAMPLERS_BY_NAME[sampler])
    as_dev = lambda x: (None if x is None else torch.as_tensor(
        x, dtype=torch.float32).to(device))
    t = as_dev(time_sequence)
    fam = BaseKernel(kernel=name, horizon=int(t.shape[0]),
                     action_dim=int(action_dimension), sampler=sampler_kind,
                     max_particles=max_particles)
    return fam, fam.init(t, as_dev(mean), as_dev(covariance_in),
                         as_dev(covariance_out), lengthscale=lengthscale,
                         lower=as_dev(lower), upper=as_dev(upper))
