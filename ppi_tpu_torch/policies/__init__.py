"""Policy/prior library: the squared-exponential GP kernel prior, the
noise priors and the vector Gaussian of black-box optimization.

``make_policy`` keeps the JAX package's name-based factory for the
trajectory priors; the other kernel and the feature families are ROADMAP
queue 1 item 11.
"""

import torch

from ppi_tpu_torch.policies.design import (
    clip_actions, design_moments, unbounded_like)
from ppi_tpu_torch.policies.gaussian import Gaussian, GaussianState
from ppi_tpu_torch.policies.kernels import BaseKernel, KernelState
from ppi_tpu_torch.policies.noise import (
    ColouredNoise, NoiseState, SmoothActionNoise, SmoothExplorationNoise,
    WhiteNoiseIid)
from ppi_tpu_torch.samplers import BY_NAME as SAMPLERS_BY_NAME
from ppi_tpu_torch.samplers import SamplerKind

__all__ = ["BaseKernel", "KernelState", "Gaussian", "GaussianState",
           "NoiseState", "WhiteNoiseIid", "ColouredNoise",
           "SmoothExplorationNoise", "SmoothActionNoise", "clip_actions",
           "design_moments", "unbounded_like", "make_policy", "POLICY_NAMES"]

NOISE_FAMILIES = {
    "WhiteNoiseIid": WhiteNoiseIid,
    "ColouredNoise": ColouredNoise,
    "SmoothExplorationNoise": SmoothExplorationNoise,
    "SmoothActionNoise": SmoothActionNoise,
}
POLICY_NAMES = ["SquaredExponentialKernel", *NOISE_FAMILIES]


def make_policy(name: str, time_sequence, action_dimension: int, mean,
                covariance_in, covariance_out, lengthscale: float = 1.0,
                sampler="MonteCarlo", beta: float = 2.0, lower=None,
                upper=None, max_particles: int = 1, device="cuda"):
    """Build (family, state) for a policy family by reference-compatible
    name, with every state tensor on ``device`` (the card unless the caller
    names another). ``beta`` is the noise families' colour exponent or
    smoothing coefficient; WhiteNoiseIid ignores it."""
    if name not in POLICY_NAMES:
        raise ValueError(f"policy family {name!r} is not ported yet "
                         "(ROADMAP queue 1 item 11); ported: "
                         f"{POLICY_NAMES}")
    sampler_kind = (sampler if isinstance(sampler, SamplerKind)
                    else SAMPLERS_BY_NAME[sampler])
    as_dev = lambda x: (None if x is None else torch.as_tensor(
        x, dtype=torch.float32).to(device))
    t = as_dev(time_sequence)
    common = dict(horizon=int(t.shape[0]), action_dim=int(action_dimension),
                  sampler=sampler_kind, max_particles=max_particles)
    if name in NOISE_FAMILIES:
        if name != "WhiteNoiseIid":
            common["beta"] = beta
        fam = NOISE_FAMILIES[name](**common)
        return fam, fam.init(t, as_dev(mean), as_dev(covariance_in),
                             as_dev(covariance_out), lower=as_dev(lower),
                             upper=as_dev(upper))
    fam = BaseKernel(kernel=name, **common)
    return fam, fam.init(t, as_dev(mean), as_dev(covariance_in),
                         as_dev(covariance_out), lengthscale=lengthscale,
                         lower=as_dev(lower), upper=as_dev(upper))
