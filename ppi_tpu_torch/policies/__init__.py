"""Policy/prior library: Gaussian, feature, kernel and noise families.

``make_policy`` is the JAX package's name-based factory: it accepts the
union of all hyperparameters and each family takes what it needs.
"""

import torch

from ppi_tpu_torch.policies.design import (
    clip_actions, design_moments, unbounded_like)
from ppi_tpu_torch.policies.features import (
    BaseFeatures, FeatureState, RbfFeatures, RffFeatures)
from ppi_tpu_torch.policies.gaussian import Gaussian, GaussianState
from ppi_tpu_torch.policies.kernels import (
    KERNELS, LGDS, BaseKernel, KernelState, LgdsKernelPolicy,
    WhiteNoiseKernelPolicy)
from ppi_tpu_torch.policies.noise import (
    ColouredNoise, NoiseState, SmoothActionNoise, SmoothExplorationNoise,
    WhiteNoiseIid)
from ppi_tpu_torch.samplers import BY_NAME as SAMPLERS_BY_NAME
from ppi_tpu_torch.samplers import SamplerKind

__all__ = ["BaseFeatures", "FeatureState", "RbfFeatures", "RffFeatures",
           "BaseKernel", "KernelState", "LgdsKernelPolicy",
           "WhiteNoiseKernelPolicy", "KERNELS", "Gaussian", "GaussianState",
           "NoiseState", "WhiteNoiseIid", "ColouredNoise",
           "SmoothExplorationNoise", "SmoothActionNoise", "clip_actions",
           "design_moments", "unbounded_like", "make_policy", "POLICY_NAMES"]

NOISE_FAMILIES = {
    "WhiteNoiseIid": WhiteNoiseIid,
    "ColouredNoise": ColouredNoise,
    "SmoothExplorationNoise": SmoothExplorationNoise,
    "SmoothActionNoise": SmoothActionNoise,
}
POLICY_NAMES = [
    "RbfFeatures", "RffFeatures", "SquaredExponentialKernel",
    "WhiteNoiseKernel", "WhiteNoiseIid", "ColouredNoise", "SmoothActionNoise",
    "SmoothExplorationNoise", "Matern12Kernel", "Matern32Kernel",
    "Matern52Kernel", "PeriodicKernel", LGDS,
]


def make_policy(name: str, time_sequence, action_dimension: int, mean,
                covariance_in, covariance_out, lengthscale: float = 1.0,
                period: float = 1.0, n_features: int = 10, order: int = 10,
                sampler="MonteCarlo", beta: float = 2.0,
                use_derivatives: bool = False, add_bias: bool = False,
                lower=None, upper=None, max_particles: int = 1,
                lgds_order: int = 2, track_entropy: bool = False,
                device="cuda"):
    """Build (family, state) for a policy family by reference-compatible
    name, with every state tensor on ``device`` (the card unless the caller
    names another). ``beta`` is the noise families' colour exponent or
    smoothing coefficient; WhiteNoiseIid ignores it."""
    if name not in POLICY_NAMES:
        raise ValueError(f"Unknown policy family: {name!r}; expected one of "
                         f"{POLICY_NAMES}")
    sampler_kind = (sampler if isinstance(sampler, SamplerKind)
                    else SAMPLERS_BY_NAME[sampler])
    as_dev = lambda x: (None if x is None else torch.as_tensor(
        x, dtype=torch.float32).to(device))
    t = as_dev(time_sequence)
    common = dict(horizon=int(t.shape[0]), action_dim=int(action_dimension),
                  sampler=sampler_kind, max_particles=max_particles)
    moments = (as_dev(mean), as_dev(covariance_in), as_dev(covariance_out))
    bounds = dict(lower=as_dev(lower), upper=as_dev(upper))
    if name in NOISE_FAMILIES:
        if name != "WhiteNoiseIid":
            common["beta"] = beta
        fam = NOISE_FAMILIES[name](**common)
        return fam, fam.init(t, *moments, **bounds)
    common.update(use_derivatives=use_derivatives,
                  track_entropy=track_entropy)
    if name in ("RbfFeatures", "RffFeatures"):
        if name == "RbfFeatures":
            fam = RbfFeatures(n_features=n_features, lengthscale=lengthscale,
                              add_bias=add_bias, t_min=float(t[0]),
                              t_max=float(t[-1]), **common)
        else:
            fam = RffFeatures(order=order, lengthscale=lengthscale,
                              add_bias=add_bias, **common)
        return fam, fam.init(t, *moments, **bounds)
    if name == "WhiteNoiseKernel":
        fam = WhiteNoiseKernelPolicy(**common)
    elif name == LGDS:
        fam = LgdsKernelPolicy(lgds_order=lgds_order, **common)
    else:
        fam = BaseKernel(kernel=name, **common)
    return fam, fam.init(t, *moments, lengthscale=lengthscale, period=period,
                         **bounds)
