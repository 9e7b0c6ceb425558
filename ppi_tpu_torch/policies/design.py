"""Prior-design helpers: actuator-range moments and action limiting.

Port of ``ppi_tpu/policies/design.py``. "No limiter" is the same clip with
infinite bounds, keeping one code path.
"""

import torch


def design_moments(lower: torch.Tensor, upper: torch.Tensor, ratio: float):
    """Matrix-normal prior moments that explore an actuator box: mean at the
    box centre, the per-action variance (half-range)^2 split between the
    input scale (ratio) and the output covariance (variance / ratio)."""
    mean = 0.5 * (upper + lower)
    action_variance = 0.25 * (upper - lower) ** 2
    covariance_in = torch.full((1,), ratio, dtype=mean.dtype,
                               device=mean.device)
    covariance_out = torch.diag(action_variance / ratio)
    return mean, covariance_in, covariance_out


def unbounded_like(action_dim: int, device=None):
    """(lower, upper) bounds representing "no limiter"."""
    inf = torch.full((action_dim,), torch.inf, device=device)
    return -inf, inf


def clip_actions(x: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor):
    """Clip the trailing action dimension into [lower, upper]; channels
    beyond ``len(lower)`` (derivative channels) pass through."""
    d = lower.shape[0]
    if x.shape[-1] == d:
        return torch.clamp(x, lower, upper)
    head = torch.clamp(x[..., :d], lower, upper)
    return torch.cat([head, x[..., d:]], dim=-1)
