"""Weighted matrix-normal M-projection (moment matching).

Port of ``m_projection_mavn`` from ``ppi_tpu/ops/moment_match.py``: fit a
matrix normal to importance-weighted matrix samples, with the weighted
second moments as single matmuls over sqrt-weight-scaled residuals and a
fixed number of flip-flop iterations.
"""

import torch

from ppi_tpu_torch.ops.psd import symmetric
from ppi_tpu_torch.ops.weighting import log_weight_stats


def m_projection_mavn(log_w, samples, covariance_in, covariance_out,
                      iterations: int = 1, update_out: bool = False):
    """Weighted matrix-normal moment match.

    Args:
      log_w: (N,) unnormalized log-weights (may hold -inf).
      samples: (N, d_in, d_out) matrix-valued samples.
      covariance_in: (d_in, d_in) initial row covariance U.
      covariance_out: (d_out, d_out) column covariance V, used through its
        diagonal only.

    Returns:
      mean (d_in, d_out), covariance_in, covariance_out, ess.
    """
    n, d_in, d_out = samples.shape
    _, nw, ess = log_weight_stats(log_w)
    mean = torch.einsum("b,bij->ij", nw, samples)
    diff = samples - mean[None, ...]
    wdiff = torch.sqrt(nw)[:, None, None] * diff
    for _ in range(iterations):
        out_inv_sqrt = torch.rsqrt(torch.diagonal(covariance_out))
        a = wdiff * out_inv_sqrt[None, None, :]
        a2 = a.permute(1, 0, 2).reshape(d_in, n * d_out)
        cov_in_new = symmetric(a2 @ a2.T) / d_out
        if update_out:
            in_inv_sqrt = torch.rsqrt(torch.diagonal(cov_in_new))
            b = wdiff * in_inv_sqrt[None, :, None]
            b2 = b.permute(2, 0, 1).reshape(d_out, n * d_in)
            covariance_out = symmetric(b2 @ b2.T) / d_in
        covariance_in = cov_in_new
    return mean, covariance_in, covariance_out, ess
