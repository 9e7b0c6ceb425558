"""Weighted M-projection (moment matching) for vector and matrix samples.

Port of ``m_projection`` and ``m_projection_mavn`` from
``ppi_tpu/ops/moment_match.py``: fit a Gaussian or a matrix normal to
importance-weighted samples, with the weighted second moments as single
matmuls over sqrt-weight-scaled residuals (and a fixed number of
matrix-normal flip-flop iterations). Large vector batches on a CUDA card go
through the hand-written moment-match kernel (``ops/cuda_ops.py``).
"""

import torch

from ppi_tpu_torch.ops.cuda_ops import m_projection_cuda
from ppi_tpu_torch.ops.psd import symmetric
from ppi_tpu_torch.ops.weighting import log_weight_stats

# Batches from which the JAX package takes its fused kernel; measured on a
# TPU. Kept here so both packages take the same branch at the same shapes;
# re-tuning it on the H100 is open (PERF.md, open questions).
KERNEL_MIN_ELEMENTS = 4096 * 64


def m_projection(log_w: torch.Tensor, samples: torch.Tensor,
                 use_kernel: str = "auto"):
    """Weighted Gaussian moment match on vector samples.

    Args:
      log_w: (N,) unnormalized log-weights (may hold -inf for masked lanes).
      samples: (N, d).
      use_kernel: "auto" (a CUDA tensor with N d >= KERNEL_MIN_ELEMENTS and
        d >= 8), "never" or "always"; "always" on a CPU tensor runs the
        kernel's plain version.

    Returns:
      mu (d,), sigma (d, d), ess ().
    """
    if use_kernel not in ("auto", "never", "always"):
        raise ValueError(f"use_kernel={use_kernel!r}: expected auto, never "
                         "or always")
    n, d = samples.shape
    if use_kernel == "always" or (
            use_kernel == "auto" and samples.device.type == "cuda"
            and n * d >= KERNEL_MIN_ELEMENTS and d >= 8):
        return m_projection_cuda(log_w, samples)
    _, nw, ess = log_weight_stats(log_w)
    mu = nw @ samples
    x = torch.sqrt(nw)[:, None] * (samples - mu[None, :])
    return mu, symmetric(x.T @ x), ess


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
