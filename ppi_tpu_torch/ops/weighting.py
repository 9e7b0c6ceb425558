"""Importance-weight utilities shared by every PPI solver.

Port of ``ppi_tpu/ops/weighting.py``: self-normalized importance-sampling
bookkeeping over log-weights that may hold ``-inf`` (masked lanes).
"""

import torch


def normalize_log_weights(log_w: torch.Tensor) -> torch.Tensor:
    """Normalize log-weights so that ``exp(log_nw)`` sums to one."""
    return log_w - torch.logsumexp(log_w, dim=-1)


def effective_sample_size(log_nw: torch.Tensor) -> torch.Tensor:
    """Kish ESS from normalized log-weights: exp(-logsumexp(2 log_nw))."""
    return torch.exp(-torch.logsumexp(2.0 * log_nw, dim=-1))


def weight_entropy(log_nw: torch.Tensor) -> torch.Tensor:
    """sum(w log w) of normalized weights (0 where w = 0)."""
    nw = torch.exp(log_nw)
    return torch.sum(torch.where(nw > 0.0, log_nw * nw, 0.0))


def log_weight_stats(log_w: torch.Tensor):
    """Return (log_nw, nw, ess) in one pass."""
    log_nw = normalize_log_weights(log_w)
    nw = torch.exp(log_nw)
    return log_nw, nw, effective_sample_size(log_nw)


def select_row(params: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    """The argmax-weight row of ``params`` (N, ...), as a one-hot
    contraction over the sample axis (no host round trip for the index).
    ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    onehot = (torch.arange(log_w.shape[0], device=log_w.device)
              == torch.argmax(log_w)).to(params.dtype)
    return torch.tensordot(onehot, params, dims=1)
