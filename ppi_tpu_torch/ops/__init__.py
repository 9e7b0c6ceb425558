"""Numerical primitives of the PPI update (torch)."""

from ppi_tpu_torch.ops.moment_match import m_projection_mavn
from ppi_tpu_torch.ops.psd import default_jitter, safe_cholesky, symmetric
from ppi_tpu_torch.ops.scalar_opt import (
    ALPHA_LOWER, ALPHA_UPPER, grid_zoom_min)
from ppi_tpu_torch.ops.weighting import (
    effective_sample_size, log_weight_stats, normalize_log_weights,
    select_row, weight_entropy)

__all__ = [
    "m_projection_mavn", "default_jitter", "safe_cholesky", "symmetric",
    "ALPHA_LOWER", "ALPHA_UPPER", "grid_zoom_min", "effective_sample_size",
    "log_weight_stats", "normalize_log_weights", "select_row",
    "weight_entropy",
]
