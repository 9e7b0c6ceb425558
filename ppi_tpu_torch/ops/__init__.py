"""Numerical primitives of the PPI update (torch)."""

from ppi_tpu_torch.ops.divergences import (
    matrix_gaussian_kl, matrix_normal_entropy, multivariate_gaussian_entropy,
    multivariate_gaussian_kl, vec)
from ppi_tpu_torch.ops.moment_match import (
    KERNEL_MIN_ELEMENTS, m_projection, m_projection_mavn)
from ppi_tpu_torch.ops.psd import (
    default_jitter, factorized, safe_cholesky, symmetric)
from ppi_tpu_torch.ops.scalar_opt import (
    ALPHA_LOWER, ALPHA_UPPER, bisect_decreasing, golden_section_min,
    grid_zoom_min, grid_zoom_root_decreasing, minimize_newton)
from ppi_tpu_torch.ops.weighting import (
    effective_sample_size, log_weight_stats, normalize_log_weights,
    select_row, weight_entropy)

__all__ = [
    "matrix_gaussian_kl", "matrix_normal_entropy",
    "multivariate_gaussian_entropy", "multivariate_gaussian_kl", "vec",
    "KERNEL_MIN_ELEMENTS", "m_projection", "m_projection_mavn",
    "default_jitter", "factorized", "safe_cholesky", "symmetric",
    "ALPHA_LOWER", "ALPHA_UPPER", "bisect_decreasing", "golden_section_min",
    "grid_zoom_min",
    "grid_zoom_root_decreasing", "minimize_newton", "effective_sample_size",
    "log_weight_stats", "normalize_log_weights", "select_row",
    "weight_entropy",
]
