"""Positive-definiteness guards without host round trips.

Port of ``symmetric``, ``factorized``, ``default_jitter`` and
``safe_cholesky`` from ``ppi_tpu/ops/psd.py``. XLA returns NaNs for a
failed factorization where torch raises, so the port uses
``torch.linalg.cholesky_ex`` and reports ``ok = (info == 0) &
all(isfinite(L))`` as a 0-dim bool tensor; callers select the fallback
with ``torch.where``.
"""

import torch


def symmetric(mat: torch.Tensor) -> torch.Tensor:
    """Symmetrize an (estimated) covariance."""
    return 0.5 * (mat + mat.transpose(-1, -2))


def factorized(mat: torch.Tensor) -> torch.Tensor:
    """Zero the off-diagonals."""
    return torch.diag(torch.diagonal(mat))


def default_jitter(dtype) -> float:
    return 1e-6 if dtype == torch.float64 else 1e-5


def safe_cholesky(a: torch.Tensor, jitter: float | None = None):
    """Cholesky with additive jitter; returns ``(chol, ok)``."""
    d = a.shape[-1]
    if jitter is None:
        jitter = default_jitter(a.dtype)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a + jitter * eye)
    ok = (info == 0) & torch.all(torch.isfinite(chol))
    return chol, ok
