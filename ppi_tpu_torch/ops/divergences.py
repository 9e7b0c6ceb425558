"""Gaussian divergence and entropy.

Port of ``multivariate_gaussian_kl`` and ``multivariate_gaussian_entropy``
from ``ppi_tpu/ops/divergences.py``, with ``slogdet`` and LU solves.
``solve_ex`` (no error check) keeps a CUDA update free of host syncs; a
singular matrix gives non-finite values, as XLA's solve does.
"""

import math

import torch


def _slogdet(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.slogdet(a)[1]


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(a, b)[0]


def multivariate_gaussian_kl(mu_1, sigma_1, mu_2, sigma_2) -> torch.Tensor:
    """KL( N(mu_1, sigma_1) || N(mu_2, sigma_2) )."""
    d = sigma_1.shape[0]
    diff = mu_2 - mu_1
    return 0.5 * (_slogdet(sigma_2) - _slogdet(sigma_1)
                  + torch.trace(_solve(sigma_2, sigma_1))
                  + diff @ _solve(sigma_2, diff) - d)


def multivariate_gaussian_entropy(sigma: torch.Tensor, d: int) -> torch.Tensor:
    return 0.5 * _slogdet(sigma) + (d / 2.0) * (1.0 + math.log(2.0 * math.pi))
