"""Gaussian and matrix-normal divergences and entropies.

Port of ``ppi_tpu/ops/divergences.py``, with ``slogdet`` and LU solves.
``solve_ex`` (no error check) keeps a CUDA update free of host syncs; a
singular matrix gives non-finite values, as XLA's solve does.
"""

import math

import torch


def vec(x: torch.Tensor) -> torch.Tensor:
    """Column-major (Fortran) vectorization of a matrix (-> (n p, 1)) or of
    a batch of matrices (-> (b, n p))."""
    if x.dim() == 3:
        return x.transpose(1, 2).reshape(x.shape[0], -1)
    return x.t().reshape(-1, 1)


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


def matrix_gaussian_kl(mean_1, cov_in_1, cov_out_1, mean_2, cov_in_2,
                       cov_out_2) -> torch.Tensor:
    """KL between matrix normals MN(M, U, V). The U/V factorization is
    defined up to a scale, so both operands are first normalized to
    trace(V) = p."""
    n, p = mean_1.shape
    diff = mean_2 - mean_1
    sf1 = p / torch.trace(cov_out_1)
    sf2 = p / torch.trace(cov_out_2)
    cov_out_1 = cov_out_1 * sf1
    cov_out_2 = cov_out_2 * sf2
    cov_in_1 = cov_in_1 / sf1
    cov_in_2 = cov_in_2 / sf2
    # trace(kron(A, B)) = trace(A) trace(B): the kron is never formed
    tr_kron = torch.trace(_solve(cov_out_2, cov_out_1)) * torch.trace(
        _solve(cov_in_2, cov_in_1))
    maha = torch.sum(diff * _solve(cov_in_2, _solve(cov_out_2, diff.T).T))
    return 0.5 * (n * _slogdet(cov_out_2) - n * _slogdet(cov_out_1)
                  + p * _slogdet(cov_in_2) - p * _slogdet(cov_in_1)
                  + tr_kron + maha - n * p)


def matrix_normal_entropy(covariance_in, covariance_out, d_in: int,
                          d_out: int) -> torch.Tensor:
    """Entropy of MN(., U, V), trace-normalizing V to keep the two logdets
    in range (the factorization scale cancels in the sum)."""
    sf = d_out / torch.trace(covariance_out)
    logdet_in = d_out * _slogdet(covariance_in / sf)
    logdet_out = d_in * _slogdet(sf * covariance_out)
    return 0.5 * (logdet_in + logdet_out) + (d_in * d_out / 2.0) * (
        1.0 + math.log(2.0 * math.pi))
