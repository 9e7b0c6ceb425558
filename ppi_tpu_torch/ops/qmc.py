"""Scrambled Sobol sequences on the device.

Port of ``ppi_tpu/ops/qmc.py``. The Sobol direction numbers, a (d, 30)
table, come from SciPy's Joe-Kuo tables on the host (cached per dimension);
point ``i`` is the XOR over the bit-planes of ``gray(i)`` of those numbers,
built on the device, then XOR-ed with a random 30-bit digital shift per
dimension drawn from the ``torch.Generator``. The integers are int64 (torch
has no full uint32 arithmetic); every value stays below 2^30.
"""

import functools
import math

import numpy as np
import torch

_BITS = 30  # SciPy's Sobol tables are 30-bit


@functools.lru_cache(maxsize=None)
def _direction_numbers(dim: int) -> np.ndarray:
    """(dim, _BITS) Sobol direction numbers (host side, cached)."""
    from scipy.stats import qmc

    return np.asarray(qmc.Sobol(d=dim, scramble=False)._sv, dtype=np.int64)


def sobol_points(n: int, dim: int, shift: torch.Tensor) -> torch.Tensor:
    """The first ``n`` Sobol points in (0, 1)^dim under the digital
    ``shift`` ((1, dim) int64 in [0, 2^30), on the output's device)."""
    dev = shift.device
    sv = torch.from_numpy(_direction_numbers(dim)).to(dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((n, dim), dtype=torch.int64, device=dev)
    for b in range(_BITS):
        acc ^= ((gray >> b) & 1)[:, None] * sv[None, :, b]
    acc ^= shift
    # to (0, 1): a half-ulp offset, so 0 never appears
    return (acc.to(torch.float32) + 0.5) * (2.0 ** -_BITS)


def sobol_uniform(generator: torch.Generator, n: int, dim: int,
                  device) -> torch.Tensor:
    """n scrambled-Sobol points in (0, 1)^dim (the first n of the
    sequence), the shift drawn from ``generator``."""
    shift = torch.randint(0, 2 ** _BITS, (1, dim), generator=generator,
                          device=device)
    return sobol_points(n, dim, shift)


def uniform_to_normal(u: torch.Tensor, shrinkage: float = 0.9999):
    """The inverse normal CDF; the shrinkage keeps erfinv off its poles."""
    u = 0.5 + shrinkage * (u - 0.5)
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)


def sobol_normal(generator: torch.Generator, n: int, dim: int, device,
                 shrinkage: float = 0.9999) -> torch.Tensor:
    """Standard-normal scrambled-Sobol draws via the inverse CDF."""
    return uniform_to_normal(sobol_uniform(generator, n, dim, device),
                             shrinkage)
