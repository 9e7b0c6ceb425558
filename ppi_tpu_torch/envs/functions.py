"""Analytic test functions for black-box optimization.

Port of ``ppi_tpu/envs/functions.py``: batched (N, d) -> (N,) cost maps
with known optima. Every function is ``f(generator, x) -> costs``;
deterministic functions ignore the generator.
"""

import dataclasses
import functools
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Himmelblau:
    """Negated Himmelblau (2-D, four global optima at cost ~ -0)."""

    dim: int = 2
    f_opt = 0.0

    def __call__(self, generator, x):
        a = x[:, 0] ** 2 + x[:, 1] - 11.0
        b = x[:, 0] + x[:, 1] ** 2 - 7.0
        return -(a * a + b * b) - self.f_opt


@dataclasses.dataclass(frozen=True)
class Rosenbrock:
    dim: int = 2
    f_opt = 0.0

    @property
    def x_opt(self):
        return np.ones((self.dim,))

    def __call__(self, generator, x):
        head, tail = x[:, :-1], x[:, 1:]
        return torch.sum(100.0 * (tail - head ** 2) ** 2 + (1.0 - head) ** 2,
                         dim=-1) - self.f_opt


@dataclasses.dataclass(frozen=True)
class Styblinski:
    dim: int = 2

    @property
    def x_opt(self):
        return -2.903534 * np.ones((self.dim,))

    @property
    def f_opt(self):
        return -39.16599 * self.dim

    def __call__(self, generator, x):
        return (0.5 * torch.sum(x ** 4 - 16.0 * x ** 2 + 5.0 * x, dim=-1)
                - self.f_opt)


@dataclasses.dataclass(frozen=True)
class Rastrigin:
    dim: int = 2
    f_opt = 0.0
    amplitude = 10.0

    @property
    def x_opt(self):
        return np.zeros((self.dim,))

    def __call__(self, generator, x):
        return (self.amplitude * self.dim
                + torch.sum(x ** 2 - self.amplitude
                            * torch.cos(2.0 * math.pi * x), dim=-1)
                - self.f_opt)


@functools.lru_cache(maxsize=8)
def _sphere_quadratic(dim: int, seed: int, device: torch.device):
    """NoisySphere's PSD matrix, built by numpy from ``seed`` (the same
    matrix as the JAX package's), once per device."""
    chol = np.random.default_rng(seed).standard_normal((dim, dim))
    return torch.from_numpy((chol @ chol.T).astype(np.float32)).to(device)


@dataclasses.dataclass(frozen=True)
class NoisySphere:
    """Random PSD quadratic with Gaussian evaluation noise drawn from the
    generator."""

    dim: int = 2
    seed: int = 0
    noise_std: float = 0.01
    f_opt = 0.0

    def quadratic(self, device) -> torch.Tensor:
        """The PSD matrix on ``device`` (the caller's: the samples')."""
        return _sphere_quadratic(self.dim, self.seed, torch.device(device))

    @property
    def x_opt(self):
        return np.zeros((self.dim,))

    # ``parallel.sharded_objective`` passes all N samples and this rank's
    # ``rows``: the costs are computed for all N, as unsharded, so a row's
    # bits do not depend on the shard (the einsum's per-row result can
    # depend on the batch size)
    takes_rows = True

    def __call__(self, generator, x, rows=None):
        """(N, d) samples -> (N,) costs; with ``rows=(lo, hi)`` rows
        lo..hi-1 of the (N,) costs."""
        noise = self.noise_std * torch.randn(x.shape[0], generator=generator,
                                             device=x.device)
        quad = torch.einsum("bi,ij,bj->b", x, self.quadratic(x.device), x)
        costs = quad + noise - self.f_opt
        return costs if rows is None else costs[rows[0]:rows[1]]


FUNCTIONS = {
    "Himmelblau": Himmelblau,
    "Rosenbrock": Rosenbrock,
    "Rastrigin": Rastrigin,
    "Styblinski": Styblinski,
    "NoisySphere": NoisySphere,
}


def make_function(name: str, dim: int, **kwargs):
    """Build a test function by name, keeping only the settings it declares
    (the runner passes ``seed``, which only NoisySphere takes)."""
    cls = FUNCTIONS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(dim=dim, **{k: v for k, v in kwargs.items() if k in fields})
