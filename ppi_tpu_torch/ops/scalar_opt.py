"""Temperature search by vectorized grid zoom.

Port of ``ALPHA_LOWER``, ``ALPHA_UPPER`` and ``grid_zoom_min`` from
``ppi_tpu/ops/scalar_opt.py``. The JAX ``vmap`` over candidates becomes one
batched call: ``fn`` maps an ``(n_candidates,)`` tensor of temperatures to
``(n_candidates,)`` objective values (an ``(n_candidates, N)`` evaluation
inside). The search stays on the device: no candidate reaches the host.
"""

from typing import Callable

import torch

# the reference's temperature bounds
ALPHA_LOWER = 1e-5
ALPHA_UPPER = 5e2


def _linspace(a, b, n: int):
    """``jnp.linspace``'s arithmetic, so both packages search one grid:
    start * (1 - s) + stop * s with s = iota / (n - 1), and stop exact."""
    s = torch.arange(n - 1, dtype=a.dtype, device=a.device) / (n - 1)
    return torch.cat([a * (1 - s) + b * s, b.reshape(1)])


def grid_zoom_min(fn: Callable, lo: float = ALPHA_LOWER,
                  hi: float = ALPHA_UPPER, n_grid: int = 64, zooms: int = 2,
                  zoom_points: int = 33, log_space: bool = True,
                  device=None):
    """Minimize a scalar function by a grid sweep then ``zooms`` re-grids of
    the two cells around the argmin (each one batched evaluation)."""
    tf = torch.log if log_space else (lambda x: x)
    itf = torch.exp if log_space else (lambda x: x)
    # the f32 bounds, transformed in f32 on the host (exact as Python floats)
    lo_v = tf(torch.tensor(lo, dtype=torch.float32)).item()
    hi_v = tf(torch.tensor(hi, dtype=torch.float32)).item()
    a = torch.full((), lo_v, dtype=torch.float32, device=device)
    b = torch.full((), hi_v, dtype=torch.float32, device=device)
    best = None
    for n in (n_grid,) + (zoom_points,) * zooms:
        xs = _linspace(a, b, n)
        ys = fn(itf(xs))
        i = torch.argmin(ys)
        cell = (b - a) / (n - 1)
        # index_select, not xs[i]: a 0-dim index tensor goes through .item()
        best = torch.index_select(xs, 0, i.reshape(1)).reshape(())
        a = torch.clamp(best - cell, min=lo_v)
        b = torch.clamp(best + cell, max=hi_v)
    return itf(best)
