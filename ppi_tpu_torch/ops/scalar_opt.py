"""Temperature search by vectorized grid zoom, and a tiny Newton solver.

Port of ``ALPHA_LOWER``, ``ALPHA_UPPER``, ``grid_zoom_min``,
``grid_zoom_root_decreasing``, ``minimize_newton``, ``golden_section_min``
and ``bisect_decreasing`` from ``ppi_tpu/ops/scalar_opt.py`` (the last two
serve the animated figures, ``runners/animations.py``). In the grid searches the JAX ``vmap`` over
candidates becomes one batched call: ``fn`` maps an ``(n_candidates,)``
tensor of temperatures to ``(n_candidates,)`` objective values (an
``(n_candidates, N)`` evaluation inside). The searches stay on the device:
no candidate reaches the host.
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


def _bounds(lo: float, hi: float, log_space: bool, device):
    """(itf, lo_v, hi_v, a, b): the inverse of the search transform, the f32
    bounds transformed in f32 on the host (exact as Python floats), and the
    same as 0-dim tensors on ``device``."""
    tf = torch.log if log_space else (lambda x: x)
    itf = torch.exp if log_space else (lambda x: x)
    lo_v = tf(torch.tensor(lo, dtype=torch.float32)).item()
    hi_v = tf(torch.tensor(hi, dtype=torch.float32)).item()
    a = torch.full((), lo_v, dtype=torch.float32, device=device)
    b = torch.full((), hi_v, dtype=torch.float32, device=device)
    return itf, lo_v, hi_v, a, b


def grid_zoom_min(fn: Callable, lo: float = ALPHA_LOWER,
                  hi: float = ALPHA_UPPER, n_grid: int = 64, zooms: int = 2,
                  zoom_points: int = 33, log_space: bool = True,
                  device=None):
    """Minimize a scalar function by a grid sweep then ``zooms`` re-grids of
    the two cells around the argmin (each one batched evaluation)."""
    itf, lo_v, hi_v, a, b = _bounds(lo, hi, log_space, device)
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


def grid_zoom_root_decreasing(fn: Callable, target: float,
                              lo: float = ALPHA_LOWER,
                              hi: float = ALPHA_UPPER, n_grid: int = 64,
                              zooms: int = 2, zoom_points: int = 33,
                              log_space: bool = True, device=None):
    """Root of a decreasing ``fn`` (``fn(x) = target``) by a grid sweep then
    ``zooms`` re-grids of the cell that holds the crossing; clamps to the
    interval when the target is outside the attained range."""
    itf, _, _, a, b = _bounds(lo, hi, log_space, device)
    for n in (n_grid,) + (zoom_points,) * zooms:
        xs = _linspace(a, b, n)
        ys = fn(itf(xs))
        # decreasing: the root sits in the last cell whose left edge is
        # still above the target
        i = torch.clamp(torch.sum(ys > target) - 1, 0, n - 2)
        a, b = torch.index_select(xs, 0, torch.stack([i, i + 1])).unbind()
    return itf(0.5 * (a + b))


_INV_PHI = 0.6180339887498949  # 1/golden ratio


def golden_section_min(fn: Callable, lo, hi, iters: int = 40,
                       log_space: bool = True, device=None):
    """Golden-section minimization of a unimodal scalar ``fn`` on [lo,
    hi] (in log-x with ``log_space``), ``iters`` fixed steps, each reusing
    the surviving interior value: JAX's loop step for step, in f32."""
    itf, _, _, a, b = _bounds(lo, hi, log_space, device)
    c = b - _INV_PHI * (b - a)
    d = a + _INV_PHI * (b - a)
    fc, fd = fn(itf(c)), fn(itf(d))
    for _ in range(iters):
        right = fc < fd
        a = torch.where(right, a, c)
        b = torch.where(right, d, b)
        c, d = b - _INV_PHI * (b - a), a + _INV_PHI * (b - a)
        known = torch.where(right, fc, fd)
        new = fn(itf(torch.where(right, c, d)))
        fc = torch.where(right, new, known)
        fd = torch.where(right, known, new)
    return itf(0.5 * (a + b))


def bisect_decreasing(fn: Callable, target, lo: float = ALPHA_LOWER,
                      hi: float = ALPHA_UPPER, iters: int = 50,
                      log_space: bool = True, device=None):
    """Solve ``fn(x) = target`` for ``fn`` decreasing on [lo, hi] by
    ``iters`` bisections (in log-x with ``log_space``); clamps to the
    interval when the target is outside the attained range."""
    itf, _, _, a, b = _bounds(lo, hi, log_space, device)
    for _ in range(iters):
        m = 0.5 * (a + b)
        above = fn(itf(m)) > target   # still above the target: go right
        a = torch.where(above, m, a)
        b = torch.where(above, b, m)
    return itf(0.5 * (a + b))


def minimize_newton(fn: Callable, x0: torch.Tensor, iters: int = 25,
                    damping: float = 1e-6):
    """Fixed-iteration damped Newton minimization of a tiny smooth problem
    (the 2-parameter MORE dual). Each iteration tries three Newton and five
    gradient steps and keeps the best improving candidate. ``fn`` maps a
    (d,) tensor to a scalar; derivatives come from ``torch.func``."""
    grad_fn = torch.func.grad(fn)
    hess_fn = torch.func.hessian(fn)
    d = x0.shape[0]
    dev = x0.device
    newton_steps = torch.tensor([1.0, 0.5, 0.1], device=dev)
    gd_steps = torch.tensor([1.0, 0.3, 0.1, 0.03, 0.01], device=dev)
    eye = torch.eye(d, dtype=x0.dtype, device=dev)
    x, fx = x0, fn(x0)
    for _ in range(iters):
        g = grad_fn(x)
        h = hess_fn(x)
        # regularize an indefinite Hessian far enough that the Newton step
        # is bounded; the gradient steps cover the remaining cases
        evals = torch.linalg.eigvalsh(0.5 * (h + h.T))
        lam = torch.clamp(-1.5 * torch.min(evals), min=damping)
        direction = torch.linalg.solve_ex(h + lam * eye, g)[0]
        direction = torch.where(torch.all(torch.isfinite(direction)),
                                direction, g)
        cands = torch.cat([x[None, :] - newton_steps[:, None] * direction,
                           x[None, :] - gd_steps[:, None] * g])
        fvals = torch.stack([fn(c) for c in cands])
        fvals = torch.where(torch.isfinite(fvals), fvals, torch.inf)
        best = torch.argmin(fvals).reshape(1)
        f_best = torch.index_select(fvals, 0, best).reshape(())
        improved = f_best < fx
        x = torch.where(improved, torch.index_select(cands, 0, best)[0], x)
        fx = torch.where(improved, f_best, fx)
    return x, fx
