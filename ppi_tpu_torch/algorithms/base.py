"""Optimizer base loop: sample -> evaluate -> mask -> Gibbs-posterior update.

Port of ``ppi_tpu/algorithms/base.py`` (``solve_scan``'s ``lax.scan`` is
the Python loop of ``solve``). NaN costs from diverged rollouts are masked,
not compacted: invalid lanes get a ``-inf`` log-weight so they carry zero
posterior mass; an all-invalid batch zeroes the costs and updates
vacuously. Nothing here reads a device value on the host.
"""

from typing import Callable, NamedTuple

import torch


class Batch(NamedTuple):
    """One evaluated sample batch, after NaN masking."""

    costs: torch.Tensor      # (N,) cleaned costs (invalid lanes zeroed)
    params: torch.Tensor     # (N, ...) policy-space samples
    valid: torch.Tensor      # (N,) bool mask
    log_valid: torch.Tensor  # (N,) 0 / -inf additive mask for log-weights


def mask_costs(costs: torch.Tensor) -> tuple:
    """NaN/Inf filter as a mask."""
    valid = torch.isfinite(costs)
    none_valid = ~torch.any(valid)
    costs_clean = torch.where(valid, costs, 0.0)
    costs_clean = torch.where(none_valid, torch.zeros_like(costs),
                              costs_clean)
    valid = valid | none_valid
    log_valid = torch.where(valid, 0.0, -torch.inf)
    return costs_clean, valid, log_valid


def masked_min(costs, valid):
    return torch.min(torch.where(valid, costs, torch.inf))


def masked_max(costs, valid):
    return torch.max(torch.where(valid, costs, -torch.inf))


def masked_mean_std(costs, valid):
    n = torch.clamp(torch.sum(valid), min=1)
    mean = torch.sum(torch.where(valid, costs, 0.0)) / n
    var = torch.sum(torch.where(valid, (costs - mean) ** 2, 0.0)) / n
    return mean, torch.sqrt(var)


def minmax_normalize(costs, valid):
    """Min-max cost normalization over valid lanes. Masked lanes are zeroed:
    normalized by a near-degenerate range their placeholder costs reach
    ~1e38, and -alpha * 1e38 overflows to Inf, which the -Inf log-mask then
    turns into NaN."""
    lo = masked_min(costs, valid)
    hi = masked_max(costs, valid)
    cn = (costs - lo) / (hi - lo + torch.finfo(costs.dtype).tiny)
    return torch.where(valid, cn, 0.0)


def null_callback(iteration, f, actions, costs, policy_state) -> bool:
    return False


def _one_iteration(solver, family, f, n_samples: int):
    """``step(state, generator) -> (state, (stats, actions, costs))``."""

    def step(state, generator):
        actions, params = family.sample(state, generator, n_samples)
        out = f(generator, actions)
        costs, aux = out if isinstance(out, tuple) else (out, {})
        costs_clean, valid, log_valid = mask_costs(costs)
        batch = Batch(costs_clean, params, valid, log_valid)
        state, stats = solver.update(family, state, batch)
        mean, std = masked_mean_std(costs_clean, valid)
        stats = dict(stats)
        stats["mean"] = mean
        stats["std"] = std
        for k, v in aux.items():
            stats[k] = torch.mean(1.0 * v)
        if "ent" not in stats:
            stats["ent"] = family.entropy(state)
        return state, (stats, actions, costs_clean)

    return step


def solve(solver, family, state, f: Callable, generator, n_samples: int,
          n_iters: int, callback=null_callback):
    """Host-driven optimization loop with callback/early-stop support.
    Returns (final state, stats stacked over the iterations)."""
    state = solver.reset(family, state)
    step = _one_iteration(solver, family, f, n_samples)
    trace = []
    for i in range(n_iters):
        state, (stats, actions, costs) = step(state, generator)
        trace.append(stats)
        if callback(i, f, actions, costs, state):
            break
    stacked = ({k: torch.stack([t[k] for t in trace]) for k in trace[0]}
               if trace else {})
    return state, stacked
