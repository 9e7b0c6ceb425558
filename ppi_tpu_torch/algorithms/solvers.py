"""PPI solvers: LBPS.

Port of ``SolverBase`` and ``Lbps`` from ``ppi_tpu/algorithms/solvers.py``.
Temperature methods use log w = -alpha * normalized costs, plus the -inf
mask of invalid lanes. The other solvers are ROADMAP queue 1 item 10.
"""

import dataclasses
import math
from typing import Tuple

import torch

from ppi_tpu_torch.algorithms.base import Batch, minmax_normalize
from ppi_tpu_torch.ops.scalar_opt import ALPHA_LOWER, ALPHA_UPPER, grid_zoom_min


@dataclasses.dataclass(frozen=True)
class SolverBase:
    """Default no-op reset; subclasses override update()."""

    def reset(self, family, state):
        return state

    def update(self, family, state, batch: Batch) -> Tuple:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Lbps(SolverBase):
    """Lower-bound policy search ("SNISLB"): pick the temperature minimizing
    the SNIS concentration bound E_w[c] + lambda / sqrt(ESS) with
    lambda = sqrt((1-delta)/delta)."""

    delta: float = 0.9

    name = "SNISLB"

    def update(self, family, state, batch: Batch):
        costs_n = minmax_normalize(batch.costs, batch.valid)
        lam = math.sqrt((1.0 - self.delta) / self.delta)

        def lower_bound(alpha):  # (n_candidates,) -> (n_candidates,)
            log_w = -alpha[:, None] * costs_n[None, :] + batch.log_valid
            log_nw = log_w - torch.logsumexp(log_w, dim=1, keepdim=True)
            nw = torch.exp(log_nw)
            ess = torch.exp(-torch.logsumexp(2.0 * log_nw, dim=1))
            expected_cost = torch.sum(nw * costs_n[None, :], dim=1)
            return expected_cost + lam / torch.sqrt(ess)

        alpha = grid_zoom_min(lower_bound, ALPHA_LOWER, ALPHA_UPPER,
                              device=costs_n.device)
        log_w = -alpha * costs_n + batch.log_valid
        state, ess, kl = family.weighted_update(state, log_w, batch.params)
        return state, {"ess": ess, "kl": kl, "alpha": alpha}
