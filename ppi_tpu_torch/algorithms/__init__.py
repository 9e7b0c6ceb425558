"""PPI solver registry and optimization loop."""

import dataclasses

from ppi_tpu_torch.algorithms.base import (
    Batch, mask_costs, null_callback, solve)
from ppi_tpu_torch.algorithms.solvers import Lbps, SolverBase

__all__ = ["Batch", "Lbps", "SolverBase", "mask_costs", "null_callback",
           "solve", "make_solver", "ALGORITHMS"]

ALGORITHMS = {"Lbps": Lbps}


def make_solver(name: str, **kwargs):
    """Build a solver by reference-compatible name, keeping only the
    hyperparameters the solver declares."""
    if name not in ALGORITHMS:
        raise ValueError(f"solver {name!r} is not ported yet (ROADMAP queue "
                         f"1 item 10); ported: {sorted(ALGORITHMS)}")
    cls = ALGORITHMS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in fields})
