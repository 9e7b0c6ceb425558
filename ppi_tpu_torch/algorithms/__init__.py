"""PPI solver registry and optimization loop."""

import dataclasses

from ppi_tpu_torch.algorithms.base import (
    Batch, mask_costs, null_callback, solve)
from ppi_tpu_torch.algorithms.solvers import (
    Ais, Cem, Essps, ICem, Lbps, More, Mppi, MppiBase, MppiUpdateCovariance,
    Reps, SolverBase)

__all__ = [
    "Ais", "Cem", "iCem", "Reps", "Lbps", "More", "Essps", "Mppi",
    "MppiBase", "MppiUpdateCovariance", "SolverBase", "Batch", "mask_costs",
    "null_callback", "solve", "make_solver", "ALGORITHMS",
]

# the reference's names
iCem = ICem

ALGORITHMS = {
    "Ais": Ais,
    "Cem": Cem,
    "iCem": ICem,
    "Reps": Reps,
    "Lbps": Lbps,
    "More": More,
    "Essps": Essps,
    "Mppi": Mppi,
    "MppiUpdateCovariance": MppiUpdateCovariance,
}


def make_solver(name: str, **kwargs):
    """Build a solver by reference-compatible name, keeping only the
    hyperparameters the solver declares."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown solver {name!r}; known: "
                         f"{sorted(ALGORITHMS)}")
    cls = ALGORITHMS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in fields})
