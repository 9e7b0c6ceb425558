"""Sample-axis scale-out over a ``torch.distributed`` process group."""

from ppi_tpu_torch.parallel.launch import spawn
from ppi_tpu_torch.parallel.mesh import (
    SAMPLE_AXIS, SLICE_AXIS, Mesh, gather_costs, make_mesh,
    make_multislice_mesh, shard_bounds, sharded_mpc_objective,
    sharded_objective)

__all__ = ["SAMPLE_AXIS", "SLICE_AXIS", "Mesh", "gather_costs", "make_mesh",
           "make_multislice_mesh", "shard_bounds", "sharded_mpc_objective",
           "sharded_objective", "spawn"]
