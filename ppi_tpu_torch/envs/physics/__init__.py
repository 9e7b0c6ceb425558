"""Articulated rigid-body physics: the model, the scalar program and the
rollout kernel."""

from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ArticulatedModel, ModelBuilder, PhysicsState)

__all__ = ["HINGE", "SLIDE", "ArticulatedModel", "ModelBuilder",
           "PhysicsState"]
