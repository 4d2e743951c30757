"""Batched articulated rigid-body physics (pointfoot_tpu/physics/)."""

from pointfoot_tpu_torch.physics.model import (PhysicsParams, PhysicsState,
                                               RobotModel)
from pointfoot_tpu_torch.physics.urdf import load_urdf

__all__ = ["RobotModel", "PhysicsParams", "PhysicsState", "load_urdf"]
