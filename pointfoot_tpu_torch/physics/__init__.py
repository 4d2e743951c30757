"""Batched articulated rigid-body physics (pointfoot_tpu/physics/).

The JAX package also exports `load_urdf` (physics/urdf.py), which the port
has not ported yet.
"""

from pointfoot_tpu_torch.physics.model import (PhysicsParams, PhysicsState,
                                               RobotModel)

__all__ = ["RobotModel", "PhysicsParams", "PhysicsState"]
