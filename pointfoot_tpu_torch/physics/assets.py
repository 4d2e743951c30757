"""Baked robot models (pointfoot_tpu/physics/assets.py).

Reads the package's own copy of the JSON the URDF compiler produced.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np
import torch

from pointfoot_tpu_torch.physics.model import RobotModel

ASSET_DIR = os.path.join(os.path.dirname(__file__), "_assets")

_ARRAYS = ("joint_pos", "joint_rot", "joint_axis", "q_lower", "q_upper",
           "effort_limit", "velocity_limit", "joint_damping",
           "joint_friction", "mass", "com", "inertia", "collision_offset",
           "collision_radius")


@lru_cache(maxsize=None)
def get_model(name: str) -> RobotModel:
    """The baked model `name` with float32 tensors on the CPU."""
    path = os.path.join(ASSET_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no baked model '{name}' in {ASSET_DIR}")
    with open(path) as f:
        d = json.load(f)
    return RobotModel(
        nb=int(d["nb"]),
        parent=tuple(int(x) for x in d["parent"]),
        body_names=tuple(d["body_names"]),
        joint_names=tuple(d["joint_names"]),
        collision_body=tuple(int(x) for x in d["collision_body"]),
        collision_names=tuple(d["collision_names"]),
        **{k: torch.from_numpy(np.array(d[k], np.float32)) for k in _ARRAYS},
    )
