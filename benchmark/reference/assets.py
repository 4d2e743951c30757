"""The robot model from its baked JSON, a frozen copy kept under
`assets/` (the port's physics/_assets/<name>.json as this benchmark was
written), loaded as the port's physics/assets.py loads it."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.reference.model import RobotModel

ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

_META = ("nb", "parent", "body_names", "joint_names", "collision_body",
         "collision_names")
_ARRAYS = ("joint_pos", "joint_rot", "joint_axis", "q_lower", "q_upper",
           "effort_limit", "velocity_limit", "joint_damping",
           "joint_friction", "mass", "com", "inertia", "collision_offset",
           "collision_radius")


def model_from_dict(d: Dict) -> RobotModel:
    """A model with float32 tensors on the CPU from `model_to_dict`'s
    form."""
    return RobotModel(
        nb=int(d["nb"]),
        parent=tuple(int(x) for x in d["parent"]),
        body_names=tuple(d["body_names"]),
        joint_names=tuple(d["joint_names"]),
        collision_body=tuple(int(x) for x in d["collision_body"]),
        collision_names=tuple(d["collision_names"]),
        **{k: torch.from_numpy(np.array(d[k], np.float32)) for k in _ARRAYS},
    )


def get_model(name: str) -> RobotModel:
    """The baked model `name` with float32 tensors on the CPU."""
    with open(os.path.join(ASSET_DIR, f"{name}.json")) as f:
        return model_from_dict(json.load(f))
