"""Baked robot models (pointfoot_tpu/physics/assets.py).

The URDF compiler (physics/urdf.py) runs offline; its output for each
supported robot is stored as JSON under `_assets/`, the package's own
copy of the JAX package's files, written by `python -m
pointfoot_tpu_torch.bake_assets`.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List

import numpy as np
import torch

from pointfoot_tpu_torch.physics.model import RobotModel

ASSET_DIR = os.path.join(os.path.dirname(__file__), "_assets")

_META = ("nb", "parent", "body_names", "joint_names", "collision_body",
         "collision_names")
_ARRAYS = ("joint_pos", "joint_rot", "joint_axis", "q_lower", "q_upper",
           "effort_limit", "velocity_limit", "joint_damping",
           "joint_friction", "mass", "com", "inertia", "collision_offset",
           "collision_radius")


def model_to_dict(model: RobotModel) -> Dict:
    """The JSON-ready dict of a model: its tree as lists, its arrays as
    nested lists of floats."""
    d = {}
    for k in _META:
        v = getattr(model, k)
        d[k] = list(v) if isinstance(v, tuple) else v
    for k in _ARRAYS:
        d[k] = getattr(model, k).cpu().numpy().tolist()
    return d


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


def save_model(model: RobotModel, name: str,
               asset_dir: str = ASSET_DIR) -> str:
    """Write `<asset_dir>/<name>.json`; returns its path."""
    os.makedirs(asset_dir, exist_ok=True)
    path = os.path.join(asset_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(model_to_dict(model), f)
    return path


@lru_cache(maxsize=None)
def get_model(name: str) -> RobotModel:
    """The baked model `name` with float32 tensors on the CPU."""
    path = os.path.join(ASSET_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no baked model '{name}' in {ASSET_DIR} "
                                f"(available: {available_models()})")
    with open(path) as f:
        return model_from_dict(json.load(f))


def available_models() -> List[str]:
    """Names of the baked robot models (the actuator networks' files
    excluded)."""
    if not os.path.isdir(ASSET_DIR):
        return []
    return sorted(p[:-5] for p in os.listdir(ASSET_DIR)
                  if p.endswith(".json") and not p.startswith("actuator"))
