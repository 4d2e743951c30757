"""Checkpoint resolution and config bridging (pointfoot_tpu/utils/helpers.py).

The port's checkpoints are files, `model_<it>.pt`, where the JAX package's
are Orbax directories `model_<it>/`.
"""

from __future__ import annotations

import dataclasses
import os
import re


def get_load_path(root: str, load_run: str = "", checkpoint="") -> str:
    """The checkpoint to load: the run directory `load_run` under `root`
    (default: the last by sort order), and in it `model_<checkpoint>.pt`
    (default: the highest iteration)."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no runs in {root}")
    if load_run in ("", "-1", -1, None):
        runs = sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))
        if not runs:
            raise FileNotFoundError(f"no runs in {root}")
        load_run = runs[-1]
    run_dir = os.path.join(root, load_run)
    if checkpoint in ("", "-1", -1, None):
        models = [f for f in os.listdir(run_dir)
                  if re.fullmatch(r"model_\d+\.pt", f)]
        if not models:
            raise FileNotFoundError(f"no checkpoints in {run_dir}")
        models.sort(key=lambda f: int(f[len("model_"):-len(".pt")]))
        return os.path.join(run_dir, models[-1])
    return os.path.join(run_dir, f"model_{checkpoint}.pt")


def class_to_dict(obj) -> dict:
    """Dataclass -> nested dict; lists and tuples keep their type."""
    if dataclasses.is_dataclass(obj):
        return {f.name: class_to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(class_to_dict(x) for x in obj)
    return obj
