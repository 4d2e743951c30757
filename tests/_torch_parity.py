"""Shared helpers for the parity tests of the PyTorch port (test_torch_*.py).

Data crosses between the two packages as numpy arrays.  JAX random streams
cannot be reproduced in torch, so a parity test starts both sides from one
JAX-made state.
"""

import dataclasses

import numpy as np

B = 8
# Procedural terrain, as the flagship trained, without observation noise, so
# a stretch of steps without resets is deterministic on both sides.  The 8
# envs sit on terrain-type columns 0-7 (slopes, rough slopes, stairs), where
# these proportions give the same heights as the flagship's
# (0.1, 0.1, 0.35, 0.25, 0.2); they drop the discrete-obstacle family,
# whose trace costs the JAX side ~80 s of CPU compile per jitted function.
# test_torch_terrain.py holds every family, obstacles included.
ROUGH_PATCH = dict(
    terrain=dict(procedural=True, terrain_proportions=(0.1, 0.1, 0.35, 0.45)),
    noise=dict(add_noise=False))


def export_fields(obj) -> dict:
    """A flax struct as {field: np.ndarray}, nested structs as dicts."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (export_fields(v) if dataclasses.is_dataclass(v)
                       else np.asarray(v))
    return out


def jax_rough_env(num_envs: int = B):
    from pointfoot_tpu.utils.registry import task_registry

    return task_registry.make_env("pointfoot_rough", num_envs=num_envs,
                                  cfg_patch=ROUGH_PATCH)


def torch_rough_env(num_envs: int = B):
    from pointfoot_tpu_torch.utils.registry import make_env

    return make_env("pointfoot_rough", num_envs=num_envs, device="cpu",
                    cfg_patch=ROUGH_PATCH)
