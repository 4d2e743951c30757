"""Carry weights and state over from the JAX package, as numpy arrays.

- `actor_critic_state_dict`: flax ActorCritic parameters -> the state dict
  of rl/networks.ActorCritic.  A flax Dense kernel is (in, out); a torch
  Linear weight is (out, in), so it goes over transposed.
- `physics_state_from_numpy` / `env_state_from_numpy`: a JAX PhysicsState or
  EnvState exported field by field with `np.asarray` -> torch states, the
  actuator-network carry included.  The JAX key has no counterpart and is
  ignored.
- `srb_problem_from_numpy`: the eight arrays of a batch of SRB-LQR problems
  (mpc/srb.srb_problem: F, c_tot, L, Xd, Ud, XTd, x0, f_ff) -> tensors.

The actuator network's weights need no conversion: physics/actuator.py
reads its own byte-identical copy of the baked JSON the JAX package reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from pointfoot_tpu_torch.envs.legged_env import EnvState
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def actor_critic_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """Map `actor/Dense_i/{kernel,bias}`, `critic/Dense_i/...` and `log_std`
    (nested dicts, optionally under "params", or flat "a/b/c" keys) onto
    `actor.{2i}.{weight,bias}`, `critic.{2i}...` and `log_std`."""
    flat = _flatten(flax_params)
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts == ["log_std"]:
            out["log_std"] = torch.from_numpy(np.array(arr, np.float32))
            continue
        net, dense, leaf = parts
        i = int(dense.split("_")[1])
        if leaf == "kernel":
            out[f"{net}.{2 * i}.weight"] = torch.from_numpy(
                np.array(np.asarray(arr, np.float32).T, order="C"))
        elif leaf == "bias":
            out[f"{net}.{2 * i}.bias"] = torch.from_numpy(
                np.array(arr, np.float32))
        else:
            raise KeyError(f"unexpected flax parameter {key}")
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _dataclass_from(cls, d: Mapping, device):
    return cls(**{f.name: _tensor(d[f.name], device)
                  for f in dataclasses.fields(cls)})


def physics_state_from_numpy(d: Mapping, device="cpu") -> PhysicsState:
    return _dataclass_from(PhysicsState, d, device)


def physics_params_from_numpy(d: Mapping, device="cpu") -> PhysicsParams:
    return _dataclass_from(PhysicsParams, d, device)


def srb_problem_from_numpy(arrays, device="cpu"):
    """The (F, c_tot, L, Xd, Ud, XTd, x0, f_ff) arrays of mpc/srb.srb_problem,
    each with the scenarios leading, as float32 tensors on `device`."""
    arrays = tuple(arrays)
    if len(arrays) != 8:
        raise ValueError(f"an SRB problem has 8 arrays, got {len(arrays)}")
    return tuple(_tensor(a, device) for a in arrays)


def env_state_from_numpy(d: Mapping, device="cpu") -> EnvState:
    """`d` maps EnvState field names to arrays; `physics` and `params` map
    their own field names to arrays."""
    fields = {}
    for f in dataclasses.fields(EnvState):
        if f.name == "physics":
            fields[f.name] = physics_state_from_numpy(d["physics"], device)
        elif f.name == "params":
            fields[f.name] = physics_params_from_numpy(d["params"], device)
        else:
            fields[f.name] = _tensor(d[f.name], device)
    return EnvState(**fields)
