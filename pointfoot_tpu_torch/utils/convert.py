"""Carry weights and state over from the JAX package, as numpy arrays.

- `actor_critic_state_dict`: flax ActorCritic or ActorCriticRecurrent
  parameters -> the state dict of rl/networks.ActorCritic or
  ActorCriticRecurrent.  A flax Dense kernel is (in, out); a torch Linear
  weight is (out, in), so it goes over transposed.  The LSTM cells keep
  flax's (in, out) layout: the four gate kernels of a group are
  concatenated in the order i, f, g, o.
- `physics_state_from_numpy` / `env_state_from_numpy`: a JAX PhysicsState or
  EnvState exported field by field with `np.asarray` -> torch states, the
  actuator-network carry included.  The JAX key has no counterpart and is
  ignored.
- `srb_problem_from_numpy`: the eight arrays of a batch of SRB-LQR problems
  (mpc/srb.srb_problem: F, c_tot, L, Xd, Ud, XTd, x0, f_ff) -> tensors.
- `gait_state_from_numpy` / `mpc_state_from_numpy`: a JAX GaitState
  (mpc/gait.py) or MPCState (mpc/controller.py) exported field by field ->
  the port's, so a controller can go on from a state the JAX one reached.
- `train_state_from_numpy`: a JAX TrainState (params, optax's Adam moments
  and count, learning rate, update count) of either network -> the state
  rl/ppo.PPO or RecurrentPPO loads, so a JAX checkpoint can be resumed by
  the port.  `flatten` turns what
  orbax restores into flat "a/b/c" keys, for an npz.

The actuator network's weights need no conversion: physics/actuator.py
reads its own byte-identical copy of the baked JSON the JAX package reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from pointfoot_tpu_torch.envs.legged_env import EnvState
from pointfoot_tpu_torch.mpc.controller import MPCState
from pointfoot_tpu_torch.mpc.gait import GaitState
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mappings and sequences (orbax restores tuples as lists) ->
    {"a/b/0/c": array}; empty leaves (optax's EmptyState) are dropped."""
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    out = {}
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (Mapping, list, tuple)):
            out.update(flatten(v, key))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def _f32(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32, order="C"))


def actor_critic_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """Map `actor/Dense_i/{kernel,bias}`, `critic/Dense_i/...` and `log_std`
    (nested dicts, optionally under "params", or flat "a/b/c" keys) onto
    `actor.{2i}.{weight,bias}`, `critic.{2i}...` and `log_std`; for the
    recurrent network `actor_head/Dense_i/...` and `critic_head/...` onto
    `actor_head.{2i}...` and `critic_head...`, and the cells'
    `{actor,critic}_rnn/{ii,if,ig,io}/kernel` onto `<cell>.weight_i`,
    `{hi,hf,hg,ho}/kernel` onto `<cell>.weight_h` and their biases onto
    `<cell>.bias_h`.  A tree of Adam moments converts the same way."""
    flat = flatten(flax_params)
    out, cells = {}, {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts == ["log_std"]:
            out["log_std"] = _f32(arr)
            continue
        net, dense, leaf = parts
        if net.endswith("_rnn"):
            cells.setdefault(net, {})[f"{dense}/{leaf}"] = arr
            continue
        i = int(dense.split("_")[1])
        if leaf == "kernel":
            out[f"{net}.{2 * i}.weight"] = _f32(np.asarray(arr).T)
        elif leaf == "bias":
            out[f"{net}.{2 * i}.bias"] = _f32(arr)
        else:
            raise KeyError(f"unexpected flax parameter {key}")
    for net, p in cells.items():
        for name, group, leaf in (("weight_i", "i", "kernel"),
                                  ("weight_h", "h", "kernel"),
                                  ("bias_h", "h", "bias")):
            out[f"{net}.{name}"] = _f32(np.concatenate(
                [p[f"{group}{g}/{leaf}"] for g in "ifgo"], axis=-1))
    return out


def train_state_from_numpy(arrays: Mapping) -> dict:
    """The state `PPO.load_state_dict` takes, from the arrays of a JAX
    TrainState: nested as orbax restores it, or flat with "a/b/c" keys
    (`params/params/...`, `opt_state/2/{mu,nu}/params/...`,
    `opt_state/2/count`, `learning_rate`, `update_count`; index 2 of the
    optimizer chain is optax's scale_by_adam), of either network.  The Adam
    moments of a kernel are transposed or concatenated as the kernel is."""
    flat = flatten(arrays)

    def sub(prefix: str) -> Dict[str, np.ndarray]:
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    mu = actor_critic_state_dict(sub("opt_state/2/mu/"))
    nu = actor_critic_state_dict(sub("opt_state/2/nu/"))
    return {
        "params": actor_critic_state_dict(sub("params/")),
        "adam": {k: {"exp_avg": mu[k], "exp_avg_sq": nu[k]} for k in mu},
        "adam_step": int(flat["opt_state/2/count"]),
        "learning_rate": float(np.float32(flat["learning_rate"])),
        "update_count": int(flat["update_count"]),
    }


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


def _named_tuple_from(cls, d: Mapping, device):
    return cls(**{f: _tensor(d[f], device) for f in cls._fields})


def gait_state_from_numpy(d: Mapping, device="cpu") -> GaitState:
    """`d` maps GaitState field names (phase, liftoff_pos, target_pos,
    v_int, cmd_f, ground_z, t) to arrays with the scenarios leading."""
    return _named_tuple_from(GaitState, d, device)


def mpc_state_from_numpy(d: Mapping, device="cpu") -> MPCState:
    """`d` maps MPCState field names (us_warm, last_cost) to arrays."""
    return _named_tuple_from(MPCState, d, device)


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
