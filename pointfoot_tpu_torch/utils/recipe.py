"""A JAX-package run's random inputs, replayed under the port.

The JAX package draws from threefry streams that torch's generator cannot
reproduce.  Where a tool must start where a JAX script starts, that run's
random inputs are committed as an npz (`_weights/*_recipe.npz`), each key
under an optional prefix:

- `state/<field>` and `state/<field>/<subfield>`: the initial EnvState's
  arrays, as the JAX env's `init_state` made them;
- `reset_qpos_scale` (steps, B, nj) and `reset_vel` (steps, B, 6): for
  each env step, the draws its `_reset_envs` would make (the joint-position
  scale and the base velocities of an env that resets), keyed as the JAX
  step splits the state's key.

`Replay` starts an env from the recipe and steps it with those draws; past
the recipe's last step a reset draws from the env's own generator.  Plane
terrain only: a reset there draws nothing else that a pinned command does
not overwrite.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pointfoot_tpu_torch.utils import profiling
from pointfoot_tpu_torch.utils.convert import env_state_from_numpy


def load(path: str, prefix: str = ""):
    """(the initial EnvState's arrays as nested dicts, the reset draws
    {"qpos_scale": (steps, B, nj), "vel": (steps, B, 6)})."""
    state = {}
    with np.load(path) as f:
        for key in f.files:
            if not key.startswith(prefix + "state/"):
                continue
            parts = key[len(prefix):].split("/")
            node = state
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = f[key]
        draws = {"qpos_scale": f[prefix + "reset_qpos_scale"],
                 "vel": f[prefix + "reset_vel"]}
    return state, draws


class Replay:
    """`initial` is the recipe's EnvState on the env's device; `step` is
    `env.step` with the recipe's reset draws of the next step, through the
    step's eager body (`_step_eager`, in the span `env.step`): draws handed
    in from the host at every step cannot be replayed by a CUDA graph of
    the step (envs/step_graph.py).  `resets`, where given, gets one bool a
    step: whether any env reset in it."""

    def __init__(self, env, path: str, prefix: str = "",
                 resets: Optional[list] = None):
        arrays, self.draws = load(path, prefix)
        self.env, self.resets, self.t = env, resets, 0
        self.initial = env_state_from_numpy(arrays, env.device)

    def step(self, state, action):
        env, t = self.env, self.t
        self.t += 1
        if t >= len(self.draws["vel"]):
            return env.step(state, action)
        qpos_scale, vel = self.draws["qpos_scale"][t], self.draws["vel"][t]
        table = {(qpos_scale.shape, 0.5, 1.5): qpos_scale,
                 (vel.shape, -0.5, 0.5): vel}
        own_uniform, own_reset = env._uniform, env._reset_envs

        def uniform(shape, lo, hi):
            got = table.get((tuple(shape), float(lo), float(hi)))
            return (own_uniform(shape, lo, hi) if got is None
                    else torch.as_tensor(got, device=env.device))

        def reset_with_recipe_draws(st, done):
            if self.resets is not None:
                self.resets.append(bool(done.any()))
            env._uniform = uniform
            try:
                return own_reset(st, done)
            finally:
                env._uniform = own_uniform

        env._reset_envs = reset_with_recipe_draws
        try:
            with profiling.span("env.step"):
                return env._step_eager(state, action)
        finally:
            env._reset_envs = own_reset
