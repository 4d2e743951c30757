"""Trajectory simulation for sys-ID (pointfoot_tpu/sysid/simulate.py).

`simulate_trajectory` pins the proposed per-joint friction, added mass and
CoM offset and the command through the env's hooks, rolls the policy for
`warmup` discarded and `length` recorded steps in a python loop, and
returns the recorded observations and a fall flag.  It is differentiable
in the three parameters on the plain physics route (fewer than
MEGA_MIN_BATCH envs); run it under `torch.no_grad()` to let a batch of
4096 or more envs take the fused rollout kernel, whose wrapper refuses
inputs that carry a gradient.  As in JAX, the first action comes from zero
observations and `fell` gathers `terminate` over the warm-up too.
`chunk_windows` cuts a trajectory into overlapping windows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from pointfoot_tpu_torch.envs.legged_env import EnvState, LeggedEnv


class SimTrajectory(NamedTuple):
    obs: torch.Tensor  # (T, B, num_obs), the recorded steps
    fell: torch.Tensor  # (B,) bool: a contact termination occurred


def simulate_trajectory(
    env: LeggedEnv,
    state: EnvState,
    policy_fn: Callable[[torch.Tensor], torch.Tensor],
    friction, added_mass, com_offset, cmd,
    length: int = 1000,
    warmup: int = 150,
) -> Tuple[SimTrajectory, EnvState]:
    """Roll `warmup` discarded and `length` recorded steps with the
    parameters pinned; returns the trajectory and the final state."""
    state = env.update_frictions(state, friction)
    state = env.update_added_mass_and_base_com(state, added_mass, com_offset)
    state = env.update_cmd(state, cmd)
    B = env.num_envs
    obs = torch.zeros(B, env.num_obs, device=env.device)
    fell = torch.zeros(B, dtype=torch.bool, device=env.device)
    traj = []
    for t in range(warmup + length):
        state, out = env.step(state, policy_fn(obs))
        fell = fell | out.extras["terminate"]
        obs = out.obs
        if t >= warmup:
            traj.append(obs)
    return SimTrajectory(obs=torch.stack(traj), fell=fell), state


def chunk_windows(traj: torch.Tensor, chunk: int = 400, overlap: int = 100
                  ) -> torch.Tensor:
    """(T, B, D) -> (num_chunks * B, chunk, D), window-major, with stride
    chunk - overlap."""
    T = traj.shape[0]
    stride = chunk - overlap
    n = (T - overlap) // stride
    wins = torch.stack([traj[i * stride:i * stride + chunk]
                        for i in range(n)])  # (n, chunk, B, D)
    wins = wins.transpose(1, 2)  # (n, B, chunk, D)
    return wins.reshape((-1,) + tuple(wins.shape[2:]))
