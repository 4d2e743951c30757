"""Policy evaluation: falls and velocity tracking at one configuration
(pointfoot_tpu/utils/policy_eval.py).

`falls` counts terminations summed over all steps (an env can fall and
auto-reset repeatedly), so it is a relative gait-health metric; the
per-episode form is `falls_per_episode`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.rl.networks import ActorCritic
from pointfoot_tpu_torch.utils.convert import actor_critic_state_dict
from pointfoot_tpu_torch.utils.registry import get_cfgs, make_env

# actor + log_std of logs/pointfoot_rough/tpu_r4_storm/model_234000, the
# flagship rough policy (trained at 4096 envs on procedural terrain)
FLAGSHIP_ACTOR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_weights", "pointfoot_rough_model_234000_actor.npz")
# the configuration the flagship trained on
FLAGSHIP_PATCH = dict(terrain=dict(procedural=True))


def make_eval_env(task: str, num_envs: int,
                  cfg_patch: Optional[dict] = None, device=None):
    """Env with evaluation overrides: observation noise and pushes off."""
    patch = dict(noise=dict(add_noise=False),
                 domain_rand=dict(push_robots=False))
    for k, v in (cfg_patch or {}).items():
        patch.setdefault(k, {}).update(v)
    return make_env(task, num_envs=num_envs, device=device, cfg_patch=patch)


def load_actor(env, task: str, path: str = FLAGSHIP_ACTOR) -> ActorCritic:
    """ActorCritic of `task` on the env's device with the actor and log_std
    from an npz of flax-named arrays; the critic keeps its initial values."""
    p = get_cfgs(task)[1].policy
    net = ActorCritic(env.num_obs, env.num_privileged_obs or env.num_obs,
                      env.num_actions, p.actor_hidden_dims,
                      p.critic_hidden_dims, p.activation, p.init_noise_std)
    with np.load(path) as f:
        sd = actor_critic_state_dict({k: f[k] for k in f.files})
    missing, unexpected = net.load_state_dict(sd, strict=False)
    if unexpected or any(not k.startswith("critic.") for k in missing):
        raise KeyError(f"{path}: missing {missing}, unexpected {unexpected}")
    return net.to(env.device).eval()


def inference_policy(net: ActorCritic) -> Callable:
    """Deterministic policy obs -> action mean."""
    @torch.inference_mode()
    def policy(obs):
        return net.act_mean(obs)

    return policy


def eval_config(env, policy, level, vx_cmd, wz_cmd=0.0, secs=10.0,
                seed: int = 11) -> dict:
    """Roll `secs` of closed-loop control at one (level, command); returns
    falls and the mean base-frame velocities after a 50-step transient."""
    num_envs = env.num_envs
    steps = int(secs / env.dt)
    state = env.init_state(seed)
    if level is not None:
        lv = torch.full((num_envs,), level, dtype=torch.int64,
                        device=env.device)
        origin = env.terrain.env_origins[lv, state.terrain_type]
        state = state.replace(
            terrain_level=lv, env_origin=origin,
            physics=dataclasses.replace(
                state.physics,
                base_pos=origin + origin.new_tensor(env.cfg.init_state.pos)))
    cmd = [vx_cmd, 0.0, wz_cmd]
    state = env.update_cmd(state, cmd)
    state, out = env.step(state, torch.zeros(num_envs, env.num_actions,
                                             device=env.device))
    obs = out.obs
    falls = torch.zeros((), dtype=torch.int64, device=env.device)
    episodes = torch.zeros_like(falls)
    vx_sum = torch.zeros((), dtype=torch.float64, device=env.device)
    wz_sum = torch.zeros_like(vx_sum)
    n_vel = 0
    done_now = torch.zeros(num_envs, dtype=torch.bool, device=env.device)
    skip = min(50, steps // 4)
    for t in range(steps):
        state, out = env.step(state, policy(obs))
        state = env.update_cmd(state, cmd)
        obs = out.obs
        falls += out.extras["terminate"].sum()
        done_now = out.done
        episodes += done_now.sum()
        if t >= skip:
            q = state.physics.base_quat
            vb = quat_ops.rotate_inverse(q, state.physics.base_lin_vel)
            wb = quat_ops.rotate_inverse(q, state.physics.base_ang_vel)
            vx_sum += vb[:, 0].double().sum()
            wz_sum += wb[:, 2].double().sum()
            n_vel += num_envs
    # an env whose last step did not end an episode has one still in flight
    total_episodes = int(episodes) + num_envs - int(done_now.sum())
    falls = int(falls)
    return {
        "level": level, "cmd_vx": float(vx_cmd), "falls": falls,
        "envs": num_envs, "secs": float(secs),
        "episodes": total_episodes,
        "falls_per_episode": round(falls / max(total_episodes, 1), 4),
        "mean_vx": round(float(vx_sum) / max(n_vel, 1), 3),
        "cmd_wz": float(wz_cmd),
        "mean_wz": round(float(wz_sum) / max(n_vel, 1), 3),
    }
