"""Roll a trained policy: falls and mean forward velocity, robot 0's state
in the dashboard logger, episode rewards (scripts/play.py of the JAX
package).

    python -m pointfoot_tpu_torch.play --num_envs 4096 --steps 500
    python -m pointfoot_tpu_torch.play --task pointfoot_flat --num_envs 50 \
        --cmd 0.5 0 0 --dashboard play_dashboard.png
    python -m pointfoot_tpu_torch.play --task pointfoot_rough \
        --load_run logs/pointfoot_rough/<run>/model_1500.pt --export
    python -m pointfoot_tpu_torch.play --device cpu --num_envs 8 --steps 50

Without --task it plays the flagship: pointfoot_rough on procedural
terrain (the configuration model_234000 trained on); a named task plays
its registered config.  The defaults are this CLI's own, kept from before
it took the JAX CLI's flags: 4096 envs (JAX: 50, of pointfoot_flat),
terrain level 0 and a command of --vx 0.4 m/s pinned on every env
(`--cmd VX VY WZ` pins another); plane terrain has no levels.  The JAX
CLI's evaluation overrides apply: observation noise, pushes, the terrain
curriculum and the friction, mass and CoM randomization off, and at most
the config's env count.

`--load_run` takes the port's `model_<it>.pt` or an actor npz of
flax-named arrays (the committed `_weights/*.npz`); without it, the newest
checkpoint of the newest run under logs/<experiment_name>, else the task's
committed actor.  `--export` writes `policy.onnx` and `policy_1.pt` into
`exported/` beside the checkpoint.  Prints one JSON line (falls, episodes,
mean base-frame vx and wz after a 50-step transient) and the logger's
average episode rewards; `--dashboard PATH` renders the 3x3 dashboard of
robot 0's joint 1 and base state to a PNG (matplotlib).  Runs on the GPU
unless --device names another.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import torch

from pointfoot_tpu_torch.export import onnx
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.utils import policy_eval
from pointfoot_tpu_torch.utils.helpers import get_load_path
from pointfoot_tpu_torch.utils.logger import Logger
from pointfoot_tpu_torch.utils.registry import get_cfgs

FLAGSHIP_TASK = "pointfoot_rough"
# the JAX CLI's evaluation overrides, beyond make_eval_env's noise and
# pushes
EVAL_PATCH = dict(terrain=dict(curriculum=False),
                  domain_rand=dict(randomize_friction=False,
                                   randomize_base_mass=False,
                                   randomize_base_com=False))
ROBOT, JOINT = 0, 1  # the logged env and joint


def default_checkpoint(experiment: str) -> Optional[str]:
    """The newest `model_<it>.pt` of the newest run under
    logs/<experiment>, or None when there is none."""
    try:
        return get_load_path(os.path.join("logs", experiment))
    except FileNotFoundError:
        return None


def _log_step(env, logger: Logger, action_scale: float):
    """The per-step hook that logs robot 0's joint 1 and base state, and
    the episode rewards when envs reset."""
    feet = list(env.feet_idx)

    def log(state, out, action):
        phys = state.physics
        q = phys.base_quat[ROBOT:ROBOT + 1]
        v = quat_ops.rotate_inverse(q, phys.base_lin_vel[ROBOT:ROBOT + 1])[0]
        w = quat_ops.rotate_inverse(q, phys.base_ang_vel[ROBOT:ROBOT + 1])[0]
        row = torch.cat([
            torch.stack([action[ROBOT, JOINT] * action_scale,
                         phys.qpos[ROBOT, JOINT], phys.qvel[ROBOT, JOINT],
                         state.torques[ROBOT, JOINT]]),
            state.commands[ROBOT, :3], v, w[2:3],
            phys.contact_force[ROBOT, feet, 2],
            out.extras["num_resets"].to(v.dtype)[None]]).cpu()
        logger.log_states({
            "dof_pos_target": float(row[0]), "dof_pos": float(row[1]),
            "dof_vel": float(row[2]), "dof_torque": float(row[3]),
            "command_x": float(row[4]), "command_y": float(row[5]),
            "command_yaw": float(row[6]), "base_vel_x": float(row[7]),
            "base_vel_y": float(row[8]), "base_vel_z": float(row[9]),
            "base_vel_yaw": float(row[10]),
            "contact_forces_z": row[11:11 + len(feet)].numpy(),
        })
        n_done = int(row[-1])
        if n_done > 0:
            ep = out.extras["episode_rew"].cpu()
            logger.log_rewards({f"rew_{n}": v for n, v in
                                zip(env.reward_names, ep)}, n_done)

    return log


def run(task: Optional[str] = None, load_run: Optional[str] = None,
        num_envs: int = 4096, steps: int = 500, level: int = 0,
        vx: float = 0.4, cmd: Optional[Sequence[float]] = None,
        export: bool = False, device=None) -> Tuple[Logger, dict]:
    """Play the policy; returns (the logger, the JSON record)."""
    name = task or FLAGSHIP_TASK
    env_cfg, train_cfg = get_cfgs(name)
    patch = {k: dict(v) for k, v in EVAL_PATCH.items()}
    if task is None:
        patch["terrain"].update(policy_eval.FLAGSHIP_PATCH["terrain"])
    env = policy_eval.make_eval_env(name, min(num_envs, env_cfg.env.num_envs),
                                    patch, device)
    path = load_run or default_checkpoint(train_cfg.runner.experiment_name)
    net = policy_eval.load_actor(env, name, path)
    print(f"loaded {path or policy_eval.DEFAULT_ACTORS[name]}", flush=True)
    if export:
        out_dir = os.path.join(os.path.dirname(
            path or policy_eval.DEFAULT_ACTORS[name]), "exported")
        os.makedirs(out_dir, exist_ok=True)
        act = train_cfg.policy.activation
        onnx_path = onnx.export_policy_as_onnx(
            net, env.num_obs, os.path.join(out_dir, "policy.onnx"), act)
        ts_path = onnx.export_policy_torchscript(
            net, env.num_obs, os.path.join(out_dir, "policy_1.pt"), act)
        print(f"exported {onnx_path} and {ts_path}", flush=True)
    vx_c, vy_c, wz_c = (vx, 0.0, 0.0) if cmd is None else cmd
    logger = Logger(env.dt)
    record = policy_eval.eval_config(
        env, policy_eval.inference_policy(net),
        None if env.is_plane else level, vx_c, wz_c,
        secs=steps * env.dt, vy_cmd=vy_c,
        on_step=_log_step(env, logger, env_cfg.control.action_scale))
    return logger, record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default=None,
                    help="registered task (default: the flagship, "
                         "pointfoot_rough on procedural terrain)")
    ap.add_argument("--load_run", default=None,
                    help="model_<it>.pt or actor npz (default: the newest "
                         "checkpoint under logs/<experiment_name>, else "
                         "the task's committed actor)")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--cmd", type=float, nargs=3, default=None,
                    metavar=("VX", "VY", "WZ"),
                    help="pin this command instead of (--vx, 0, 0)")
    ap.add_argument("--export", action="store_true")
    ap.add_argument("--dashboard", default=None,
                    help="PNG path of the dashboard (default: none drawn)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    logger, rec = run(args.task, args.load_run, args.num_envs, args.steps,
                      args.level, args.vx, args.cmd, args.export,
                      args.device)
    print(json.dumps(rec), flush=True)
    logger.print_rewards()
    if args.dashboard:
        print(f"dashboard saved to {logger.plot_states(args.dashboard)}")
    return rec


if __name__ == "__main__":
    main()
