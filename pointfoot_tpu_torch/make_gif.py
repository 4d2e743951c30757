"""Render a walking GIF: a trained policy rolling the env, or the gait-MPC
controller (scripts/make_gif.py of the JAX package).

    python -m pointfoot_tpu_torch.make_gif --mode policy \
        --task pointfoot_rough --out docs/walk_rough.gif
    python -m pointfoot_tpu_torch.make_gif --mode gait --vx 0.4 \
        --terrain wave:0.04 --out docs/walk_gait.gif
    python -m pointfoot_tpu_torch.make_gif --mode gait --device cpu \
        --steps 3 --out /tmp/g.gif

`--mode policy` rolls 4 envs of `--task` (observation noise and pushes
off, command (--vx, 0, 0) pinned) with the actor of `--load_run` (the
port's `model_<it>.pt` or an actor npz; without it, the newest checkpoint
under logs/<experiment_name>, else the task's committed actor) and draws
env 0 over the env's terrain.  `--mode gait` rolls one scenario of
`mpc.gait.make_controller(--robot)` on the analytic `--terrain`.  Every
`--every`-th 50 Hz-equivalent tick is a frame; frames come to the CPU one
at a time and utils/visualizer.render_rollout draws them (matplotlib,
Pillow).  The rollout runs on the GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.utils.visualizer import render_rollout


def first_row(obj):
    """Row 0 of a PhysicsState or PhysicsParams, on the CPU."""
    return type(obj)(**{f.name: getattr(obj, f.name)[:1].cpu()
                        for f in dataclasses.fields(obj)})


def gait_frames(args, dev):
    """(model, frames, params, terrain) of one gait-MPC scenario."""
    from pointfoot_tpu_torch.mpc.gait import heading_command, make_controller
    from pointfoot_tpu_torch.physics import dynamics
    from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
    from pointfoot_tpu_torch.terrain.analytic import (AnalyticTerrain,
                                                      make_terrain)

    hfn = make_terrain(args.terrain)
    on_terrain = args.terrain not in ("", "flat")
    stack = make_controller(args.robot, height_fn=hfn if on_terrain else None,
                            device=dev)
    ctrl, model = stack.ctrl, stack.ctrl.model
    params = PhysicsParams.nominal(model, 1, dev)
    phys = PhysicsState.default(model, stack.q0, 1, dev,
                                base_height=stack.z0)
    gait = ctrl.init(1, phys)
    cmd = torch.tensor([[args.vx, 0.0, args.wz]], device=dev)
    # `--every` is in 50 Hz-equivalent ticks, so the GIF's timing does not
    # depend on the robot's control rate
    ticks_per_50hz = max(1, round(0.02 / stack.ctrl_dt))
    every = args.every * ticks_per_50hz
    frames = []
    with torch.no_grad():
        for t in range(args.steps * ticks_per_50hz):
            c = cmd
            if args.heading is not None:
                c = heading_command(phys.base_quat, cmd[:, :2],
                                    torch.full((1,), args.heading,
                                               device=dev))
            tq, gait = ctrl.control(phys, c, gait)
            for _ in range(stack.substeps):
                phys = dynamics.step_batched(model, params, phys, tq, hfn,
                                             0.005)
            if t % every == 0:
                frames.append(first_row(phys))
    return (model, frames, first_row(params),
            AnalyticTerrain(hfn) if on_terrain else None)


def policy_frames(args, dev):
    """(model, frames, params, terrain) of env 0 under the policy."""
    from pointfoot_tpu_torch.play import default_checkpoint
    from pointfoot_tpu_torch.utils import policy_eval
    from pointfoot_tpu_torch.utils.registry import get_cfgs

    env = policy_eval.make_eval_env(args.task, 4, device=dev)
    tc = get_cfgs(args.task)[1]
    path = args.load_run or default_checkpoint(tc.runner.experiment_name)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(env, args.task, path))
    cmd = [args.vx, 0.0, 0.0]
    state = env.update_cmd(env.init_state(1), cmd)
    state, out = env.step(state, torch.zeros(env.num_envs, env.num_actions,
                                             device=dev))
    frames = []
    for t in range(args.steps):
        state, out = env.step(state, policy(out.obs))
        state = env.update_cmd(state, cmd)
        if t % args.every == 0:
            frames.append(first_row(state.physics))
    return env.model, frames, first_row(state.params), env.terrain


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["policy", "gait"], default="policy")
    ap.add_argument("--task", default="pointfoot_rough")
    ap.add_argument("--load_run", default=None)
    ap.add_argument("--out", default="docs/walk.gif")
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--wz", type=float, default=0.0)
    ap.add_argument("--heading", type=float, default=None)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--every", type=int, default=2,
                    help="render every Nth control tick")
    ap.add_argument("--terrain", type=str, default="flat",
                    help="gait mode: kind:amp analytic terrain "
                         "(terrain/analytic.py), e.g. wave:0.04")
    ap.add_argument("--robot", type=str, default="pointfoot",
                    help="gait mode: robot with a tuned stack "
                         "(pointfoot | a1 | anymal_b | anymal_c | cassie)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    frames_of = gait_frames if args.mode == "gait" else policy_frames
    model, frames, params, terrain = frames_of(args, dev)
    out = render_rollout(model, frames, params, args.out, terrain=terrain,
                         fps=max(1, 25 // args.every))
    print(f"wrote {out} ({len(frames)} frames)")
    return out


if __name__ == "__main__":
    main()
