"""Hunt catapult events: bases that fly under training conditions
(scripts/catapult_hunt.py of the JAX package).

    python -m pointfoot_tpu_torch.catapult_hunt \
        --load_run pointfoot_tpu_torch/_weights/pointfoot_flat_model_82000_actor.npz
    python -m pointfoot_tpu_torch.catapult_hunt --load_run RUN/model_500.pt \
        --envs 4096 --steps 3000
    python -m pointfoot_tpu_torch.catapult_hunt --load_run ... \
        --device cpu --envs 16 --steps 20

Rolls --task (default pointfoot_flat) with its registered config:
observation noise, domain randomization and pushes on, as in training,
and Gaussian exploration of --explore_std added to the policy's mean
action (drawn by torch's generator from seed 42; the env's state from
seed 3).  The first step where some env has its base above --z_hi m or
|vz| above --vz_hi m/s is dumped for the first such env: its state before
and after the step (height, vertical and total speeds, joint positions
and velocities, contact normal forces), the queued push, the joint
limits, its kp, kd, friction, added mass and CoM, contact stiffness and
damping and its episode step, and the state two steps back.  As in the
JAX script, an event at step 0 is dumped without ending the hunt; the
first later one ends it.  Without an event it prints "no catapult events
detected".

--load_run takes the port's `model_<it>.pt` or an actor npz of
flax-named arrays (the committed `_weights/*.npz`).  At 4096 envs on the
card a plane-terrain step runs the fused rollout (kernel 1, four launches
a step).  Runs on the GPU unless --device names another.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.utils import policy_eval
from pointfoot_tpu_torch.utils.registry import make_env


def _row(p, e: int, name: str) -> dict:
    """Print env e's physics state (one JAX `row`) and return it."""
    r = dict(z=float(p.base_pos[e, 2]), vz=float(p.base_lin_vel[e, 2]),
             v=float(torch.linalg.vector_norm(p.base_lin_vel[e])),
             w=float(torch.linalg.vector_norm(p.base_ang_vel[e])),
             qpos=p.qpos[e].cpu().numpy(), qvel=p.qvel[e].cpu().numpy(),
             fz=p.contact_force[e, :, 2].cpu().numpy())
    print(f"  {name}: z={r['z']:+.3f} vz={r['vz']:+.2f} |v|={r['v']:.2f} "
          f"|w|={r['w']:.2f}")
    print(f"    qpos={r['qpos'].round(2)}")
    print(f"    qvel={r['qvel'].round(1)}")
    print(f"    fz={r['fz'].round(0)}")
    return r


def _dump(env, state, new_state, prev, t: int, e: int, count: int) -> dict:
    print(f"[t={t}] env {e} flew ({count} total this step)")
    ev = {"t": t, "env": e, "count": count,
          "before": _row(state.physics, e, "before"),
          "after": _row(new_state.physics, e, "after ")}
    par = state.params
    ev.update(
        push=state.push_force[e].cpu().numpy(),
        q_lower=env.model.q_lower.cpu().numpy(),
        q_upper=env.model.q_upper.cpu().numpy(),
        kp=par.kp[e].cpu().numpy(), kd=par.kd[e].cpu().numpy(),
        friction=par.friction[e].cpu().numpy(),
        added_mass=float(par.added_mass[e]),
        com=par.com_offset[e].cpu().numpy(),
        k_c=float(par.contact_stiffness[e]),
        d_c=float(par.contact_damping[e]),
        ep_step=int(state.episode_step[e]))
    print(f"    push={ev['push'].round(1)}")
    print(f"    limits lo={ev['q_lower'].round(2)}")
    print(f"           hi={ev['q_upper'].round(2)}")
    print(f"    kp={ev['kp'].round(1)}")
    print(f"    kd={ev['kd'].round(2)}")
    print(f"    friction={ev['friction'].round(2)}")
    print(f"    added_mass={ev['added_mass']:.2f} com={ev['com'].round(3)}")
    print(f"    k_c={ev['k_c']:.0f} d_c={ev['d_c']:.0f}")
    print(f"    ep_step={ev['ep_step']}")
    if prev is not None:
        print("  two steps back:")
        ev["t-2"] = _row(prev, e, "t-2   ")
    return ev


def main(argv=None) -> dict:
    """Prints the hunt; returns {"events": [one dict an event dumped],
    "steps": steps taken}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="pointfoot_flat")
    ap.add_argument("--load_run", required=True)
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--explore_std", type=float, default=0.6)
    ap.add_argument("--z_hi", type=float, default=1.5)
    ap.add_argument("--vz_hi", type=float, default=4.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    env = make_env(args.task, num_envs=args.envs, device=dev)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(env, args.task, args.load_run))
    gen = torch.Generator(device=dev).manual_seed(42)
    events, steps = [], 0
    with torch.no_grad():
        state = env.init_state(3)
        state, out = env.step(state, torch.zeros(
            args.envs, env.num_actions, device=dev))
        obs = out.obs
        prev = None
        for t in range(args.steps):
            a = policy(obs) + args.explore_std * torch.randn(
                args.envs, env.num_actions, generator=gen, device=dev)
            new_state, out = env.step(state, a)
            obs = out.obs
            steps = t + 1
            z = new_state.physics.base_pos[:, 2]
            vz = new_state.physics.base_lin_vel[:, 2]
            bad = torch.nonzero((z > args.z_hi) | (vz.abs() > args.vz_hi)
                                ).flatten().cpu().numpy()
            if len(bad):
                events.append(_dump(env, state, new_state, prev, t,
                                    int(bad[0]), len(bad)))
                if t > 0:
                    break
            prev = state.physics
            state = new_state
        else:
            print("no catapult events detected")
    return {"events": events, "steps": steps}


if __name__ == "__main__":
    main()
