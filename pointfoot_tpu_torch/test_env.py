"""Smoke run of a registered task (scripts/test_env.py of the JAX package).

    python -m pointfoot_tpu_torch.test_env --task pointfoot_rough
    python -m pointfoot_tpu_torch.test_env --task anymal_c_flat \
        --episodes 0.05 --device cpu

Builds the task with its registered config at min(10, 4096) envs, steps
zero actions for --episodes x the episode length (default 10), checks that
every reward is finite and prints "Done".  Runs on the GPU unless --device
names another.
"""

from __future__ import annotations

import argparse

import torch

from pointfoot_tpu_torch.utils.registry import make_env


def main(argv=None) -> int:
    """Returns the number of steps taken."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="pointfoot_rough")
    p.add_argument("--episodes", type=float, default=10.0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    env = make_env(args.task, num_envs=min(10, 4096), device=args.device)
    state = env.init_state(0)
    zeros = torch.zeros(env.num_envs, env.num_actions, device=env.device)
    steps = int(args.episodes * env.max_episode_length)
    finite = torch.ones((), dtype=torch.bool, device=env.device)
    with torch.no_grad():
        for _ in range(steps):
            state, out = env.step(state, zeros)
            finite &= torch.isfinite(out.reward).all()
    if not bool(finite):
        raise RuntimeError(f"{args.task}: non-finite rewards")
    print("Done")
    return steps


if __name__ == "__main__":
    main()
