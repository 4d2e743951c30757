"""Roll a trained policy and print falls and mean forward velocity.

    python -m pointfoot_tpu_torch.play --num_envs 4096 --steps 500
    python -m pointfoot_tpu_torch.play --device cpu --num_envs 8 --steps 50

Runs on the GPU unless --device names another.  The flagship
pointfoot_rough actor on procedural terrain; defaults: level 0, command vx
0.4 m/s.
"""

from __future__ import annotations

import argparse
import json

from pointfoot_tpu_torch.utils import policy_eval


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    task = "pointfoot_rough"
    env = policy_eval.make_eval_env(task, args.num_envs,
                                    policy_eval.FLAGSHIP_PATCH, args.device)
    policy = policy_eval.inference_policy(policy_eval.load_actor(env, task))
    rec = policy_eval.eval_config(env, policy, args.level, args.vx,
                                  secs=args.steps * env.dt)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
