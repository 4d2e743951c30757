"""Evaluate a policy: falls and velocity tracking at each terrain level and
command (scripts/eval_policy.py of the JAX package).

    python -m pointfoot_tpu_torch.eval_policy --task pointfoot_flat \
        --vx 0.25 0.5 1.0
    python -m pointfoot_tpu_torch.eval_policy --task pointfoot_rough \
        --load_run pointfoot_tpu_torch/_weights/pointfoot_rough_model_100000_actor.npz \
        --levels 0 2 4 --vx 0.0 0.4 0.8
    python -m pointfoot_tpu_torch.eval_policy --task pointfoot_rough \
        --load_run logs/pointfoot_rough/<run>/model_1500.pt \
        --override terrain.procedural=true --device cpu --num_envs 8

For every (level, vx) configuration, `--num_envs` envs roll `--secs`
seconds with observation noise and pushes off, the command pinned; one JSON
line a configuration (falls, episodes, mean base-frame vx and wz), then one
with the total falls.  Plane terrain has no levels: it evaluates level
None only.  `--load_run` takes an actor npz of flax-named arrays (the
committed `_weights/*.npz`) or the port's `model_<it>.pt`; without it, the
task's committed actor.  `--override GROUP.FIELD=VALUE` (repeatable)
overlays the env config, as in train.py.  Runs on the GPU unless --device
names another.
"""

from __future__ import annotations

import argparse
import json

from pointfoot_tpu_torch.train import parse_override
from pointfoot_tpu_torch.utils import policy_eval


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="pointfoot_rough")
    ap.add_argument("--load_run", default=None,
                    help="actor npz or model_<it>.pt (default: the task's "
                         "committed actor)")
    ap.add_argument("--num_envs", type=int, default=16)
    ap.add_argument("--levels", type=int, nargs="*", default=[0, 2, 4])
    ap.add_argument("--vx", type=float, nargs="*", default=[0.0, 0.4, 0.8])
    ap.add_argument("--wz", type=float, default=0.0,
                    help="commanded yaw rate for every configuration")
    ap.add_argument("--secs", type=float, default=10.0)
    ap.add_argument("--override", action="append", default=[],
                    metavar="GROUP.FIELD=VALUE",
                    help="env-config override, repeatable: e.g. "
                         "--override terrain.procedural=true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    cfg_patch = {}
    for ov in args.override:
        group, field, val = parse_override(ov, "--override")
        cfg_patch.setdefault(group, {})[field] = val
    results = policy_eval.eval_checkpoint(
        args.task, args.load_run, args.levels, args.vx, args.num_envs,
        args.secs, args.wz, cfg_patch or None, args.device)
    for rec in results:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"total_falls": sum(r["falls"] for r in results),
                      "configs": len(results)}), flush=True)
    return results


if __name__ == "__main__":
    main()
