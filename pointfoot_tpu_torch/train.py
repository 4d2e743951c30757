"""Training entry point (scripts/train.py of the JAX package).

    python -m pointfoot_tpu_torch.train --task pointfoot_rough \
        --override terrain.procedural=true
    python -m pointfoot_tpu_torch.train --device cpu --num_envs 8 \
        --max_iterations 2 --override terrain.procedural=true \
        --log_dir /tmp/pf_run
    python -m pointfoot_tpu_torch.train --resume --load_run \
        /tmp/pf_run/model_2.pt ...
    torchrun --nproc_per_node 4 -m pointfoot_tpu_torch.train --mesh auto \
        --num_envs 16384 ...

Runs on the GPU unless --device names another.  `--override` and
`--train_override` take GROUP.FIELD=VALUE (repeatable), VALUE parsed as a
Python literal (true/false too); they overlay the task's env and training
configs.  Without --log_dir the run logs under
logs/<experiment_name>/<date>; `run_config.jsonl` there gets one line a
launch, with the resolved configs.  `--resume` continues from --load_run (a
`model_<it>.pt`), or from the newest checkpoint of the newest run under
logs/<experiment_name>.

Under torchrun (WORLD_SIZE > 1) `--mesh auto`, the default, trains
data-parallel (parallel/mesh.py): each rank joins the process group (nccl
on the card, gloo with --device cpu), takes the card LOCAL_RANK and steps
its shard of the env batch; --num_envs is the global batch and must
divide by the world size.  Only rank 0 writes `run_config.jsonl`, the
logs and the checkpoints.  `--mesh none` trains one process alone.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import datetime
import json
import os
import sys
from dataclasses import replace

import torch.distributed as dist

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.parallel.mesh import init_distributed, make_mesh
from pointfoot_tpu_torch.utils.helpers import get_load_path
from pointfoot_tpu_torch.utils.registry import (get_cfgs, make_alg_runner,
                                                make_env)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="pointfoot_tpu_torch trainer")
    p.add_argument("--task", default="pointfoot_rough")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--load_run", default=None,
                   help="checkpoint file to resume from (default: latest)")
    p.add_argument("--override", action="append", default=[],
                   metavar="GROUP.FIELD=VALUE",
                   help="env-config override, repeatable: e.g. "
                        "--override terrain.procedural=true")
    p.add_argument("--train_override", action="append", default=[],
                   metavar="GROUP.FIELD=VALUE",
                   help="train-config override, repeatable: e.g. "
                        "--train_override algorithm.max_lr=2.5e-4")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.add_argument("--mesh", default="auto", choices=["auto", "none"],
                   help="'auto': data-parallel over the ranks of torchrun "
                        "(WORLD_SIZE > 1); 'none': this process alone")
    return p.parse_args(argv)


def parse_override(ov: str, flag: str):
    path, _, raw = ov.partition("=")
    group, _, field = path.partition(".")
    if not (group and field and raw):
        raise SystemExit(f"bad {flag} {ov!r}: want GROUP.FIELD=VALUE")
    try:
        val = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        val = {"true": True, "false": False}.get(raw.lower(), raw)
    return group, field, val


def start_mesh(args, num_envs: int):
    """The data-parallel mesh of a torchrun launch under `--mesh auto`, or
    None.  Refuses a global batch that does not divide by the world size
    before any process group starts."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh == "none" or world <= 1:
        return None
    if num_envs % world:
        raise SystemExit(f"--num_envs {num_envs} does not divide over "
                         f"{world} ranks")
    backend = "nccl" if resolve_device(args.device).type == "cuda" \
        else "gloo"
    init_distributed(backend)
    return make_mesh(args.device)


def main(argv=None):
    args = get_args(argv)
    cfg_patch = {}
    for ov in args.override:
        group, field, val = parse_override(ov, "--override")
        cfg_patch.setdefault(group, {})[field] = val
    env_cfg, train_cfg = get_cfgs(args.task)
    mesh = start_mesh(args, args.num_envs or env_cfg.env.num_envs)
    try:
        return _train(args, cfg_patch, train_cfg, mesh, argv)
    finally:
        if mesh is not None and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg_patch, train_cfg, mesh, argv):
    env = make_env(args.task, num_envs=args.num_envs,
                   device=args.device if mesh is None else mesh.device,
                   cfg_patch=cfg_patch or None)
    for ov in args.train_override:
        group, field, val = parse_override(ov, "--train_override")
        train_cfg = replace(train_cfg, **{group: replace(
            getattr(train_cfg, group), **{field: val})})
    if args.max_iterations is not None:
        train_cfg = replace(train_cfg, runner=replace(
            train_cfg.runner, max_iterations=args.max_iterations))
    log_dir = args.log_dir or os.path.join(
        "logs", train_cfg.runner.experiment_name,
        datetime.datetime.now().strftime("%b%d_%H-%M-%S"))
    runner = make_alg_runner(env, args.task, log_dir=log_dir,
                             train_cfg=train_cfg, mesh=mesh)
    seed = args.seed if args.seed is not None else train_cfg.seed
    iters = train_cfg.runner.max_iterations

    env_state = None
    if args.resume:
        path = args.load_run or get_load_path(
            os.path.join("logs", train_cfg.runner.experiment_name))
        env_state = runner.load(path, runner.init(seed))
        if runner.is_main:
            print(f"resumed from {path} @ iteration "
                  f"{runner.current_iteration}")

    ranks = 1 if mesh is None else mesh.world_size
    if runner.is_main:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "run_config.jsonl"), "a") as f:
            f.write(json.dumps({
                "argv": sys.argv[1:] if argv is None else list(argv),
                "task": args.task, "num_envs": env.global_num_envs,
                "ranks": ranks, "iters": iters, "seed": int(seed),
                "env_cfg": dataclasses.asdict(env.cfg),
                "train_cfg": dataclasses.asdict(train_cfg),
            }, default=str) + "\n")
        print(f"task={args.task} envs={env.global_num_envs} ranks={ranks} "
              f"iters={iters} device={env.device} log_dir={log_dir}",
              flush=True)
    runner.learn(iters, seed=seed, env_state=env_state,
                 log_every=args.log_every)
    return runner


if __name__ == "__main__":
    main()
