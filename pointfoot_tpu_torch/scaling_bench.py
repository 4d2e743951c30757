"""Data-parallel scaling of the env step (scripts/scaling_bench.py of the
JAX package).

    python -m pointfoot_tpu_torch.scaling_bench [--task pointfoot_rough] \
        [--envs_per_rank 4096] [--steps 20] [--max_ranks N]
    python -m pointfoot_tpu_torch.scaling_bench --share_device
    python -m pointfoot_tpu_torch.scaling_bench --device cpu \
        --envs_per_rank 4 --steps 2 --max_ranks 2

For 1, 2, 4, ... ranks, up to the cards present (or --max_ranks), it starts
that many processes, one card each on nccl.  Each rank builds the task
with envs_per_rank x ranks envs, steps its shard with zero actions once to
warm up, then `steps` times; the slowest rank's seconds give the global
env-steps/s.  One JSON line a count: ranks, global envs, env-steps/s and
the efficiency against linear scaling from one rank, with the card's name
and power limit.

`--share_device` runs 1 and 2 ranks on the one card (cuda:0) on gloo, for
a machine with a single card; the record says that the ranks share it, so
its efficiency measures contention, not scaling.  `--device cpu` runs the
ranks on the CPU on gloo: a rehearsal of the code path, whose rates are a
CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from pointfoot_tpu_torch.bench import card_line
from pointfoot_tpu_torch.parallel.mesh import init_distributed, make_mesh
from pointfoot_tpu_torch.utils.registry import make_env

RANK_TIMEOUT_S = 900.0


def get_args(argv=None):
    p = argparse.ArgumentParser(description="data-parallel env scaling")
    p.add_argument("--task", default="pointfoot_rough")
    p.add_argument("--envs_per_rank", type=int, default=4096)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--max_ranks", type=int, default=None,
                   help="largest rank count (default: the cards present)")
    p.add_argument("--share_device", action="store_true",
                   help="1 and 2 ranks sharing cuda:0 on gloo")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the ranks on the CPU (default: cards)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def rank_counts(args) -> list:
    if args.share_device:
        return [1, 2]
    if args.device == "cpu":
        most = args.max_ranks or 1
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu "
                               "to rehearse on the CPU")
        most = min(args.max_ranks or torch.cuda.device_count(),
                   torch.cuda.device_count())
    counts, n = [], 1
    while n <= most:
        counts.append(n)
        n *= 2
    return counts


def rank_main(args) -> None:
    """One rank: step the shard, report the seconds (rank 0 writes the
    slowest rank's)."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    shared = args.share_device
    backend = "gloo" if (shared or args.device == "cpu") else "nccl"
    # no process group at world size 1
    grouped = init_distributed(
        backend, f"file://{os.path.join(args.rdzv, 'rdzv')}",
        world_size=args.world, rank=args.rank, timeout_s=RANK_TIMEOUT_S)
    mesh = make_mesh("cuda:0" if shared else args.device)
    try:
        env = make_env(args.task, num_envs=args.envs_per_rank * args.world,
                       device=mesh.device)
        env.shard_mesh = mesh
        state = env.init_state(0)
        actions = torch.zeros(env.num_envs, env.num_actions,
                              device=mesh.device)
        state, _ = env.step(state, actions)  # warm-up
        _sync(mesh.device)
        if grouped:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, out = env.step(state, actions)
        _sync(mesh.device)
        secs = torch.tensor([time.perf_counter() - t0], device=mesh.device)
        if grouped:
            dist.all_reduce(secs, op=dist.ReduceOp.MAX)
        if not bool(torch.isfinite(out.obs).all()):
            raise RuntimeError(f"rank {args.rank}: non-finite observations")
        if mesh.rank == 0:
            with open(os.path.join(args.rdzv, "result.json"), "w") as f:
                json.dump({"seconds": float(secs),
                           "card": card_line(mesh.device)}, f)
    finally:
        if grouped:
            dist.destroy_process_group()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_count(args, world: int) -> dict:
    """Start `world` ranks, wait for them, return the slowest rank's
    seconds and the card line."""
    with tempfile.TemporaryDirectory() as rdzv:
        procs = []
        for r in range(world):
            env = dict(os.environ, LOCAL_RANK=str(r))
            cmd = [sys.executable, "-m", "pointfoot_tpu_torch.scaling_bench",
                   "--task", args.task, "--envs_per_rank",
                   str(args.envs_per_rank), "--steps", str(args.steps),
                   "--rank", str(r), "--world", str(world), "--rdzv", rdzv]
            if args.share_device:
                cmd.append("--share_device")
            if args.device is not None:
                cmd += ["--device", args.device]
            procs.append(subprocess.Popen(cmd, env=env))
        deadline = time.monotonic() + RANK_TIMEOUT_S + 60.0
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{world} ranks: rank(s) {bad} failed")
        with open(os.path.join(rdzv, "result.json")) as f:
            return json.load(f)


def main(argv=None) -> list:
    args = get_args(argv)
    if args.rank is not None:
        rank_main(args)
        return []
    records, base = [], None
    for world in rank_counts(args):
        res = run_count(args, world)
        envs = args.envs_per_rank * world
        rate = envs * args.steps / res["seconds"]
        base = rate if base is None else base
        rec = {"ranks": world, "envs": envs,
               "envs_per_rank": args.envs_per_rank, "task": args.task,
               "steps": args.steps, "steps_per_sec": rate,
               "efficiency": rate / (base * world),
               "backend": (None if world == 1 else "gloo"
                           if (args.share_device or args.device == "cpu")
                           else "nccl"),
               "shared_device": bool(args.share_device and world > 1),
               "card": res["card"]}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
