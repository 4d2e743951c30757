"""Data-parallel PPO training: the window loops the port's training iteration
on W ranks, one card a rank, as

    torchrun --nproc_per_node 4 -m pointfoot_tpu_torch.train --mesh auto

does on one four-card node.

Rank 0 runs in the harness's process.  It starts ranks 1..W-1 as processes
of their own (`python -m benchmark.drivers.ppo_train_dp JOB RANK`, JOB a
file it writes under TMPDIR) on a free port of localhost; the process
group is NCCL on the card, gloo on the CPU.  NCCL's shared-memory
transport is off, so nothing goes to /dev/shm (P2P over NVLink carries
the collectives).  Each rank builds the port's env and runner with its
`Mesh` (`make_env` with the global batch, `make_alg_runner(mesh=...)`), as
`train._train` does, and takes the set-up and recorded warm iterations of
benchmark/record.py (`init(seed, random_episode_step)`, the zero-action
step, the traffic's warm iterations).

The window: every rank loops `train_iteration`, each ending in
`torch.cuda.synchronize`.  After each, rank 0 says on a gloo group whether
another follows (its clock short of `--seconds` or not), so that every
rank runs the same iterations.  The rate counts the global env-steps of
the iterations over rank 0's time to the last one's synchronisation.
With `--trace 1` rank 0 runs the window with the spans of
benchmark/trace.py; then every rank profiles the same iterations.

After the window each rank writes its record, its peak memory and its
profile under TMPDIR and exits; rank 0 waits for every rank, frees its
state, and runs the reference (benchmark/reference/dp.py) over W shards
from the same seed.  `rollout` is the worst rank's storage against its
shard's; `loss`, `grad_first` and `param_change`, and the first
iteration's `loss_first` and `param_change_first`, the worst rank's.  The
faults of benchmark/faults.py open in rank 0's process, and its physics
route (`MEGA_MIN_BATCH`), reach every rank.  A rank that finds JAX or the
JAX package in `sys.modules` once its window has closed writes no output
and exits with code 3, so that the run prints no result.

`port_records` (benchmark/calibrate.py) runs no window: the ranks take
one recorded start after another, from each task's seed with its faults
open, on the env and runner built once.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Iterator, List, Sequence, Tuple

import torch

from benchmark import compare, faults, record, spec
from benchmark import run as bench_run
from benchmark.drivers import ppo_train

RANK_TIMEOUT_S = 150.0  # a collective waits this long for a lost rank
EXIT_TIMEOUT_S = 120.0  # a rank has this long to exit after the window

check_config = ppo_train.check_config
cpu_route = ppo_train.cpu_route
NUMBERS = compare.NUMBERS + compare.FIRST  # what `numbers` gives


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_run(job: dict, rank: int, t0: float) -> dict:
    """Rank `rank`'s part of the run `job` describes: set-up, the window,
    the profiled iterations with `trace`; its record and readings.  With
    `tasks` in the job, one recorded start a task instead."""
    import torch.distributed as dist

    from benchmark import trace
    from pointfoot_tpu_torch.parallel.mesh import init_distributed, make_mesh
    device = (torch.device("cuda", rank) if job["device"] == "cuda"
              else torch.device("cpu"))
    cell = spec.Cell(**job["cell"])
    threads = torch.get_num_threads()
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, threads // job["ranks"]))
    init_distributed("nccl" if device.type == "cuda" else "gloo",
                     f"tcp://127.0.0.1:{job['port']}", job["ranks"], rank,
                     timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = make_mesh(device)
        ctl = dist.new_group(backend="gloo")
        marks = {"joined": time.perf_counter() - t0}
        env, runner = ppo_train.build_port(cell, device, mesh=mesh)
        marks["built"] = time.perf_counter() - t0
        if job.get("tasks") is not None:
            recs = []
            for seed, names in job["tasks"]:
                with faults.opened(names):
                    _, rec = record.start(runner, env, seed, cell.traffic)
                ppo_train.sync(device)
                recs.append(vars(rec))
            return {"records": recs}
        loop, rec = record.start(runner, env, job["seed"], cell.traffic)
        ppo_train.sync(device)
        setup_s = time.perf_counter() - t0
        marks["warm"] = setup_s

        flag = torch.zeros(1, dtype=torch.int32)

        def more(go: bool) -> bool:
            """Rank 0's say whether another iteration follows."""
            flag[0] = int(go)
            dist.broadcast(flag, src=0, group=ctl)
            return bool(flag[0])

        spans = (trace.Spans(runner, env).install()
                 if job["trace"] and rank == 0 else None)
        ppo_train.sync(device)
        start = time.perf_counter()
        ends = []
        while True:
            record.iterate(runner, loop)
            ppo_train.sync(device)
            ends.append(time.perf_counter() - start)
            if not more(ends[-1] < job["seconds"]):
                break
        prof = None
        if job["trace"]:
            if spans is not None:
                spans.remove()
            undo = trace.annotate(runner, env)
            prof = trace.profile(lambda: record.iterate(runner, loop),
                                 int(cell.traffic["profile_iterations"]))
            undo()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        return {"record": vars(rec), "memory_peak_bytes": int(peak),
                "profile": prof, "setup_s": setup_s, "marks": marks,
                "ends": ends, "envs": env.num_envs,
                "steps_per_env": runner.cfg.runner.num_steps_per_env,
                "model": {"nj": env.model.nj,
                          "nc": len(env.model.collision_body)},
                "spans": spans}
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def _wait(procs) -> None:
    """Wait for every rank to exit; raise where one failed."""
    for r, p in procs:
        try:
            rc = p.wait(timeout=EXIT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise RuntimeError(f"rank {r} did not exit")
        if rc != 0:
            raise RuntimeError(f"rank {r} exited with code {rc}")


@contextlib.contextmanager
def _ranks(cell: spec.Cell, fields: dict, t0: float, device):
    """Start ranks 1..W-1 on the job `fields` describes, run rank 0 here
    and wait for every rank.  Yields (rank 0's output, the other ranks'
    outputs, loaded from their files); removes the files on leaving."""
    import pointfoot_tpu_torch.physics.dynamics as dynamics
    os.environ["NCCL_SHM_DISABLE"] = "1"
    work = tempfile.mkdtemp(prefix="bench-dp-")  # under TMPDIR
    job = dict(fields, cell={
        "name": cell.name, "chips": cell.chips, "config": cell.config,
        "traffic": cell.traffic, "end_to_end": [], "per_layer": [],
        "limits": None},
        ranks=cell.ranks, port=_free_port(), device=device.type,
        mega_min_batch=dynamics.MEGA_MIN_BATCH, faults=faults.active(),
        dir=work)
    path = os.path.join(work, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    procs = []
    try:
        for r in range(1, cell.ranks):
            procs.append((r, subprocess.Popen(
                [sys.executable, "-m", "benchmark.drivers.ppo_train_dp",
                 path, str(r)], cwd=spec.ROOT, stdin=subprocess.DEVNULL,
                stdout=2)))
        out0 = rank_run(job, 0, t0)
        _wait(procs)
        yield out0, [torch.load(os.path.join(work, f"rank{r}.pt"),
                                mmap=True)
                     for r in range(1, cell.ranks)]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def run(cell: spec.Cell, args, t0: float, device=None) -> dict:
    """One run of the cell on `cell.ranks` cards (rank 0 on `device`, the
    first CUDA device unless given; rank r on card r, or all on the CPU):
    the result's fields."""
    device = torch.device("cuda", 0) if device is None else device
    fields = {"seed": int(args.seed), "seconds": float(args.seconds),
              "trace": int(args.trace)}
    with _ranks(cell, fields, t0, device) as (o0, others):
        outs = [o0, *others]
        ends = o0["ends"]
        n, elapsed = len(ends), ends[-1]
        env_steps = n * o0["steps_per_env"] * o0["envs"] * cell.ranks
        obs = {"envs": o0["envs"], "config": cell.config,
               "ranks": cell.ranks, "model": o0["model"],
               "device_name": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu")}
        if args.trace:
            obs.update(spans=o0["spans"], iteration_s=elapsed / n,
                       profiles=[o["profile"] for o in outs])
        memory_peak = max(o["memory_peak_bytes"] for o in outs)
        setup_s, marks = o0["setup_s"], o0["marks"]
        progs = [record.Record(**o["record"]) for o in outs]
        outs = o0 = others = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        nums = numbers(progs, reference_record(cell, args.seed, device))
        marks["reference_s"] = time.perf_counter() - t_ref
    return {"setup_s": setup_s, "rate": env_steps / elapsed, "marks": marks,
            "ends": ends, "iterations": n, "window_s": elapsed,
            "memory_peak_bytes": memory_peak, "numbers": nums,
            "observed": obs}


def reference_record(cell: spec.Cell, seed: int, device, tf32: bool = False
                     ) -> List[record.Record]:
    """The reference's recorded iterations from `seed` over `cell.ranks`
    shards, one record a rank (its shard's rollout); with `tf32` its matrix
    products in TF32 (the control)."""
    from benchmark.reference import dp
    from benchmark.reference.config import LeggedEnvCfg, TrainCfg
    values = spec.env_values(cell)
    env_cfg = spec.overlay(LeggedEnvCfg(), values)
    spec.check_same(env_cfg, values, "the reference's env configuration")
    train_cfg = spec.overlay(TrainCfg(), cell.config["train"])
    spec.check_same(train_cfg, cell.config["train"],
                    "the reference's training configuration")
    with ppo_train.tf32_products(tf32):
        env = dp.ShardedEnv(env_cfg, device, cell.ranks)
        _, rec = record.start(dp.ShardedRunner(env, train_cfg), env, seed,
                              cell.traffic)
    return [record.Record(
        params0=rec.params0, params=rec.params,
        params_first=rec.params_first, grad_first=rec.grad_first,
        losses=rec.losses,
        rollout={f: v[:, rows] for f, v in rec.rollout.items()})
        for rows in env.rows]


def port_records(cell: spec.Cell, tasks: Sequence[Tuple[int, List[str]]],
                 device) -> Iterator[List[record.Record]]:
    """Every rank's recorded iterations for each task (seed, faults), in
    one start of the ranks (benchmark/calibrate.py): a list a task, one
    record a rank."""
    if not tasks:
        return
    fields = {"tasks": [[int(s), list(f)] for s, f in tasks]}
    with _ranks(cell, fields, time.perf_counter(), device) as (o0, others):
        for i in range(len(tasks)):
            yield [record.Record(**o["records"][i]) for o in [o0, *others]]


def numbers(prog: List[record.Record], ref: List[record.Record]) -> dict:
    """The comparison's numbers (`NUMBERS`), the worst rank's each: every
    rank's record against the reference's with that rank's shard of the
    rollout."""
    if len(prog) != len(ref):
        return {k: float("inf") for k in NUMBERS}
    per = [dict(compare.numbers(p, r), **compare.first_numbers(p, r))
           for p, r in zip(prog, ref)]
    return {k: max(n[k] for n in per) for k in NUMBERS}


def main(argv: List[str]) -> int:
    """A spawned rank: run its part of the job and write its output."""
    path, rank = argv[0], int(argv[1])
    t0 = time.perf_counter()
    with open(path) as f:
        job = json.load(f)
    import pointfoot_tpu_torch.physics.dynamics as dynamics
    dynamics.MEGA_MIN_BATCH = job["mega_min_batch"]
    with faults.opened(job["faults"]):
        out = rank_run(job, rank, t0)
        found = bench_run.forbidden_modules()  # the window has closed
    if found:
        print(f"benchmark: rank {rank} loaded {found}; no result",
              file=sys.stderr)
        return 3
    out.pop("spans", None)
    torch.save(out, os.path.join(job["dir"], f"rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
