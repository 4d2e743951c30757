"""PPO training: the window loops the port's training iteration.

Set-up (counted in `setup_s`): the port's env through
`utils.registry.make_env` and its runner through `make_alg_runner`, with
the cell's configuration; `runner.init(seed, random_episode_step)` with the
traffic's setting (`learn` passes True), one zero-action env step, then
the traffic's warm iterations, which are
recorded for the comparison (benchmark/record.py).  The window then loops
`train_iteration` (`train_iteration_recurrent` with its carry) until
`--seconds` have passed, each iteration ending in `torch.cuda.synchronize`;
the rate counts the env-steps of the iterations completed over the time to
the last one's synchronisation.  No logging, checkpoint or bench lock.

With `--trace 1` the window runs with the spans of benchmark/trace.py, and
then a few whole iterations under the profiler.

Once the window has closed and the peak memory has been read, the port's
state is freed and the reference (benchmark/reference/) runs the same
recorded iterations from the same seed; benchmark/compare.py decides.

Beside `run`, what the tests and benchmark/calibrate.py take from a driver:
`check_config`, `port_records`, `reference_record`, `numbers`, `NUMBERS`
and `cpu_route` (benchmark/README.md, "What a cell is made of").
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from benchmark import compare, faults, record, spec


def build_port(cell: spec.Cell, device, mesh=None):
    """The port's env and runner for the cell."""
    from pointfoot_tpu_torch.utils.registry import (get_cfgs,
                                                    make_alg_runner,
                                                    make_env)
    task = cell.config["task"]
    values = spec.env_values(cell)
    _, train_reg = get_cfgs(task)
    groups = {k: spec.tuples(v) for k, v in values.items()}
    env = make_env(task, num_envs=values["env"]["num_envs"], device=device,
                   cfg_patch=groups)
    spec.check_same(env.cfg, values, "the port's env configuration")
    train_cfg = spec.overlay(train_reg, cell.config["train"])
    spec.check_same(train_cfg, cell.config["train"],
                    "the port's training configuration")
    runner = make_alg_runner(env, task, train_cfg=train_cfg, mesh=mesh)
    return env, runner


def build_reference(cell: spec.Cell, device):
    """The reference's env and runner for the cell (one process over the
    whole batch)."""
    from benchmark.reference.config import LeggedEnvCfg, TrainCfg
    from benchmark.reference.legged_env import LeggedEnv
    from benchmark.reference.runner import Runner
    values = spec.env_values(cell)
    env_cfg = spec.overlay(LeggedEnvCfg(), values)
    spec.check_same(env_cfg, values, "the reference's env configuration")
    train_cfg = spec.overlay(TrainCfg(), cell.config["train"])
    spec.check_same(train_cfg, cell.config["train"],
                    "the reference's training configuration")
    env = LeggedEnv(env_cfg, device)
    return env, Runner(env, train_cfg)


def check_config(cell: spec.Cell) -> None:
    """Raise where the reference's or the port's configuration classes do
    not take the cell's configuration as its file has it (the port's as
    `make_env` builds it; no env is built)."""
    from benchmark.reference.config import LeggedEnvCfg, TrainCfg
    from pointfoot_tpu_torch.envs.config import override
    from pointfoot_tpu_torch.utils.registry import get_cfgs
    values = spec.env_values(cell)
    train = cell.config["train"]
    env_reg, train_reg = get_cfgs(cell.config["task"])
    spec.check_same(spec.overlay(LeggedEnvCfg(), values), values,
                    "the reference's env configuration")
    spec.check_same(spec.overlay(TrainCfg(), train), train,
                    "the reference's training configuration")
    spec.check_same(override(env_reg, **{k: spec.tuples(v)
                                         for k, v in values.items()}),
                    values, "the port's env configuration")
    spec.check_same(spec.overlay(train_reg, train), train,
                    "the port's training configuration")


@contextlib.contextmanager
def tf32_products(on: bool):
    """Matrix products in TF32 while open (`on`), or in full float32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def reference_record(cell: spec.Cell, seed: int, device, tf32: bool = False
                     ) -> record.Record:
    """The reference's recorded iterations from `seed`; with `tf32` its
    matrix products in TF32 (the control)."""
    with tf32_products(tf32):
        env, runner = build_reference(cell, device)
        _, rec = record.start(runner, env, seed, cell.traffic)
    return rec


def port_records(cell: spec.Cell, tasks, device):
    """The port's recorded iterations for each task (seed, the names of the
    faults open): the set-up of `run` without a window, a fresh env and
    runner a task (benchmark/calibrate.py)."""
    for seed, names in tasks:
        with faults.opened(names):
            env, runner = build_port(cell, device)
            _, rec = record.start(runner, env, seed, cell.traffic)
            sync(device)
        del env, runner
        yield rec


numbers = compare.numbers  # the port's record against the reference's
NUMBERS = compare.NUMBERS  # what `numbers` gives: the keys of the limits


@contextlib.contextmanager
def cpu_route():
    """A tiny run on the CPU takes the cells' route: the fused rollout
    (through the plain versions of kernels 1-2), which the port takes from
    `MEGA_MIN_BATCH` envs on."""
    import pointfoot_tpu_torch.physics.dynamics as dynamics
    old = dynamics.MEGA_MIN_BATCH
    dynamics.MEGA_MIN_BATCH = 1
    try:
        yield
    finally:
        dynamics.MEGA_MIN_BATCH = old


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(runner, loop, seconds: float, device):
    """Whole iterations until `seconds` have passed: (iterations, s, the
    time each iteration ended at)."""
    sync(device)
    t0 = time.perf_counter()
    ends = []
    while True:
        record.iterate(runner, loop)
        sync(device)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            return len(ends), ends[-1], ends


def run(cell: spec.Cell, args, t0: float, device=None) -> dict:
    """One run of the cell on one card (`device`, the first CUDA device
    unless given): the result's fields."""
    from benchmark import trace
    device = torch.device("cuda", 0) if device is None else device
    marks = {"start": time.perf_counter() - t0}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    marks["device"] = time.perf_counter() - t0
    env, runner = build_port(cell, device)
    marks["built"] = time.perf_counter() - t0
    loop, prog = record.start(runner, env, args.seed, cell.traffic)
    sync(device)
    setup_s = time.perf_counter() - t0
    marks["warm"] = setup_s

    steps_per_iter = runner.cfg.runner.num_steps_per_env * env.num_envs
    obs = {"envs": env.num_envs, "config": cell.config, "ranks": 1,
           "model": {"nj": env.model.nj,
                     "nc": len(env.model.collision_body)},
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")}
    if args.trace:
        spans = trace.Spans(runner, env).install()
        n, elapsed, ends = window(runner, loop, args.seconds, device)
        spans.remove()
        remove = trace.annotate(runner, env)
        prof = trace.profile(lambda: record.iterate(runner, loop),
                             int(cell.traffic["profile_iterations"]))
        remove()
        remove = None  # it holds the runner and the env
        obs.update(spans=spans, iteration_s=elapsed / n,
                   profiles=[prof])
    else:
        n, elapsed, ends = window(runner, loop, args.seconds, device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    env_steps = n * steps_per_iter
    env = runner = loop = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_record(cell, args.seed, device)
    nums = compare.numbers(prog, ref)
    marks["reference_s"] = time.perf_counter() - t_ref
    return {"setup_s": setup_s, "rate": env_steps / elapsed,
            "marks": marks, "ends": ends,
            "iterations": n, "window_s": elapsed,
            "memory_peak_bytes": memory_peak, "numbers": nums,
            "observed": obs}
