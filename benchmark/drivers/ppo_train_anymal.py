"""PPO training of a task whose actuator network runs on the scan path:
`ppo_train`'s loop, with the reference env that takes that path.

The port steps such a task (`anymal_c_rough`) through its scan path: each
substep one tick of the actuator LSTM, then `dynamics.step_batched` on its
mega-kernel route (kernels 4 and 3 on the card).  The reference is
benchmark/reference/anymal_env.py, which takes the same substeps through
the plain twins of those kernels.  Set-up, window, trace and comparison are
`ppo_train`'s (its docstring), but for two things:

- the traced window runs inside the port's `profiling.recording()`, and its
  rows (utils/profiling.py: one an iteration, the program's spans and
  counters) go to the metric readers as `program_rows`;
- `cpu_route` (`ppo_train`'s) makes a tiny CPU run take the mega-kernel
  route of `step_batched` through the plain versions of kernels 3-4.

Beside `run`: `check_config`, `port_records`, `reference_record`,
`numbers`, `NUMBERS` and `cpu_route` (benchmark/README.md, "What a cell is
made of").
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import compare, record, spec
from benchmark.drivers import ppo_train

check_config = ppo_train.check_config
port_records = ppo_train.port_records
numbers = compare.numbers  # the port's record against the reference's
NUMBERS = compare.NUMBERS  # what `numbers` gives: the keys of the limits


def build_reference(cell: spec.Cell, device):
    """The reference's env (the actuator network on the scan path) and
    runner for the cell."""
    from benchmark.reference.anymal_env import AnymalEnv
    from benchmark.reference.config import LeggedEnvCfg, TrainCfg
    from benchmark.reference.runner import Runner
    values = spec.env_values(cell)
    env_cfg = spec.overlay(LeggedEnvCfg(), values)
    spec.check_same(env_cfg, values, "the reference's env configuration")
    train_cfg = spec.overlay(TrainCfg(), cell.config["train"])
    spec.check_same(train_cfg, cell.config["train"],
                    "the reference's training configuration")
    env = AnymalEnv(env_cfg, device)
    return env, Runner(env, train_cfg)


def reference_record(cell: spec.Cell, seed: int, device, tf32: bool = False
                     ) -> record.Record:
    """The reference's recorded iterations from `seed`; with `tf32` its
    matrix products in TF32 (the control)."""
    with ppo_train.tf32_products(tf32):
        env, runner = build_reference(cell, device)
        _, rec = record.start(runner, env, seed, cell.traffic)
    return rec


# a tiny CPU run takes the cell's route from MEGA_MIN_BATCH = 1 on:
# `step_batched`'s mega-kernel route, through the plain versions of
# kernels 3-4 (on the card the port takes it from `MEGA_MIN_BATCH` envs on)
cpu_route = ppo_train.cpu_route


def recorded_window(runner, loop, seconds: float, device):
    """`ppo_train.window` inside the port's `profiling.recording()`:
    (iterations, s, the time each iteration ended at, the rows the window
    closed)."""
    from pointfoot_tpu_torch.utils import profiling
    before = profiling.last_row()
    first = 0 if before is None else before["iteration"] + 1
    with profiling.recording():
        n, elapsed, ends = ppo_train.window(runner, loop, seconds, device)
    rows = [r for r in profiling.rows() if r["iteration"] >= first]
    return n, elapsed, ends, rows


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
    env, runner = ppo_train.build_port(cell, device)
    marks["built"] = time.perf_counter() - t0
    loop, prog = record.start(runner, env, args.seed, cell.traffic)
    ppo_train.sync(device)
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
        n, elapsed, ends, rows = recorded_window(runner, loop, args.seconds,
                                                 device)
        spans.remove()
        remove = trace.annotate(runner, env)
        prof = trace.profile(lambda: record.iterate(runner, loop),
                             int(cell.traffic["profile_iterations"]))
        remove()
        remove = None  # it holds the runner and the env
        obs.update(spans=spans, iteration_s=elapsed / n,
                   profiles=[prof], program_rows=rows)
    else:
        n, elapsed, ends = ppo_train.window(runner, loop, args.seconds,
                                            device)
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
