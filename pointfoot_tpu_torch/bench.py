"""Benchmarks of the port (the `main`, `main_mpc`, `main_mpc_ilqr` and
`main_train` of the JAX package's bench.py).

    python -m pointfoot_tpu_torch.bench --mode env
    python -m pointfoot_tpu_torch.bench --mode actuator_net
    python -m pointfoot_tpu_torch.bench --mode train
    python -m pointfoot_tpu_torch.bench --mode mpc
    python -m pointfoot_tpu_torch.bench --mode mpc --solver plain
    python -m pointfoot_tpu_torch.bench --mode mpc --device cpu --num_envs 8
    python -m pointfoot_tpu_torch.bench --mode mpc_ilqr
    python -m pointfoot_tpu_torch.bench --mode mpc_ilqr --device cpu \
        --num_envs 2 --iters 1
    python -m pointfoot_tpu_torch.bench --mode env --device cpu \
        --num_envs 2 --iters 1 --reps 1 --steps 2

Each prints ONE JSON line {"metric", "value", "unit", "vs_baseline",
"conditions"}; the value is the median of `--reps` repetitions of `--iters`
iterations after a warm-up, timed by the host clock ending in
`torch.cuda.synchronize`, and the conditions name the card.

`--mode env`: env throughput of pointfoot_rough at `--num_envs` envs
(4096) with its registered config, driven by the deterministic actions
0.2 sin(phase + 0.1 t), the phase drawn anew for every iteration of
`--steps` policy steps (24); the env's own randomness (resets, pushes,
commands) runs.  The headline is procedural terrain: after one warm
iteration, warm iterations until two consecutive ones agree within 15%
(at most 8), then the median of `--reps` repetitions of `--iters`
iterations (default 20); vs_baseline = env-steps/s over real time,
num_envs x 50 Hz.  The table terrain is measured in the same run, one
repetition at half the iterations, and recorded as the condition
`table_steps_per_sec`.  `--mode actuator_net`: the same for
anymal_c_rough, whose torques come from the ANYdrive network.

`--mode train`: PPO training of pointfoot_rough on procedural terrain at
`--num_envs` envs (4096), fresh from seed 0, with the registry's PPO config
(24 steps an iteration, 5 x 4 minibatches).  Two warm iterations, then
env-steps/s including the update (default 1 iteration a repetition);
vs_baseline = env-steps/s over real time, num_envs x 50 Hz.  The
conditions also give the seconds of one iteration's rollout and update,
timed apart on one more iteration.

`--mode mpc`: one tick = the batched Riccati re-plan and the leg-torque
mapping of every scenario: PointFoot, `--num_envs` scenarios (4096),
SRBConfig() (horizon 12), default pose at 0.62 m, zero commands; the value
is scenario-solves/s (default 20 ticks a repetition, after a warm-up tick);
vs_baseline = solves/s over real time, num_envs x 50 Hz.  `--solver
kernel` (default) plans with the fused SRB-LQR kernel
(`SRBController.plan_tick_cuda`), `--solver plain` with the sequential
Riccati recursion (`plan_tick`).

`--mode mpc_ilqr`: the full-model iLQR (mpc/controller.MPCController):
PointFoot, `--num_envs` scenarios (4096), ILQRConfig(horizon=25,
iterations=2, reg_init=1.0), dt 0.02, the default pose at 0.62 m and zero
commands, planned in chunks of `--chunk` scenarios (1024, the JAX bench's
BENCH_ILQR_CHUNK); one warm plan, then `--iters` timed plans (3), each
from the same state with the warm start the previous plan left, as the
JAX bench times them; vs_baseline = solves/s over real time, num_envs x
50 Hz.

`--mode env_phases`: the cost of each post-physics phase of the
procedural pointfoot_rough step, by ablation (LeggedEnv._ablate): `--mode
env`'s procedural measurement (one repetition of `--iters` iterations,
default 10) of the full step and of five variants with phases replaced by
zeros: `physics_only` (every post-physics phase), `no_reward`,
`no_obs_heights` (observations and height scan), `no_reset` and
`no_cmd_push` (command resampling and pushes).  The record's `phases`
gives each variant's env-steps/s, `phase_gain_us_per_step` the µs a step
each variant saves against the full step; vs_baseline = the full step's
env-steps/s over real time, num_envs x 50 Hz.  `phase_ms_per_step` gives,
from the full step's recorded repetition, the physics' and each phase's
own host ms a step by its span (`env.<phase>`; the terrain queries inside
a phase are not its own).

Before it touches the device, `main` takes the bench lock
(utils/benchlock.py; BENCH_QUIESCE_TIMEOUT_S, default 300 s): a trainer
of either package that runs `learn` drains its device work and pauses
until the benchmark ends.  Every record's conditions say under `trainer`
what the lock found: "no_trainer", "trainer_paused" or "timeout_no_ack"
("unknown" when a mode's function is called without `main`).

Runs on the GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.envs.legged_env import PHASES, phase_ms_per_step
from pointfoot_tpu_torch.mpc.controller import MPCController
from pointfoot_tpu_torch.mpc.ilqr import ILQRConfig
from pointfoot_tpu_torch.mpc.srb import SRBConfig, SRBController
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain.analytic import FLAT
from pointfoot_tpu_torch.utils import benchlock, profiling
from pointfoot_tpu_torch.utils.policy_eval import FLAGSHIP_PATCH
from pointfoot_tpu_torch.utils.registry import make_alg_runner, make_env

MODES = ("env", "env_phases", "mpc", "mpc_ilqr", "actuator_net", "train")
SOLVERS = ("kernel", "plain")
ITERS = {"env": 20, "env_phases": 10, "actuator_net": 20, "mpc": 20,
         "mpc_ilqr": 3, "train": 1}  # --iters
ENV_TASKS = {"env": "pointfoot_rough", "actuator_net": "anymal_c_rough"}
STEPS_PER_ITER = 24
SETTLE_MAX, SETTLE_AGREE = 8, 0.15
# env_phases: each variant's ablated phases (LeggedEnv._ablate; PHASES are
# also the env step's spans `env.<phase>`)
PHASE_VARIANTS = {
    "full": (),
    "physics_only": PHASES,
    "no_reward": ("reward",),
    "no_obs_heights": ("obs", "heights"),
    "no_reset": ("reset",),
    "no_cmd_push": ("commands", "push"),
}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type off the GPU."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def make_mpc(num_envs: int, device: torch.device):
    """The benchmark's controller, state and commands."""
    model = get_model("pointfoot").to(device)
    params = PhysicsParams.nominal(model, num_envs, device)
    feet = model.collision_indices("foot")
    ctrl = SRBController(model, params, feet, np.zeros(6, np.float32),
                         SRBConfig())
    phys = PhysicsState.default(model, np.zeros(6, np.float32), num_envs,
                                device, base_height=0.62)
    cmd = torch.zeros(num_envs, 3, device=device)
    return ctrl, phys, cmd


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main_mpc(num_envs: int = 4096, iters: int = 20, reps: int = 3,
             solver: str = "kernel", device=None,
             trainer: str = "unknown") -> dict:
    """Time the tick and return (and print) the benchmark's record."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    device = resolve_device(device)
    ctrl, phys, cmd = make_mpc(num_envs, device)
    tick = ctrl.plan_tick_cuda if solver == "kernel" else ctrl.plan_tick
    tau, _ = tick(phys, cmd)
    _sync(device)
    if not bool(torch.isfinite(tau).all()):
        raise RuntimeError("SRB-MPC tick returned non-finite torques")
    rates = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        for _ in range(iters):
            tau, _ = tick(phys, cmd)
        _sync(device)
        dt = (time.perf_counter() - t0) / iters
        rates.append(num_envs / dt)
    solves_per_sec = sorted(rates)[len(rates) // 2]
    realtime = num_envs * 50.0
    record = {
        "metric": f"srb_mpc_scenario_solves_per_sec@{num_envs}",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / realtime, 4),
        "conditions": {"solver": solver,
                       "horizon": ctrl.cfg.horizon,
                       "iters": iters,
                       "reps_solves_per_sec": [round(r, 1) for r in rates],
                       "trainer": trainer,
                       "card": card_line(device)},
    }
    print(json.dumps(record), flush=True)
    return record


def make_mpc_ilqr(num_envs: int, device: torch.device, chunk: int = 1024):
    """The iLQR benchmark's controller, state, commands and warm start."""
    model = get_model("pointfoot").to(device)
    ctrl = MPCController(
        model, PhysicsParams.nominal(model, 1, device), FLAT,
        np.zeros(6, np.float32),
        cfg=ILQRConfig(horizon=25, iterations=2, reg_init=1.0), dt=0.02,
        chunk=chunk)
    phys = PhysicsState.default(model, np.zeros(6, np.float32), num_envs,
                                device, base_height=0.62)
    cmd = torch.zeros(num_envs, 3, device=device)
    return ctrl, phys, cmd, ctrl.init(num_envs)


def main_mpc_ilqr(num_envs: int = 4096, iters: int = 3, chunk: int = 1024,
                  device=None, trainer: str = "unknown") -> dict:
    """Time full-model iLQR plans and return (and print) the record."""
    device = resolve_device(device)
    chunk = min(chunk, num_envs)
    ctrl, phys, cmd, ms = make_mpc_ilqr(num_envs, device, chunk)
    torque, ms, cost = ctrl.plan(phys, cmd, ms)
    _sync(device)
    if not (bool(torch.isfinite(torque).all())
            and bool(torch.isfinite(cost).all())):
        raise RuntimeError("iLQR plan returned non-finite torques or costs")
    t0 = time.perf_counter()
    for _ in range(iters):
        torque, ms, cost = ctrl.plan(phys, cmd, ms)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    solves_per_sec = num_envs / dt
    record = {
        "metric": f"ilqr_scenario_solves_per_sec@{num_envs}",
        "value": round(solves_per_sec, 3),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / (num_envs * 50.0), 6),
        "conditions": {"horizon": ctrl.cfg.horizon,
                       "iterations": ctrl.cfg.iterations,
                       "chunk": chunk, "reps": iters,
                       "s_per_plan": round(dt, 4),
                       "trainer": trainer,
                       "card": card_line(device)},
    }
    print(json.dumps(record), flush=True)
    return record


def bench_env(task: str, procedural: bool, num_envs: int, iters: int,
              reps: int, steps: int, device: torch.device, ablate=()):
    """Env-steps/s of `task` on one terrain path, the phases `ablate`
    replaced by zeros: (median of the repetitions, the repetitions, warm
    iterations of the settle loop, the repetitions' profiling row: None
    outside `profiling.recording()`)."""
    env = make_env(task, num_envs=num_envs, device=device,
                   cfg_patch=dict(terrain=dict(procedural=procedural)))
    env._ablate = frozenset(ablate)
    state = env.init_state(0)
    g = torch.Generator(device=device).manual_seed(1)

    def run(state):
        phase = 6.28 * torch.rand(num_envs, env.num_actions, generator=g,
                                  device=device)
        for t in range(steps):
            state, out = env.step(state, 0.2 * torch.sin(phase + 0.1 * t))
        return state, out.reward

    state, rew = run(state)
    _sync(device)
    prev, stable, settles = None, 0, 0
    for settles in range(1, SETTLE_MAX + 1):
        t0 = time.perf_counter()
        state, rew = run(state)
        _sync(device)
        dt = time.perf_counter() - t0
        if prev is not None and abs(dt - prev) / prev < SETTLE_AGREE:
            stable += 1
            if stable >= 2:
                break
        else:
            stable = 0
        prev = dt
    rates = []
    with profiling.row() as row:
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            for _ in range(iters):
                state, rew = run(state)
            _sync(device)
            rates.append(num_envs * steps * iters
                         / (time.perf_counter() - t0))
    if not bool(torch.isfinite(rew).all()):
        raise RuntimeError(f"{task}: non-finite rewards")
    return sorted(rates)[len(rates) // 2], rates, settles, row


def main_env(task: str = "pointfoot_rough", num_envs: int = 4096,
             iters: int = 20, reps: int = 3, steps: int = STEPS_PER_ITER,
             device=None, trainer: str = "unknown") -> dict:
    """The procedural headline and the table leg; returns (and prints)
    the benchmark's record."""
    device = resolve_device(device)
    sps, rates, settles, _ = bench_env(task, True, num_envs, iters, reps,
                                       steps, device)
    table_sps, _, table_settles, _ = bench_env(
        task, False, num_envs, max(iters // 2, 2), 1, steps, device)
    record = {
        "metric": f"env_steps_per_sec@{num_envs}envs_{task}",
        "value": round(sps, 1),
        "unit": "steps/s",
        "vs_baseline": round(sps / (num_envs * 50.0), 4),
        "conditions": {"terrain": "procedural",
                       "settle_iters": settles,
                       "reps_steps_per_sec": [round(r, 1) for r in rates],
                       "table_steps_per_sec": round(table_sps, 1),
                       "table_settle_iters": table_settles,
                       "iters": iters, "steps_per_iter": steps,
                       "trainer": trainer,
                       "card": card_line(device)},
    }
    print(json.dumps(record), flush=True)
    return record


def main_env_phases(task: str = "pointfoot_rough", num_envs: int = 4096,
                    iters: int = 10, steps: int = STEPS_PER_ITER,
                    device=None, trainer: str = "unknown") -> dict:
    """The procedural step's phase costs by ablation; returns (and
    prints) the benchmark's record."""
    device = resolve_device(device)
    phases, settles = {}, {}
    for name, ablate in PHASE_VARIANTS.items():
        # only the full step records its spans: each phase's own ms a step
        with (profiling.recording() if name == "full"
              else contextlib.nullcontext()):
            sps, _, settles[name], row = bench_env(
                task, True, num_envs, iters, 1, steps, device, ablate)
        phases[name] = round(sps, 1)
        if name == "full":
            phase_ms = {p: round(ms, 4)
                        for p, ms in phase_ms_per_step(row).items()}
    full = phases["full"]
    # a variant's rate against the full step's: the µs a step its
    # ablated phases cost
    gain = {n: round(num_envs * (1.0 / full - 1.0 / v) * 1e6, 1)
            for n, v in phases.items() if n != "full"}
    record = {
        "metric": "env_phase_profile",
        "value": full,
        "unit": "steps/s",
        "vs_baseline": round(full / (num_envs * 50.0), 4),
        "phases": phases,
        "phase_gain_us_per_step": gain,
        "phase_ms_per_step": phase_ms,
        "num_envs": num_envs,
        "conditions": {"task": task, "terrain": "procedural",
                       "iters": iters, "steps_per_iter": steps,
                       "settle_iters": settles,
                       "ablated": {n: list(a)
                                   for n, a in PHASE_VARIANTS.items()},
                       "trainer": trainer,
                       "card": card_line(device)},
    }
    print(json.dumps(record), flush=True)
    return record


def main_train(num_envs: int = 4096, iters: int = 1, reps: int = 3,
               device=None, trainer: str = "unknown") -> dict:
    """Time PPO training iterations and return (and print) the record."""
    device = resolve_device(device)
    task = "pointfoot_rough"
    env = make_env(task, num_envs=num_envs, device=device,
                   cfg_patch=FLAGSHIP_PATCH)
    runner = make_alg_runner(env, task)
    es = runner.init(0)
    es, out = env.step(es, torch.zeros(num_envs, env.num_actions,
                                       device=device))
    obs, priv = out.obs, out.privileged_obs
    for _ in range(2):
        es, obs, priv, metrics = runner.train_iteration(es, obs, priv)
    _sync(device)
    steps = runner.cfg.runner.num_steps_per_env * num_envs
    rates = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        for _ in range(iters):
            es, obs, priv, metrics = runner.train_iteration(es, obs, priv)
        _sync(device)
        rates.append(steps * iters / (time.perf_counter() - t0))
    # one more iteration, its rollout and update timed apart
    t0 = time.perf_counter()
    es, obs, priv, rollout, _ = runner.rollout(es, obs, priv)
    _sync(device)
    t1 = time.perf_counter()
    metrics = runner.update(rollout, obs, priv)
    _sync(device)
    t2 = time.perf_counter()
    if not all(bool(torch.isfinite(v).all()) for v in metrics.values()):
        raise RuntimeError(f"PPO update returned non-finite metrics: "
                           f"{ {k: v.tolist() for k, v in metrics.items()} }")
    sps = sorted(rates)[len(rates) // 2]
    record = {
        "metric": f"train_env_steps_per_sec@{num_envs}envs_pointfoot_rough",
        "value": round(sps, 1),
        "unit": "steps/s",
        "vs_baseline": round(sps / (num_envs * 50.0), 4),
        "conditions": {"iters": iters,
                       "reps_steps_per_sec": [round(r, 1) for r in rates],
                       "rollout_s": round(t1 - t0, 4),
                       "update_s": round(t2 - t1, 4),
                       "num_steps_per_env":
                           runner.cfg.runner.num_steps_per_env,
                       "trainer": trainer,
                       "card": card_line(device)},
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES, default="env")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=None,
                    help=f"iterations a repetition (default {ITERS})")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=STEPS_PER_ITER,
                    help="policy steps an iteration (env modes)")
    ap.add_argument("--solver", choices=SOLVERS, default="kernel")
    ap.add_argument("--chunk", type=int, default=1024,
                    help="scenarios an iLQR solve (mpc_ilqr)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    iters = ITERS[args.mode] if args.iters is None else args.iters
    trainer = benchlock.quiesce(
        timeout_s=float(os.environ.get("BENCH_QUIESCE_TIMEOUT_S", "300")))
    try:
        return _run_mode(args, iters, trainer)
    finally:
        benchlock.release()


def _run_mode(args, iters: int, trainer: str) -> dict:
    if args.mode in ENV_TASKS:
        return main_env(ENV_TASKS[args.mode], args.num_envs, iters,
                        args.reps, args.steps, args.device, trainer)
    if args.mode == "env_phases":
        return main_env_phases("pointfoot_rough", args.num_envs, iters,
                               args.steps, args.device, trainer)
    if args.mode == "train":
        return main_train(args.num_envs, iters, args.reps, args.device,
                          trainer)
    if args.mode == "mpc_ilqr":
        return main_mpc_ilqr(args.num_envs, iters, args.chunk, args.device,
                             trainer)
    return main_mpc(args.num_envs, iters, args.reps, args.solver,
                    args.device, trainer)


if __name__ == "__main__":
    main()
