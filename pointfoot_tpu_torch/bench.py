"""Benchmark of the SRB-MPC tick (the `main_mpc` of the JAX package's
bench.py).

    python -m pointfoot_tpu_torch.bench --mode mpc
    python -m pointfoot_tpu_torch.bench --mode mpc --solver plain
    python -m pointfoot_tpu_torch.bench --mode mpc --device cpu --num_envs 8

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline",
"conditions"}.  One tick = the batched Riccati re-plan and the leg-torque
mapping of every scenario: PointFoot, `--num_envs` scenarios (4096),
SRBConfig() (horizon 12), default pose at 0.62 m, zero commands.  The value
is scenario-solves/s, the median of `--reps` repetitions of `--iters` ticks
after a warm-up tick; vs_baseline = solves/s over real time, num_envs x
50 Hz.  `--solver kernel` (default) plans with the fused SRB-LQR kernel
(`SRBController.plan_tick_cuda`), `--solver plain` with the sequential
Riccati recursion (`plan_tick`).  Runs on the GPU unless --device names
another.  The other modes of bench.py are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.mpc.srb import SRBConfig, SRBController
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState

MODES = ("env", "mpc", "mpc_ilqr", "actuator_net", "train")
SOLVERS = ("kernel", "plain")


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


def main_mpc(num_envs: int = 4096, iters: int = 20, reps: int = 3,
             solver: str = "kernel", device=None) -> dict:
    """Time the tick and return (and print) the benchmark's record."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    device = resolve_device(device)
    ctrl, phys, cmd = make_mpc(num_envs, device)
    tick = ctrl.plan_tick_cuda if solver == "kernel" else ctrl.plan_tick

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tau, _ = tick(phys, cmd)
    sync()
    if not bool(torch.isfinite(tau).all()):
        raise RuntimeError("SRB-MPC tick returned non-finite torques")
    rates = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        for _ in range(iters):
            tau, _ = tick(phys, cmd)
        sync()
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
                       "card": card_line(device)},
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES, default="env")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--solver", choices=SOLVERS, default="kernel")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.mode != "mpc":
        raise NotImplementedError(
            f"bench mode '{args.mode}' is not ported yet (ROADMAP §1, "
            f"\"The rest\": a GPU bench for the other modes of bench.py); "
            f"only --mode mpc runs")
    return main_mpc(args.num_envs, args.iters, args.reps, args.solver,
                    args.device)


if __name__ == "__main__":
    main()
