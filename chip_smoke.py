"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the policy rollout of pointfoot_rough on
procedural terrain at 4096 envs, with the flagship actor:

1. device and build: the card's name and power limit, the CUDA kernels of
   pointfoot_tpu_torch/csrc/ built with nvcc (seconds, registers, spills);
2. kernels against their plain PyTorch versions on a state reached after
   20 policy steps, with a push queued: the full decimation rollout, one
   substep and the sphere FK, each within its stated tolerance; per-launch
   times of kernel and plain version, and the least time the card could
   take (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s);
3. the rollout at full width: 500 policy steps with the launch counters
   reset just before and read just after (they must be 1x and 4x the step
   count), env-steps/s and a per-layer time breakdown; then the regression
   probe (level 0, command vx 0.4 m/s, 6 s): falls <= num_envs and mean
   forward velocity >= 0.15 m/s.

The line before the last holds the kernels' JSON record, the one before it
the card's name and power limit, and the last line is the JSON
{"ok": true, "device": ...}.  Any failed check raises, so the exit code is
not 0 and no result line is printed.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.utils import policy_eval
from pointfoot_tpu_torch.utils.registry import make_env

NUM_ENVS = 4096
WARM_STEPS = 20
ROLLOUT_STEPS = 500
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SOURCE = "pointfoot_tpu_torch/csrc/substep.cu"
# tolerances of tests/test_pallas_substep.py:141-151 (kernel vs reference)
ROLLOUT_TOL = {"qvel": 2e-3, "base_lin_vel": 5e-4, "base_pos": 5e-5,
               "tau": 5e-3, "sphere_pos": 5e-5}
FORCE_ATOL, FORCE_RTOL = 0.05, 1e-3
FK_TOL = 2e-5


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ops that only move or view data; everything else counts one operation per
# output element
_MOVES = {"select", "slice", "view", "_unsafe_view", "reshape", "stack",
          "cat", "unbind", "expand", "clone", "_to_copy", "copy_", "empty",
          "empty_like", "full", "full_like", "zeros_like", "scalar_tensor",
          "lift_fresh", "detach", "alias", "t", "transpose", "permute",
          "unsqueeze", "squeeze", "as_strided", "contiguous"}


class _OpCount(TorchDispatchMode):
    """Counts the elementwise float operations a plain version performs."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _MOVES and \
                isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def count_ops(fn) -> int:
    with _OpCount() as c:
        fn()
    return c.ops


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def check_rollout(got, want):
    """Hold a kernel rollout (phys, tau, sphere_pos) to the plain one."""
    (gp, gt, gs), (wp, wt, ws) = got, want
    errs = {
        "qvel": max_err(gp.qvel, wp.qvel),
        "base_lin_vel": max_err(gp.base_lin_vel, wp.base_lin_vel),
        "base_pos": max_err(gp.base_pos, wp.base_pos),
        "tau": max_err(gt, wt),
        "sphere_pos": max_err(gs, ws),
    }
    for k, tol in ROLLOUT_TOL.items():
        if not errs[k] <= tol:
            raise AssertionError(f"rollout {k}: max |err| {errs[k]} > {tol}")
    f_err = (gp.contact_force - wp.contact_force).abs()
    f_tol = FORCE_ATOL + FORCE_RTOL * wp.contact_force.abs()
    if not bool((f_err <= f_tol).all()):
        raise AssertionError(
            f"rollout contact force: max |err| {float(f_err.max())} beyond "
            f"atol {FORCE_ATOL} + rtol {FORCE_RTOL}")
    errs["contact_force"] = float(f_err.max())
    for name in ("base_quat", "base_ang_vel", "qpos"):
        errs[name] = max_err(getattr(gp, name), getattr(wp, name))
    for v in errs.values():
        if not np.isfinite(v):
            raise AssertionError(f"non-finite rollout error {errs}")
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------- 1. device, build
    env = make_env("pointfoot_rough", num_envs=NUM_ENVS,
                   cfg_patch=policy_eval.FLAGSHIP_PATCH)
    mc = sp.model_consts(env.model)
    lib = build.load(mc)
    log(f"[build] {lib.path}: {lib.build_seconds:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")

    net = policy_eval.load_actor(env, "pointfoot_rough")
    policy = policy_eval.inference_policy(net)

    # ------------------------------------------ 2. kernels vs plain versions
    state = env.init_state(0)
    obs = torch.zeros(NUM_ENVS, env.num_obs, device=env.device)
    for _ in range(WARM_STEPS):
        state, out = env.step(state, policy(obs))
        obs = out.obs
    g = torch.Generator(device=env.device).manual_seed(5)
    push = 200.0 * (2.0 * torch.rand(NUM_ENVS, 3, generator=g,
                                     device=env.device) - 1.0)
    state = state.replace(push_force=push)
    actions = policy(obs)
    c = env.cfg.control
    roll_args = (env.model, state.params, state.physics, actions,
                 state.last_qvel, state.push_force, env.height_fn,
                 env.cfg.sim.dt, c.decimation, env.default_qpos_values,
                 c.action_scale, c.control_type, env.cfg.sim.gravity)
    got = sp.rollout_substeps(*roll_args)
    want = sp.rollout_substeps_plain(*roll_args)
    torch.cuda.synchronize()
    errs = check_rollout(got, want)
    log("[kernels] rollout_substeps kernel vs plain, max |err|: "
        + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))

    # one substep and the FK, at the main path's shapes
    state_rows = sp.pack_state(state.physics, state.last_qvel)
    ctrl_rows = sp.pack_ctrl(actions, state.params, state.push_force)
    xyz = sp.fk_rows_plain(mc, state_rows)
    surf_rows = sp.surface_rows(env.height_fn, xyz, mc.nc)
    step_args = (mc, state_rows, ctrl_rows, surf_rows, True,
                 env.default_qpos_values, c.action_scale, c.control_type,
                 env.cfg.sim.dt, env.cfg.sim.gravity)
    ks, ke = sp.rollout_step(*step_args)
    ps, pe = sp.rollout_step_plain(*step_args)
    nj, nc = mc.nj, mc.nc
    step_err = max(max_err(ks, ps), max_err(ke, pe))
    state_err = max_err(ks, ps)
    force_err = (ke[nj:nj + 3 * nc] - pe[nj:nj + 3 * nc]).abs()
    if not (state_err <= ROLLOUT_TOL["qvel"]
            and bool((force_err <= FORCE_ATOL + FORCE_RTOL
                      * pe[nj:nj + 3 * nc].abs()).all())
            and max_err(ke[:nj], pe[:nj]) <= ROLLOUT_TOL["tau"]
            and max_err(ke[nj + 3 * nc:], pe[nj + 3 * nc:])
            <= ROLLOUT_TOL["sphere_pos"]):
        raise AssertionError(f"rollout_step: state {state_err}, forces "
                             f"{float(force_err.max())}")
    fk_k = sp.fk_rows(mc, state_rows)
    fk_err = max_err(fk_k, xyz)
    if not fk_err <= FK_TOL:
        raise AssertionError(f"fk_rows: max |err| {fk_err} > {FK_TOL}")
    log(f"[kernels] rollout_substep max |err| {step_err:.3g} (state rows "
        f"{state_err:.3g}, forces {float(force_err.max()):.3g}); "
        f"fk_from_state max |err| {fk_err:.3g}")

    t = {
        "rollout_ms": cuda_ms(lambda: sp.rollout_step(*step_args), 200),
        "rollout_plain_ms": cuda_ms(lambda: sp.rollout_step_plain(*step_args),
                                    3, warmup=1),
        "fk_ms": cuda_ms(lambda: sp.fk_rows(mc, state_rows), 200),
        "fk_plain_ms": cuda_ms(lambda: sp.fk_rows_plain(mc, state_rows), 5,
                               warmup=1),
    }
    R_state, R_ctrl = state_rows.shape[0], ctrl_rows.shape[0]
    roll_bytes = 4 * NUM_ENVS * (R_state + R_ctrl + surf_rows.shape[0]
                                 + R_state + ke.shape[0])
    roll_ops = count_ops(lambda: sp.rollout_step_plain(*step_args))
    # the FK reads base_pos, base_quat and qpos (7 + nj rows) and writes
    # 3·nc rows
    fk_bytes = 4 * NUM_ENVS * (7 + nj + 3 * nc)
    fk_ops = count_ops(lambda: sp.fk_rows_plain(mc, state_rows))
    roll_bound, roll_by = bound(roll_bytes, roll_ops)
    fk_bound, fk_by = bound(fk_bytes, fk_ops)
    log(f"[kernels] rollout_substep: {t['rollout_ms']:.4f} ms/launch "
        f"(plain {t['rollout_plain_ms']:.2f} ms), {roll_bytes} B, "
        f"{roll_ops} ops, bound {roll_bound:.5f} ms by {roll_by}")
    log(f"[kernels] fk_from_state: {t['fk_ms']:.4f} ms/launch "
        f"(plain {t['fk_plain_ms']:.2f} ms), {fk_bytes} B, {fk_ops} ops, "
        f"bound {fk_bound:.5f} ms by {fk_by}")

    # ------------------------------------------- 3. rollout at full width
    state = env.init_state(1)
    obs = torch.zeros(NUM_ENVS, env.num_obs, device=env.device)
    state, out = env.step(state, policy(obs))
    obs = out.obs
    torch.cuda.synchronize()
    sp.reset_launch_counts()
    t0 = time.perf_counter()
    falls = torch.zeros((), dtype=torch.int64, device=env.device)
    for _ in range(ROLLOUT_STEPS):
        state, out = env.step(state, policy(obs))
        obs = out.obs
        falls += out.extras["terminate"].sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rollout_substep": sp.rollout_step.launches,
                "fk_from_state": sp.fk_rows.launches}
    expect = {"rollout_substep": c.decimation * ROLLOUT_STEPS,
              "fk_from_state": ROLLOUT_STEPS}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    for name in ("base_pos", "base_quat", "qpos", "qvel"):
        if not bool(torch.isfinite(getattr(state.physics, name)).all()):
            raise AssertionError(f"non-finite {name} after the rollout")
    if obs.shape != (NUM_ENVS, env.num_obs) or \
            not bool(torch.isfinite(obs).all()):
        raise AssertionError("observations not finite or misshapen")
    step_ms = wall / ROLLOUT_STEPS * 1e3
    log(f"[rollout] {ROLLOUT_STEPS} steps x {NUM_ENVS} envs in {wall:.2f} s: "
        f"{ROLLOUT_STEPS * NUM_ENVS / wall:.0f} env-steps/s, "
        f"{step_ms:.2f} ms/step, terminations {int(falls)}, "
        f"launches {launches}")

    # where a step's time goes, by layer (CUDA events, same state)
    acts = policy(obs)
    layers = {
        "env.step": cuda_ms(lambda: env.step(state, acts), 10),
        "policy": cuda_ms(lambda: policy(obs), 20),
        "physics rollout (kernels + surface queries)": cuda_ms(
            lambda: env._physics_rollout(state, acts), 10),
        "surface query (one substep)": cuda_ms(
            lambda: sp.surface_rows(env.height_fn, xyz, mc.nc), 10),
        "height scan (121 points)": cuda_ms(
            lambda: env._measured_heights(state.physics), 10),
    }
    kernel_ms = c.decimation * t["rollout_ms"] + t["fk_ms"]
    log("[layers] ms: " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()})
        + f"; kernels {kernel_ms:.3f} ms/step = "
        f"{100 * kernel_ms / layers['env.step']:.2f}% of env.step")

    probe_env = policy_eval.make_eval_env(
        "pointfoot_rough", NUM_ENVS, policy_eval.FLAGSHIP_PATCH)
    rec = policy_eval.eval_config(probe_env, policy, 0, 0.4, secs=6.0)
    log(f"[probe] {json.dumps(rec)}")
    if not (rec["falls"] <= NUM_ENVS and rec["mean_vx"] >= 0.15):
        raise AssertionError(f"probe outside its band: {rec}")

    kernels = [
        {"name": "rollout_substep_kernel", "route": "cuda", "source": SOURCE,
         "replaces": "pointfoot_tpu/ops/pallas/substep.py:273",
         "launches": launches["rollout_substep"], "max_abs_err": step_err,
         "ms": t["rollout_ms"], "plain_ms": t["rollout_plain_ms"],
         "bound_ms": roll_bound, "bound_by": roll_by, "library_ms": None},
        {"name": "fk_from_state_kernel", "route": "cuda", "source": SOURCE,
         "replaces": "pointfoot_tpu/ops/pallas/substep.py:328",
         "launches": launches["fk_from_state"], "max_abs_err": fk_err,
         "ms": t["fk_ms"], "plain_ms": t["fk_plain_ms"],
         "bound_ms": fk_bound, "bound_by": fk_by, "library_ms": None},
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
