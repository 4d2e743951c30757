"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three main paths at full width: the policy rollout of
pointfoot_rough (fused rollout kernels) and the actuator-net task
anymal_c_rough (physics/dynamics.step_batched and its kernels), both on
procedural terrain at 4096 envs, and the SRB-MPC tick of PointFoot at 4096
scenarios (the fused SRB-LQR kernel).

1. device and build: the card's name and power limit; the PointFoot,
   ANYmal, A1, Cholesky and Riccati libraries of pointfoot_tpu_torch/csrc/
   built by parallel nvcc processes (seconds, registers, spills);
2. PointFoot kernels against their plain PyTorch versions on a state
   reached after 20 policy steps, with a push queued: the full decimation
   rollout, one rollout substep and the sphere FK, each within its stated
   tolerance;
3. step_batched's kernels against their plain versions on an anymal_c_rough
   state reached after 20 steps of the bench action signal, with a push
   queued: the mega-kernel route (sphere-xy FK, surface query, substep
   kernel) against the plain path, the FK-xy kernel against its twin, and
   the Cholesky kernel against ops/linalg.chol_solve on the velocity
   systems of 2048 ANYmal and 2048 PointFoot envs;
   for every kernel: per-launch time of kernel and plain version by CUDA
   events, and the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s); the Cholesky kernel also beside
   torch.linalg.cholesky + torch.cholesky_solve;
4. the PointFoot rollout at full width: 500 policy steps with the launch
   counters reset just before and read just after (1x and 4x the step
   count), env-steps/s, a per-layer breakdown and the regression probe
   (level 0, command vx 0.4 m/s, 6 s): falls <= num_envs and mean forward
   velocity >= 0.15 m/s;
5. anymal_c_rough at full width: 200 steps of the bench signal (substep and
   FK-xy kernels 4x the step count each, the other kernels 0), env-steps/s,
   a per-layer breakdown, and the physical gate (level 0, zero actions, no
   pushes, 2 s) inside the band the JAX package gives;
6. anymal_c_rough at 2048 envs, the Cholesky route: 25 steps, Cholesky
   kernel 4x the step count, substep kernel 0;
7. the SRB-LQR kernel against its plain version at 4096 and 1000
   scenarios, on the PointFoot tick's own problems (m = 6), A1's (m = 12)
   and random dense problems, horizon 12; its per-launch time, bound, and
   the time of the sequential Riccati solver on the same problems;
8. the SRB-MPC tick at full width through pointfoot_tpu_torch.bench: 4096
   PointFoot scenarios, horizon 12, one SRB-LQR launch per tick and no
   other kernel, solves/s against real time (50 Hz), a per-layer
   breakdown, and the kernel tick against the sequential-solver tick on
   the same states;
9. the closed-loop gate: 4096 A1 scenarios on flat ground, a lateral
   0.3 m/s perturbation, 50 ticks of the kernel tick with 4 substeps of
   leg_torques and dynamics.step_batched each: every base stays above
   0.2 m, upright, and comes to rest.

The line before the last holds the kernels' JSON record, the one before it
the card's name and power limit, and the last line is the JSON
{"ok": true, "device": ...}.  Any failed check raises, so the exit code is
not 0 and no result line is printed.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pointfoot_tpu_torch import bench
from pointfoot_tpu_torch.mpc import srb
from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda import cholesky as ch
from pointfoot_tpu_torch.ops.cuda import riccati as rk
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.physics import actuator as act
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.contact import query_surface
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.utils import policy_eval
from pointfoot_tpu_torch.utils.registry import make_env

NUM_ENVS = 4096
CHOL_ENVS = 2048
WARM_STEPS = 20
ROLLOUT_STEPS = 500
ANYMAL_STEPS = 200
CHOL_STEPS = 25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SUBSTEP_SRC = "pointfoot_tpu_torch/csrc/substep.cu"
CHOL_SRC = "pointfoot_tpu_torch/csrc/cholesky.cu"
RICCATI_SRC = "pointfoot_tpu_torch/csrc/riccati.cu"
# tolerances of tests/test_pallas_substep.py:141-151 (rollout vs reference)
ROLLOUT_TOL = {"qvel": 2e-3, "base_lin_vel": 5e-4, "base_pos": 5e-5,
               "tau": 5e-3, "sphere_pos": 5e-5}
FORCE_ATOL, FORCE_RTOL = 0.05, 1e-3
FK_TOL = 2e-5
# tolerances of tests/test_pallas_substep.py:50-60 (one substep vs
# step_batched): (atol, rtol) per state field
STEP_TOL = {"base_lin_vel": (3e-4, 3e-4), "base_ang_vel": (3e-4, 3e-4),
            "qvel": (1e-3, 3e-4), "base_pos": (2e-5, 0.0),
            "base_quat": (2e-5, 0.0), "qpos": (2e-5, 0.0),
            "contact_force": (0.1, 1e-3)}
CHOL_TOL = 3e-3  # rtol and atol, tests/test_pallas.py:24
ANYMAL_PATCH = dict(terrain=dict(procedural=True))
# The physical gate: anymal_c_rough on level 0 of procedural terrain
# without the discrete-obstacle family, zero actions, no pushes, 2 s.  The
# JAX package on the CPU gives, at 8 envs (tests/test_torch_physical_gate.py
# recomputes it and holds it inside these bands): a mean base height above
# the terrain under the base of 0.351 m at 2 s (envs 0.278-0.425 m), no
# terminations.
GATE_PATCH = dict(
    terrain=dict(procedural=True, max_init_terrain_level=0,
                 terrain_proportions=(0.1, 0.1, 0.35, 0.45)),
    domain_rand=dict(push_robots=False), noise=dict(add_noise=False))
GATE_STEPS = 100  # 2 s at the 50 Hz policy rate
GATE_MEAN_HEIGHT = (0.25, 0.45)  # m
GATE_MAX_TERMINATED = 0.02  # share of envs
# SRB-MPC: kernel vs plain version, tests/test_pallas.py:77-78; kernel tick
# vs sequential-solver tick, tests/test_srb_pallas.py:41-45
LQR_TOL = 2e-3  # rtol and atol
LQR_RAGGED = 1000  # a batch whose last block has idle threads
TICK_TAU_TOL = (2e-3, 2e-2)  # (rtol, atol), N·m
TICK_FORCE_TOL = (2e-3, 5e-2)  # (rtol, atol), N
MPC_ITERS, MPC_REPS = 20, 3
A1_QDEF = (-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 1.0, -1.5, 0.1, 1.0, -1.5)
# the closed-loop recipe of tests/test_srb.py:45-92
SRB_GATE_CFG = dict(height_target=0.28, w_vel=1.0, w_height=10.0,
                    w_orient=5.0, w_omega=0.5, w_force_normal=1e-3,
                    w_force_tangent=2e-2, kp_swing=20.0, kd_swing=0.5)
SRB_GATE_TICKS, SRB_GATE_SUBSTEPS, SRB_GATE_DT = 50, 4, 0.005


def log(*args):
    print(*args, flush=True)


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


def reset_counts():
    sp.reset_launch_counts()
    ch.chol_solve_lanes.launches = 0
    rk.srb_lqr_lanes.launches = 0


def read_counts() -> dict:
    return {"rollout_substep": sp.rollout_step.launches,
            "fk_from_state": sp.fk_rows.launches,
            "substep": sp.step_rows.launches,
            "fk_contact_xy": sp.fk_xy_rows.launches,
            "chol_solve": ch.chol_solve_lanes.launches,
            "srb_lqr": rk.srb_lqr_lanes.launches}


def expect_counts(got: dict, **want):
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"launch counts {got} != {full}")


def kernel_record(name, source, replaces, launches, err, ms, plain_ms,
                  nbytes, ops, library_ms=None):
    b_ms, b_by = bound(nbytes, ops)
    log(f"[kernels] {name}: {ms:.4f} ms/launch (plain {plain_ms:.2f} ms"
        + ("" if library_ms is None else f", library {library_ms:.4f} ms")
        + f"), {nbytes} B, {ops} ops, bound {b_ms:.5f} ms by {b_by}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def slice_batch(obj, n: int):
    """The first n envs of a PhysicsState or PhysicsParams."""
    cls = type(obj)
    return cls(**{f: getattr(obj, f)[:n] for f in cls.__dataclass_fields__})


def check_finite(state, obs, num_envs, num_obs, what):
    for name in ("base_pos", "base_quat", "qpos", "qvel"):
        if not bool(torch.isfinite(getattr(state.physics, name)).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    if obs.shape != (num_envs, num_obs) or \
            not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"{what}: observations not finite or misshapen")


# ------------------------------------------------------------ 1. build

def build_kernels(mc_pf, mc_any, mc_a1):
    specs = [build.model_spec(mc_pf), build.model_spec(mc_any),
             build.model_spec(mc_a1), build.CHOLESKY_SPEC,
             build.RICCATI_SPEC]
    t0 = time.perf_counter()
    libs = build.build_all(specs)
    log(f"[build] {len(specs)} libraries in {time.perf_counter() - t0:.2f} "
        f"s wall (parallel nvcc)")
    for what, lib in zip(("PointFoot substep.cu", "ANYmal substep.cu",
                          "A1 substep.cu", "cholesky.cu", "riccati.cu"),
                         libs):
        log(f"[build] {what}: {lib.path}: {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")


# ------------------------------------------ 2. PointFoot kernels vs plain

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


def pointfoot_kernels(env, mc, policy):
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

    R_state, R_ctrl = state_rows.shape[0], ctrl_rows.shape[0]
    roll = dict(
        err=step_err, ms=cuda_ms(lambda: sp.rollout_step(*step_args), 200),
        plain_ms=cuda_ms(lambda: sp.rollout_step_plain(*step_args), 3,
                         warmup=1),
        nbytes=4 * NUM_ENVS * (R_state + R_ctrl + surf_rows.shape[0]
                               + R_state + ke.shape[0]),
        ops=count_ops(lambda: sp.rollout_step_plain(*step_args)))
    # the FK reads base_pos, base_quat and qpos (7 + nj rows) and writes
    # 3·nc rows
    fk = dict(
        err=fk_err, ms=cuda_ms(lambda: sp.fk_rows(mc, state_rows), 200),
        plain_ms=cuda_ms(lambda: sp.fk_rows_plain(mc, state_rows), 5,
                         warmup=1),
        nbytes=4 * NUM_ENVS * (7 + nj + 3 * nc),
        ops=count_ops(lambda: sp.fk_rows_plain(mc, state_rows)))
    return roll, fk, state, xyz


# ------------------------------------ 3. step_batched's kernels vs plain

def bench_signal(env, seed: int = 0):
    """bench.py's deterministic action signal 0.2 sin(phase + 0.1 t)."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    phase = 6.28 * torch.rand(env.num_envs, env.num_actions, generator=g,
                              device=env.device)
    return lambda t: 0.2 * torch.sin(phase + 0.1 * t)


def step_errors(got: PhysicsState, want: PhysicsState):
    """Per field: (max |err|, largest share of the allowed error) and the
    (B,) mask of envs beyond STEP_TOL."""
    out, beyond = {}, None
    for name, (atol, rtol) in STEP_TOL.items():
        g, w = getattr(got, name), getattr(want, name)
        err = (g - w).abs()
        share = (err / (atol + rtol * w.abs())).reshape(g.shape[0], -1)
        out[name] = (float(err.max()), float(share.max()))
        over = (share > 1.0).any(-1)
        beyond = over if beyond is None else beyond | over
    return out, beyond


def sphere_surface(env, phys, params):
    """The surface under each sphere where the plain path queries it: at
    positions from dynamics.forward_kinematics, in world coordinates."""
    m = env.model
    kin = dynamics.forward_kinematics(m, phys, params)
    p = torch.stack([kin.body_pos[:, b] + kin.body_rot[:, b]
                     @ m.collision_offset[c]
                     for c, b in enumerate(m.collision_body)], dim=1)
    return query_surface(env.height_fn, p[..., 0], p[..., 1])


def velocity_system(env, phys, params, tau):
    """(A_t (nv·nv, B), b_t (nv, B)) that assemble_velocity_solve builds."""
    A, rhs, _ = dynamics.assemble_velocity_solve(
        env.model, params, phys, tau, env.height_fn, env.cfg.sim.dt,
        torch.zeros_like(phys.base_pos), None, env.cfg.sim.gravity)
    B, nv = rhs.shape
    return A.reshape(B, nv * nv).t().contiguous(), rhs.t().contiguous()


def check_cholesky(A_t, b_t, what):
    x_k = ch.chol_solve_lanes(A_t, b_t)
    x_p = ch.chol_solve_lanes_plain(A_t, b_t)
    torch.cuda.synchronize()
    err = (x_k - x_p).abs()
    share = float((err / (CHOL_TOL + CHOL_TOL * x_p.abs())).max())
    if not share <= 1.0:
        raise AssertionError(f"chol_solve {what}: max |err| "
                             f"{float(err.max())} beyond rtol/atol {CHOL_TOL}")
    log(f"[kernels] chol_solve {what}: max |err| {float(err.max()):.3g} "
        f"({100 * share:.2g}% of the tolerance)")
    return float(err.max())


def anymal_kernels(env, mc, pf_env, pf_state):
    dev = env.device
    signal = bench_signal(env)
    state = env.init_state(0)
    for t in range(WARM_STEPS):
        state, _ = env.step(state, signal(t))
    g = torch.Generator(device=dev).manual_seed(6)
    push = 200.0 * (2.0 * torch.rand(NUM_ENVS, 3, generator=g,
                                     device=dev) - 1.0)
    phys, params = state.physics, state.params
    c = env.cfg.control
    pos_err = signal(WARM_STEPS) * c.action_scale + env.default_qpos \
        - phys.qpos
    tau, _ = act.actuator_net_torque(env.actuator_weights,
                                     state.actuator_carry, pos_err,
                                     phys.qvel)
    tau = torch.clamp(tau, -env.torque_limit, env.torque_limit)
    dt, grav = env.cfg.sim.dt, env.cfg.sim.gravity

    # the mega-kernel route against the plain path on the same device and
    # state, and the same terrain under each sphere: the route's query at
    # the FK-xy kernel's positions
    got = dynamics.step_batched(env.model, params, phys, tau, env.height_fn,
                                dt, external_force=push, gravity=grav)
    xy = sp.fk_contact_xy(env.model, phys)
    surface = query_surface(env.height_fn, xy[..., 0], xy[..., 1])
    want = dynamics.step(env.model, params, phys, tau, env.height_fn, dt,
                         external_force=push, gravity=grav, surface=surface)
    torch.cuda.synchronize()
    route, beyond = step_errors(got, want)
    log("[kernels] step_batched mega-kernel route vs plain path, same "
        "surface, max |err| (share of tolerance): " + json.dumps(
            {k: f"{e:.3g} ({100 * s:.2g}%)" for k, (e, s) in route.items()}))
    if bool(beyond.any()):
        raise AssertionError(f"step_batched: {int(beyond.sum())} envs beyond "
                             f"the tolerances {STEP_TOL}: {route}")
    # the plain path querying the terrain itself places each sphere in world
    # coordinates, a few ulp (~1e-5 m at 100 m) from the route's base-
    # relative FK: every env that then leaves the tolerance must be one
    # whose terrain under a sphere differs between the two queries
    own = dynamics.step(env.model, params, phys, tau, env.height_fn, dt,
                        external_force=push, gravity=grav)
    h_own, n_own = sphere_surface(env, phys, params)
    d_h = (h_own - surface[0]).abs().amax(-1)
    d_n = (n_own - surface[1]).abs().amax((-1, -2))
    moved = (d_h > 1e-6) | (d_n > 1e-6)
    _, beyond_own = step_errors(got, own)
    if bool((beyond_own & ~moved).any()):
        raise AssertionError(
            f"step_batched vs the plain path's own terrain query: "
            f"{int((beyond_own & ~moved).sum())} envs beyond the tolerances "
            f"with the same terrain under every sphere")
    log(f"[kernels] step_batched vs the plain path's own terrain query: "
        f"{int(beyond_own.sum())} of {NUM_ENVS} envs beyond the tolerances, "
        f"all with other terrain under a sphere ({int(moved.sum())} envs "
        f"see a height or normal >1e-6 apart; {int((d_n > 0.1).sum())} a "
        f"normal flipped at a cell edge)")

    # the substep kernel against its plain twin on the same rows
    in_rows = sp.pack_substep_in(phys, params, tau, push)
    surf_rows = sp.pack_surface(surface)
    k_rows = sp.step_rows(mc, in_rows, surf_rows, dt, grav)
    p_rows = sp.step_rows_plain(mc, in_rows, surf_rows, dt, grav)
    fk_in = sp.pack_fk_in(phys)
    xy_k = sp.fk_xy_rows(mc, fk_in)
    xy_p = sp.fk_xy_rows_plain(mc, fk_in)
    torch.cuda.synchronize()
    sub_err = max_err(k_rows, p_rows)
    xy_err = max_err(xy_k, xy_p)
    if not xy_err <= FK_TOL:
        raise AssertionError(f"fk_contact_xy: max |err| {xy_err} > {FK_TOL}")
    nj, nc = mc.nj, mc.nc
    n_state = 13 + 2 * nj
    log(f"[kernels] substep kernel vs plain twin, max |err| {sub_err:.3g} "
        f"(state rows {max_err(k_rows[:n_state], p_rows[:n_state]):.3g}); "
        f"fk_contact_xy max |err| {xy_err:.3g}")

    sub = dict(
        err=sub_err,
        ms=cuda_ms(lambda: sp.step_rows(mc, in_rows, surf_rows, dt, grav),
                   200),
        plain_ms=cuda_ms(lambda: sp.step_rows_plain(
            mc, in_rows, surf_rows, dt, grav), 2, warmup=1),
        nbytes=4 * NUM_ENVS * (in_rows.shape[0] + surf_rows.shape[0]
                               + k_rows.shape[0]),
        ops=count_ops(lambda: sp.step_rows_plain(mc, in_rows, surf_rows, dt,
                                                 grav)))
    fkxy = dict(
        err=xy_err, ms=cuda_ms(lambda: sp.fk_xy_rows(mc, fk_in), 200),
        plain_ms=cuda_ms(lambda: sp.fk_xy_rows_plain(mc, fk_in), 5,
                         warmup=1),
        nbytes=4 * NUM_ENVS * (7 + nj + 2 * nc),
        ops=count_ops(lambda: sp.fk_xy_rows_plain(mc, fk_in)))

    # the Cholesky kernel on the velocity systems of 2048 envs of each robot
    n = CHOL_ENVS
    A_t, b_t = velocity_system(env, slice_batch(phys, n),
                               slice_batch(params, n), tau[:n])
    chol_err = check_cholesky(A_t, b_t, f"ANYmal n=18 B={n}")
    pf_A, pf_b = velocity_system(
        pf_env, slice_batch(pf_state.physics, n),
        slice_batch(pf_state.params, n), pf_state.torques[:n])
    chol_err = max(chol_err,
                   check_cholesky(pf_A, pf_b, f"PointFoot n=12 B={n}"))
    nv = 18
    A = A_t.t().reshape(n, nv, nv).contiguous()
    b = b_t.t().contiguous()

    def library():
        return torch.cholesky_solve(b[..., None], torch.linalg.cholesky(A))

    chol = dict(
        err=chol_err, ms=cuda_ms(lambda: ch.chol_solve_lanes(A_t, b_t), 200),
        plain_ms=cuda_ms(lambda: ch.chol_solve_lanes_plain(A_t, b_t), 5,
                         warmup=1),
        nbytes=4 * n * (nv * nv + 2 * nv),
        ops=count_ops(lambda: ch.chol_solve_lanes_plain(A_t, b_t)),
        library_ms=cuda_ms(library, 50))
    pf_ms = cuda_ms(lambda: ch.chol_solve_lanes(pf_A, pf_b), 200)
    log(f"[kernels] chol_solve at PointFoot n=12 B={n}: {pf_ms:.4f} "
        f"ms/launch")
    layers_in = dict(state=state, signal=signal, xy=xy, tau=tau, push=push)
    return sub, fkxy, chol, layers_in


# ---------------------------------------------- 4. PointFoot at full width

def pointfoot_rollout(env, mc, policy, xyz):
    c = env.cfg.control
    state = env.init_state(1)
    obs = torch.zeros(NUM_ENVS, env.num_obs, device=env.device)
    state, out = env.step(state, policy(obs))
    obs = out.obs
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    falls = torch.zeros((), dtype=torch.int64, device=env.device)
    for _ in range(ROLLOUT_STEPS):
        state, out = env.step(state, policy(obs))
        obs = out.obs
        falls += out.extras["terminate"].sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(launches, rollout_substep=c.decimation * ROLLOUT_STEPS,
                  fk_from_state=ROLLOUT_STEPS)
    check_finite(state, obs, NUM_ENVS, env.num_obs, "pointfoot rollout")
    step_ms = wall / ROLLOUT_STEPS * 1e3
    log(f"[rollout] pointfoot_rough {ROLLOUT_STEPS} steps x {NUM_ENVS} envs "
        f"in {wall:.2f} s: {ROLLOUT_STEPS * NUM_ENVS / wall:.0f} "
        f"env-steps/s, {step_ms:.2f} ms/step, terminations {int(falls)}, "
        f"launches {launches}")

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
    log("[layers] pointfoot_rough ms: " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))

    probe_env = policy_eval.make_eval_env(
        "pointfoot_rough", NUM_ENVS, policy_eval.FLAGSHIP_PATCH)
    rec = policy_eval.eval_config(probe_env, policy, 0, 0.4, secs=6.0)
    log(f"[probe] {json.dumps(rec)}")
    if not (rec["falls"] <= NUM_ENVS and rec["mean_vx"] >= 0.15):
        raise AssertionError(f"probe outside its band: {rec}")
    return launches


# -------------------------------------------- 5. anymal_c_rough, 4096 envs

def anymal_rollout(env, lay):
    c = env.cfg.control
    signal = lay["signal"]
    state = env.init_state(1)
    state, out = env.step(state, signal(0))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    falls = torch.zeros((), dtype=torch.int64, device=env.device)
    for t in range(1, ANYMAL_STEPS + 1):
        state, out = env.step(state, signal(t))
        falls += out.extras["terminate"].sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(launches, substep=c.decimation * ANYMAL_STEPS,
                  fk_contact_xy=c.decimation * ANYMAL_STEPS)
    check_finite(state, out.obs, NUM_ENVS, env.num_obs, "anymal rollout")
    if not bool(torch.isfinite(out.reward).all()):
        raise AssertionError("anymal rollout: non-finite reward")
    log(f"[anymal] anymal_c_rough {ANYMAL_STEPS} steps x {NUM_ENVS} envs in "
        f"{wall:.2f} s: {ANYMAL_STEPS * NUM_ENVS / wall:.0f} env-steps/s, "
        f"{wall / ANYMAL_STEPS * 1e3:.2f} ms/step, terminations "
        f"{int(falls)}, launches {launches}")

    # where a step's time goes, by layer (CUDA events, same state)
    phys, params = state.physics, state.params
    a = signal(0)
    pos_err = a * c.action_scale + env.default_qpos - phys.qpos
    xy = lay["xy"]
    layers = {
        "env.step": cuda_ms(lambda: env.step(state, a), 10),
        "actuator net (one substep)": cuda_ms(
            lambda: act.actuator_net_torque(
                env.actuator_weights, state.actuator_carry, pos_err,
                phys.qvel), 20),
        "step_batched (kernels + surface query, one substep)": cuda_ms(
            lambda: dynamics.step_batched(
                env.model, params, phys, lay["tau"], env.height_fn,
                env.cfg.sim.dt, external_force=lay["push"],
                gravity=env.cfg.sim.gravity), 20),
        "surface query (13 spheres)": cuda_ms(
            lambda: query_surface(env.height_fn, xy[..., 0], xy[..., 1]),
            20),
        "height scan (187 points)": cuda_ms(
            lambda: env._measured_heights(phys), 10),
    }
    log("[layers] anymal_c_rough ms: " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))
    return launches


def physical_gate():
    env = make_env("anymal_c_rough", num_envs=NUM_ENVS, cfg_patch=GATE_PATCH)
    state = env.init_state(2)
    zeros = torch.zeros(NUM_ENVS, env.num_actions, device=env.device)
    terminated = torch.zeros(NUM_ENVS, dtype=torch.bool, device=env.device)
    for _ in range(GATE_STEPS):
        state, out = env.step(state, zeros)
        terminated |= out.extras["terminate"]
    p = state.physics.base_pos
    h = p[:, 2] - env.terrain.height_at(p[:, 0], p[:, 1])
    rec = {"mean_height": float(h.mean()), "min_height": float(h.min()),
           "terminated": float(terminated.float().mean()),
           "levels": sorted({int(v) for v in state.terrain_level})}
    log(f"[gate] anymal_c_rough level 0, zero actions, 2 s: "
        f"{json.dumps(rec)}")
    lo, hi = GATE_MEAN_HEIGHT
    if not (lo <= rec["mean_height"] <= hi
            and rec["terminated"] <= GATE_MAX_TERMINATED):
        raise AssertionError(f"physical gate outside its band: {rec}")


# ---------------------------------- 6. the Cholesky route, 2048 envs

def cholesky_route():
    env = make_env("anymal_c_rough", num_envs=CHOL_ENVS,
                   cfg_patch=ANYMAL_PATCH)
    signal = bench_signal(env)
    state = env.init_state(3)
    state, _ = env.step(state, signal(0))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for t in range(1, CHOL_STEPS + 1):
        state, out = env.step(state, signal(t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(launches,
                  chol_solve=env.cfg.control.decimation * CHOL_STEPS)
    check_finite(state, out.obs, CHOL_ENVS, env.num_obs, "cholesky route")
    log(f"[cholesky-route] anymal_c_rough {CHOL_STEPS} steps x {CHOL_ENVS} "
        f"envs in {wall:.2f} s: {CHOL_STEPS * CHOL_ENVS / wall:.0f} "
        f"env-steps/s, {wall / CHOL_STEPS * 1e3:.2f} ms/step, launches "
        f"{launches}")
    return launches


# ------------------------------------------ 7. the SRB-LQR kernel vs plain

def mpc_scenarios(ctrl, num: int, qdef, height: float, seed: int):
    """`num` scenarios at the default pose with a seeded velocity
    perturbation and commands; 30 N on every foot, and on none in every
    fourth scenario, which the contact gate turns back into full stance."""
    dev = ctrl.default_qpos.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    phys = PhysicsState.default(ctrl.model, qdef, num, dev,
                                base_height=height)
    force = torch.zeros_like(phys.contact_force)
    force[:, list(ctrl.feet_idx), 2] = 30.0
    force[::4] = 0.0
    lin = 0.1 * randn(num, 3)
    lin[:, 1] += 0.2
    phys = phys.replace(base_lin_vel=lin, base_ang_vel=0.1 * randn(num, 3),
                        qvel=0.2 * randn(num, ctrl.model.nj),
                        contact_force=force)
    return phys, 0.3 * randn(num, 3)


def dense_problem(m: int, num: int, seed: int, device):
    """The random dense problem of tests/test_pallas.py:60-72 at `num`
    scenarios: F perturbed everywhere."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    n = 12
    F = torch.eye(n, device=device).repeat(num, 1, 1)
    eye3 = torch.eye(3, device=device)
    F[:, 0:3, 6:9] += 0.02 * eye3
    F[:, 3:6, 9:12] += 0.02 * eye3
    F += 0.01 * randn(num, n, n)
    Xd = randn(num, n).abs() + 0.5
    return (F, 0.05 * randn(num, n), 0.1 * randn(num, n, m), Xd,
            randn(num, m).abs() * 0.01 + 0.005, 2.0 * Xd, randn(num, n),
            randn(num, m))


def check_srb_lqr(staged, horizon: int, what: str) -> float:
    """Hold the kernel to its plain version on staged problems, at the full
    batch and at its first LQR_RAGGED scenarios."""
    worst = 0.0
    for num in (staged[1].shape[1], LQR_RAGGED):
        part = tuple(t[:, :num].contiguous() for t in staged)
        got = rk.srb_lqr_lanes(*part, horizon)
        want = rk.srb_lqr_lanes_plain(*part, horizon)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"srb_lqr {what} B={num}: shape "
                                 f"{tuple(got.shape)} or non-finite forces")
        err = (got - want).abs()
        share = float((err / (LQR_TOL + LQR_TOL * want.abs())).max())
        if not share <= 1.0:
            raise AssertionError(
                f"srb_lqr {what} B={num}: max |err| {float(err.max())} "
                f"beyond rtol/atol {LQR_TOL}")
        log(f"[kernels] srb_lqr {what} B={num}: max |err| "
            f"{float(err.max()):.3g} of forces up to "
            f"{float(want.abs().max()):.3g} ({100 * share:.2g}% of the "
            f"tolerance)")
        worst = max(worst, float(err.max()))
    return worst


def riccati_kernels(pf_ctrl, a1_ctrl):
    dev = pf_ctrl.default_qpos.device
    T = pf_ctrl.cfg.horizon
    pf_phys, pf_cmd = mpc_scenarios(pf_ctrl, NUM_ENVS, [0.0] * 6, 0.62, 7)
    pf_prob = pf_ctrl.tick_problem(pf_phys, pf_cmd)[0]
    pf_staged = rk.stage(*pf_prob)
    err = check_srb_lqr(pf_staged, T, "PointFoot tick problems m=6")
    a1_phys, a1_cmd = mpc_scenarios(a1_ctrl, NUM_ENVS, A1_QDEF, 0.28, 8)
    a1_staged = rk.stage(*a1_ctrl.tick_problem(a1_phys, a1_cmd)[0])
    err = max(err, check_srb_lqr(a1_staged, T, "A1 tick problems m=12"))
    for m in rk.SIZES:
        dense = rk.stage(*dense_problem(m, NUM_ENVS, 9 + m, dev))
        err = max(err, check_srb_lqr(dense, T, f"random dense m={m}"))

    # per launch, at the main path's shapes: the PointFoot problems
    n, m = 12, pf_staged[4].shape[0]
    rec = dict(
        err=err, ms=cuda_ms(lambda: rk.srb_lqr_lanes(*pf_staged, T), 100),
        plain_ms=cuda_ms(lambda: rk.srb_lqr_lanes_plain(*pf_staged, T), 3,
                         warmup=1),
        nbytes=4 * NUM_ENVS * (n * n + n * m + 4 * n + 2 * m + T * m),
        ops=count_ops(lambda: rk.srb_lqr_lanes_plain(*pf_staged, T)))
    a1_ms = cuda_ms(lambda: rk.srb_lqr_lanes(*a1_staged, T), 50)
    seq_ms = cuda_ms(lambda: srb.sequential_srb_lqr(*pf_prob, horizon=T), 3,
                     warmup=1)
    log(f"[kernels] srb_lqr at A1 m=12 B={NUM_ENVS}: {a1_ms:.4f} ms/launch")
    log(f"[kernels] sequential Riccati solver (plan_tick's) on the PointFoot "
        f"problems: {seq_ms:.2f} ms (no single PyTorch call computes the "
        f"solve: library_ms is null)")
    return rec


# ------------------------------------------------ 8. the SRB-MPC tick

def check_close(got, want, rtol, atol, what):
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    if not share <= 1.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} beyond "
                             f"rtol {rtol} / atol {atol}")
    return float(err.max()), share


def mpc_tick(pf_ctrl, kernel_ms: float):
    torch.cuda.synchronize()
    reset_counts()
    rec = bench.main_mpc(NUM_ENVS, iters=MPC_ITERS, reps=MPC_REPS,
                         solver="kernel")
    launches = read_counts()
    ticks = 1 + MPC_ITERS * MPC_REPS  # the warm-up tick and the timed ones
    expect_counts(launches, srb_lqr=ticks)
    if rec["metric"] != f"srb_mpc_scenario_solves_per_sec@{NUM_ENVS}" or \
            rec["conditions"]["horizon"] != 12 or not rec["value"] > 0:
        raise AssertionError(f"bench record {rec}")
    log(f"[mpc] SRB-MPC tick, PointFoot, {NUM_ENVS} scenarios, horizon "
        f"{rec['conditions']['horizon']}: {rec['value']:.0f} solves/s, "
        f"{NUM_ENVS / rec['value'] * 1e3:.2f} ms/tick, "
        f"{rec['vs_baseline']:.4f} x real time ({NUM_ENVS} x 50 Hz), "
        f"launches {launches}")

    cfg = pf_ctrl.cfg
    phys, cmd = mpc_scenarios(pf_ctrl, NUM_ENVS, [0.0] * 6, 0.62, 17)
    tau_k, fs_k = pf_ctrl.plan_tick_cuda(phys, cmd)
    tau_p, plan = pf_ctrl.plan_tick(phys, cmd)
    torch.cuda.synchronize()
    nf = len(pf_ctrl.feet_idx)
    if tau_k.shape != (NUM_ENVS, pf_ctrl.model.nj) or \
            fs_k.shape != (NUM_ENVS, cfg.horizon, nf, 3):
        raise AssertionError(f"tick shapes {tuple(tau_k.shape)}, "
                             f"{tuple(fs_k.shape)}")
    tau_err, tau_share = check_close(tau_k, tau_p, *TICK_TAU_TOL,
                                     "kernel tick vs plain tick, torques")
    f_err, f_share = check_close(fs_k[:, 0], plan.forces[:, 0],
                                 *TICK_FORCE_TOL,
                                 "kernel tick vs plain tick, first forces")
    log(f"[mpc] kernel tick vs sequential-solver tick on {NUM_ENVS} "
        f"perturbed states: torques max |err| {tau_err:.3g} N·m "
        f"({100 * tau_share:.2g}% of the tolerance), first forces "
        f"{f_err:.3g} N ({100 * f_share:.2g}%)")

    prob, ct, kin = pf_ctrl.tick_problem(phys, cmd)
    raw = rk.srb_lqr(*prob, horizon=cfg.horizon).reshape(
        NUM_ENVS, cfg.horizon, nf, 3)
    layers = {
        "tick (plan_tick_cuda)": cuda_ms(
            lambda: pf_ctrl.plan_tick_cuda(phys, cmd), 10),
        "FK + problem assembly": cuda_ms(
            lambda: pf_ctrl.tick_problem(phys, cmd), 10),
        "staging to (rows, B)": cuda_ms(lambda: rk.stage(*prob), 20),
        "SRB-LQR kernel": kernel_ms,
        "cone projection": cuda_ms(
            lambda: srb._project_cone(raw, cfg), 20),
        "leg_torques": cuda_ms(
            lambda: pf_ctrl.leg_torques(phys, fs_k[:, 0], ct, kin=kin), 10),
        "tick with the sequential solver (plan_tick)": cuda_ms(
            lambda: pf_ctrl.plan_tick(phys, cmd), 3, warmup=1),
    }
    log("[layers] SRB-MPC tick ms: " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))
    return launches


# ------------------------------------------------ 9. the closed-loop gate

def _flat_ground(x, y):
    return torch.zeros_like(x)


_flat_ground.is_flat = True


def srb_gate(a1_model):
    dev = a1_model.mass.device
    params = PhysicsParams.nominal(a1_model, NUM_ENVS, dev)
    ctrl = srb.SRBController(a1_model, params,
                             a1_model.collision_indices("foot"), A1_QDEF,
                             srb.SRBConfig(**SRB_GATE_CFG))
    phys = PhysicsState.default(ctrl.model, A1_QDEF, NUM_ENVS, dev,
                                base_height=0.29)
    lin = torch.zeros_like(phys.base_lin_vel)
    lin[:, 1] = 0.3
    phys = phys.replace(base_lin_vel=lin)
    command = torch.zeros(NUM_ENVS, 3, device=dev)
    min_z = torch.full((NUM_ENVS,), float("inf"), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(SRB_GATE_TICKS):
        _, fs = ctrl.plan_tick_cuda(phys, command)
        contact = ctrl.feet_and_contact(phys)[2]
        for _ in range(SRB_GATE_SUBSTEPS):
            # 200 Hz leg loop: remap the held plan force each substep
            tau = ctrl.leg_torques(phys, fs[:, 0], contact)
            phys = dynamics.step_batched(ctrl.model, params, phys, tau,
                                         _flat_ground, SRB_GATE_DT)
        min_z = torch.minimum(min_z, phys.base_pos[:, 2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_counts(read_counts(), srb_lqr=SRB_GATE_TICKS,
                  substep=SRB_GATE_TICKS * SRB_GATE_SUBSTEPS)
    rec = {"min_height": float(min_z.min()),
           "min_abs_quat_w": float(phys.base_quat[:, 3].abs().min()),
           "max_final_speed": float(
               torch.linalg.vector_norm(phys.base_lin_vel, dim=-1).max())}
    log(f"[srb-gate] A1, {NUM_ENVS} scenarios, flat ground, lateral 0.3 m/s, "
        f"{SRB_GATE_TICKS} ticks x {SRB_GATE_SUBSTEPS} substeps in "
        f"{wall:.2f} s: {json.dumps(rec)}")
    if not (rec["min_height"] > 0.2 and rec["min_abs_quat_w"] > 0.99
            and rec["max_final_speed"] < 0.2):
        raise AssertionError(f"SRB closed-loop gate outside its bounds: "
                             f"{rec}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = bench.card_line(torch.device("cuda"))
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    pf_env = make_env("pointfoot_rough", num_envs=NUM_ENVS,
                      cfg_patch=policy_eval.FLAGSHIP_PATCH)
    any_env = make_env("anymal_c_rough", num_envs=NUM_ENVS,
                       cfg_patch=ANYMAL_PATCH)
    mc_pf = sp.model_consts(pf_env.model)
    mc_any = sp.model_consts(any_env.model)
    a1_model = get_model("a1").to(pf_env.device)
    build_kernels(mc_pf, mc_any, sp.model_consts(a1_model))
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(pf_env, "pointfoot_rough"))

    roll, fk, pf_state, xyz = pointfoot_kernels(pf_env, mc_pf, policy)
    sub, fkxy, chol, lay = anymal_kernels(any_env, mc_any, pf_env,
                                          pf_state)
    log(f"[t] kernels checked at {time.perf_counter() - t_start:.1f} s")
    pf_launches = pointfoot_rollout(pf_env, mc_pf, policy, xyz)
    any_launches = anymal_rollout(any_env, lay)
    physical_gate()
    chol_launches = cholesky_route()
    log(f"[t] env paths done at {time.perf_counter() - t_start:.1f} s")

    pf_ctrl = bench.make_mpc(NUM_ENVS, pf_env.device)[0]
    a1_ctrl = srb.SRBController(
        a1_model, PhysicsParams.nominal(a1_model, NUM_ENVS, pf_env.device),
        a1_model.collision_indices("foot"), A1_QDEF,
        srb.SRBConfig(height_target=0.28))
    lqr = riccati_kernels(pf_ctrl, a1_ctrl)
    mpc_launches = mpc_tick(pf_ctrl, lqr["ms"])
    srb_gate(a1_model)

    kernels = [
        kernel_record("rollout_substep_kernel", SUBSTEP_SRC,
                      "pointfoot_tpu/ops/pallas/substep.py:273",
                      pf_launches["rollout_substep"], **roll),
        kernel_record("fk_from_state_kernel", SUBSTEP_SRC,
                      "pointfoot_tpu/ops/pallas/substep.py:328",
                      pf_launches["fk_from_state"], **fk),
        kernel_record("substep_kernel", SUBSTEP_SRC,
                      "pointfoot_tpu/ops/pallas/substep.py:65",
                      any_launches["substep"], **sub),
        kernel_record("fk_contact_xy_kernel", SUBSTEP_SRC,
                      "pointfoot_tpu/ops/pallas/substep.py:201",
                      any_launches["fk_contact_xy"], **fkxy),
        kernel_record("chol_solve_kernel", CHOL_SRC,
                      "pointfoot_tpu/ops/pallas/cholesky.py:35",
                      chol_launches["chol_solve"], **chol),
        kernel_record("srb_lqr_kernel", RICCATI_SRC,
                      "pointfoot_tpu/ops/pallas/riccati.py:32",
                      mpc_launches["srb_lqr"], **lqr),
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
