"""Closed-loop diagnostic of the gait-MPC stepping controller
(scripts/gait_diag.py of the JAX package).

    python -m pointfoot_tpu_torch.gait_diag --vx 0.4 --ticks 250 --b 4096
    python -m pointfoot_tpu_torch.gait_diag --robot a1 --vx 0.3 --b 8
    python -m pointfoot_tpu_torch.gait_diag --terrain wave:0.04 --perturb 0.1
    python -m pointfoot_tpu_torch.gait_diag --device cpu --b 2 --ticks 5

Rolls `mpc.gait.make_controller(--robot)` with `dynamics.step_batched`
over the scenario batch (`--b`, default 4) at the stack's two-rate scheme
(PointFoot: 50 Hz control, 4 x 200 Hz substeps) and reports the falls,
each scenario's time to fall, the means of base height, tilt and the
heading-frame velocities over the first second and the whole run, a trace
of scenario `--trace_env` up to 10 ticks past its fall, and the yaw
progress against the commanded yaw.  `--ticks` counts 50 Hz-equivalent
ticks.  The flags default to None, "defer to the robot's tuned stack"; a
given value overrides it.  `--terrain` is kind:amp of terrain/analytic.py
(flat, slope, wave, bumps, step) or grid:LEVEL, the curriculum grid of
pointfoot_rough's terrain config with scenario b on type column b.
`--perturb` adds sigma m/s (rad/s) of Gaussian noise, drawn from
`--seed` by torch's generator (not JAX's), to the base velocities.  At
4096 scenarios on the card the substeps take the fused kernels' route.
Runs on the GPU unless --device names another.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.mpc import gait as gait_mpc
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain.analytic import FLAT, make_terrain

SUB_DT = 0.005  # [s] the physics substep of every stack


def rollout(stack, phys, cmd, ticks: int, heading=None, height_fn=FLAT):
    """`ticks` control ticks of the stack's controller, each followed by
    its physics substeps; returns (the final state, {name: (ticks, B, ...)
    numpy trace})."""
    ctrl = stack.ctrl
    B = phys.base_pos.shape[0]
    dev = phys.base_pos.device
    params = PhysicsParams.nominal(ctrl.model, B, dev)
    feet = list(ctrl.feet_idx)
    down = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(B, 3)
    gs = ctrl.init(B, phys)
    tr = defaultdict(list)
    with torch.no_grad():
        for _ in range(ticks):
            c = cmd
            if heading is not None:  # heading-mode outer loop
                c = gait_mpc.heading_command(phys.base_quat, cmd[:, :2],
                                             heading)
            tau, gs = ctrl.control(phys, c, gs)
            for _ in range(stack.substeps):
                phys = dynamics.step_batched(ctrl.model, params, phys, tau,
                                             height_fn, SUB_DT)
            grav_b = quat_ops.rotate_inverse(phys.base_quat, down)
            # heading-frame velocities: during a turn the world x / y
            # components rotate with yaw
            yaw = quat_ops.yaw(phys.base_quat)
            cy, sy = torch.cos(yaw), torch.sin(yaw)
            v = phys.base_lin_vel
            foot_pos = ctrl._foot_positions(phys)[0]
            for k, val in dict(
                    z=phys.base_pos[:, 2],
                    tilt=torch.arccos(torch.clamp(-grav_b[:, 2], -1, 1)),
                    roll=grav_b[:, 1], pitch=-grav_b[:, 0],
                    wz=phys.base_ang_vel[:, 2], yaw=yaw,
                    vx=cy * v[:, 0] + sy * v[:, 1],
                    vy=-sy * v[:, 0] + cy * v[:, 1],
                    x=phys.base_pos[:, 0], y=phys.base_pos[:, 1],
                    phase=gs.phase, fz=phys.contact_force[:, feet, 2],
                    foot_y=foot_pos[..., 1],
                    foot_z=foot_pos[..., 2]).items():
                tr[k].append(val)
    return phys, {k: torch.stack(v).cpu().numpy() for k, v in tr.items()}


def main(argv=None) -> dict:
    """Prints the report; returns {"falls", "first_fall", "ticks"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vx", type=float, default=0.0)
    ap.add_argument("--wz", type=float, default=0.0)
    ap.add_argument("--ticks", type=int, default=250)
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--period", type=float, default=None)
    ap.add_argument("--duty", type=float, default=None)
    ap.add_argument("--y_off", type=float, default=None)
    ap.add_argument("--k_int", type=float, default=None)
    ap.add_argument("--k_raibert", type=float, default=None)
    ap.add_argument("--kp_cart", type=float, default=None)
    ap.add_argument("--kd_cart", type=float, default=None)
    ap.add_argument("--swing_height", type=float, default=None)
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--push_vx", type=float, default=0.0)
    ap.add_argument("--push_vy", type=float, default=0.0)
    ap.add_argument("--w_omega", type=float, default=None)
    ap.add_argument("--w_orient", type=float, default=None)
    ap.add_argument("--w_tan", type=float, default=None)
    ap.add_argument("--yaw_ant", type=float, default=None)
    ap.add_argument("--duty_turn", type=float, default=None)
    ap.add_argument("--trace_env", type=int, default=0)
    ap.add_argument("--err_gain", type=float, default=None)
    ap.add_argument("--step_reach", type=float, default=None)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--heading", type=float, default=None,
                    help="heading mode: commanded yaw [rad] (--wz ignored)")
    ap.add_argument("--terrain", type=str, default="flat",
                    help="kind:amp: flat | slope:0.1 | wave:0.04 | "
                         "bumps:0.03 | step:0.08 | grid:LEVEL (the "
                         "curriculum grid's row; scenario b on type "
                         "column b)")
    ap.add_argument("--robot", type=str, default="pointfoot",
                    choices=("pointfoot", "a1", "anymal_b", "anymal_c",
                             "cassie"),
                    help="robot with a tuned stack (mpc.gait.make_controller)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    gkw = {k: v for k, v in dict(
        period=args.period, duty=args.duty, k_raibert=args.k_raibert,
        kp_cart=args.kp_cart, y_off=args.y_off, k_int=args.k_int,
        kd_cart=args.kd_cart, swing_height=args.swing_height,
        yaw_anticipate=args.yaw_ant, duty_turn_gain=args.duty_turn,
        period_err_gain=args.err_gain,
        step_reach=args.step_reach).items() if v is not None}
    spawn_xyz = None
    if args.terrain.startswith("grid"):
        from pointfoot_tpu_torch.terrain.grid import TerrainCfg, build_terrain

        level = int(args.terrain.partition(":")[2] or 0)
        grid = build_terrain(TerrainCfg(), seed=args.seed, device=dev)
        hfn = grid.height_at
        cols = torch.arange(args.b, device=dev) % grid.num_types
        spawn_xyz = grid.env_origins[min(level, grid.num_levels - 1), cols]
        print(f"terrain grid row {level}: type columns {cols.tolist()}")
    else:
        hfn = make_terrain(args.terrain)
    skw = {k: v for k, v in (("w_omega", args.w_omega),
                             ("w_orient", args.w_orient),
                             ("w_force_tangent", args.w_tan))
           if v is not None}
    stack = gait_mpc.make_controller(
        args.robot, gait_overrides=gkw, srb_overrides=skw,
        height_fn=None if args.terrain in ("", "flat") else hfn,
        device=dev)
    ctrl_dt = stack.ctrl_dt
    # --ticks is in 50 Hz-equivalent units, so durations compare across
    # robots whatever each stack's control rate
    ticks_per_50hz = max(1, round(0.02 / ctrl_dt))
    ticks = args.ticks * ticks_per_50hz
    phys = PhysicsState.default(stack.ctrl.model, stack.q0, args.b, dev,
                                base_height=stack.z0)
    if spawn_xyz is not None:
        phys = phys.replace(base_pos=phys.base_pos + spawn_xyz)
    if args.perturb > 0:
        g = torch.Generator(device=dev).manual_seed(args.seed)
        phys = phys.replace(
            base_lin_vel=phys.base_lin_vel + args.perturb * torch.randn(
                args.b, 3, generator=g, device=dev),
            base_ang_vel=phys.base_ang_vel + args.perturb * torch.randn(
                args.b, 3, generator=g, device=dev))
    if args.push_vx or args.push_vy:
        phys = phys.replace(base_lin_vel=phys.base_lin_vel + torch.tensor(
            [args.push_vx, args.push_vy, 0.0], device=dev))
    cmd = torch.tensor([args.vx, 0.0, args.wz], device=dev).expand(
        args.b, 3)
    heading = (None if args.heading is None else
               torch.full((args.b,), args.heading, device=dev))
    phys, tr = rollout(stack, phys, cmd, ticks, heading=heading,
                       height_fn=hfn)
    with torch.no_grad():
        ground = hfn(torch.as_tensor(tr["x"], device=dev),
                     torch.as_tensor(tr["y"], device=dev)).cpu().numpy()
    relz = tr["z"] - ground  # height above the ground
    z_fall = 0.35 if args.robot == "pointfoot" else 0.55 * stack.z0
    fallen = (relz < z_fall) | (tr["tilt"] > 0.8) | ~np.isfinite(relz)
    first_fall = np.where(fallen.any(0), fallen.argmax(0), ticks)
    falls = int((first_fall < ticks).sum())
    print(f"cmd vx={args.vx}  ticks={ticks} (dt {ctrl_dt})")
    print(f"falls: {falls}/{args.b}")
    print(f"time-to-fall per env [ticks]: {first_fall}")
    # yaw progress: the heading reached against the commanded integral
    yaw_uw = np.unwrap(tr["yaw"], axis=0)
    yaw_gain = (yaw_uw[-1] - yaw_uw[0]).mean()
    yaw_cmd_total = args.wz * ticks * ctrl_dt
    if abs(yaw_cmd_total) > 1e-6:
        print(f"yaw progress: {yaw_gain:+.3f} rad of {yaw_cmd_total:+.3f} "
              f"commanded ({100 * yaw_gain / yaw_cmd_total:.0f}%)")
    T10 = min(ticks, int(round(1.0 / ctrl_dt)))
    for name in ("z", "tilt", "vx", "vy", "wz"):
        v = tr[name]
        print(f"  {name}: t<1s mean {v[:T10].mean():+.3f} "
              f"| full mean {v.mean():+.3f} | min {v.min():+.3f} "
              f"| max {v.max():+.3f}")
    # dense trace of one scenario up to its first fall
    e = min(args.trace_env, args.b - 1)
    t_end = int(first_fall[e]) + 10
    for t in range(0, min(t_end, ticks), 2 * ticks_per_50hz):
        fz_s = ",".join(f"{v:5.1f}" for v in tr["fz"][t, e])
        fy_s = ",".join(f"{v:+.3f}" for v in tr["foot_y"][t, e])
        fzp_s = ",".join(f"{v:.3f}" for v in tr["foot_z"][t, e])
        print(f"  t={t * ctrl_dt:5.2f}s ph={tr['phase'][t, e]:.2f} "
              f"z={tr['z'][t, e]:.3f} r={tr['roll'][t, e]:+.2f} "
              f"p={tr['pitch'][t, e]:+.2f} vx={tr['vx'][t, e]:+.2f} "
              f"vy={tr['vy'][t, e]:+.2f} "
              f"fz=({fz_s}) fy=({fy_s}) fzp=({fzp_s})")
    return {"falls": falls, "first_fall": first_fall, "ticks": ticks}


if __name__ == "__main__":
    main()
