r"""Gait / stepping layer over the SRB force planner: the gait-MPC walking
controller of the robot family (pointfoot_tpu/mpc/gait.py), batched.

A point foot gives the biped a line-segment support region, so bipeds
balance by STEPPING.  This module is the Raibert-heuristic stepping stack
(MIT Mini-Cheetah controller lineage, public method) on top of mpc/srb.py:

* gait clock: phase in [0, 1), legs offset by `offsets`; a leg is in
  stance while its local phase < duty, and may only lift off once another
  leg is measurably loaded (support continuity);
* footstep targets, recomputed every tick from the live velocity:
  p = anchor + v_cmd T_st/2 + k_v (v - v_cmd) + k_i \int(v - v_cmd), capped
  to a reachable radius (capture-point Raibert placement);
* swing trajectory: xy blend and sin-profile apex complete at s = 0.8 of
  the swing window, then push slightly below the ground line; swing legs
  tracked with task-space PD (+ gravity compensation) through J^T;
* reach-down: a clock-stance foot that is not loaded is driven to its
  target on the ground;
* stance legs: SRB ground-reaction forces realized via tau = C_j - J^T f,
  with a joint-space posture spring.

Terrain-aware mode: pass `height_fn(x, y) -> z` and the step-target z, the
loaded z-proxy, reach-down depth, swing clearance and the SRB height
reference ride the terrain query; None keeps the flat-ground path.

Where the JAX package `vmap`s a one-scenario tick with Python loops over
feet, `SteppingController.control` runs every scenario at once on (B, nf)
masks.  The stance forces come from the SRB-LQR:

* frozen contact (the bipeds): on the card the SRB-LQR kernel
  (ops/cuda/riccati.srb_lqr, kernel 6) solves every scenario in one launch
  and the tick takes its first force, as `SRBController.plan_tick_cuda`
  does; on the CPU the plain sequential Riccati sweep and the step-1 gains,
  as JAX does;
* `horizon_schedule` (the quadrupeds): the contact gates and so L and c
  vary over the horizon, which kernel 6 (time-invariant c and L) does not
  take, so this branch is the plain `sequential_lqr_value` and
  `lqr_gains_from_value` on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.mpc import riccati
from pointfoot_tpu_torch.mpc.srb import (SRBConfig, _foot_ancestors, _mv,
                                         _project_cone, _sphere_positions,
                                         srb_problem, srb_problem_sched)
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.ops import spatial
from pointfoot_tpu_torch.ops.cuda import riccati as riccati_cuda
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import (PhysicsParams, PhysicsState,
                                               RobotModel)


@dataclass(frozen=True)
class GaitConfig:
    """The JAX package's GaitConfig, every field and default; its notes
    (pointfoot_tpu/mpc/gait.py:83-210) give the measurements behind each."""

    period: float = 0.34  # [s] full gait cycle
    duty: float = 0.55  # stance fraction per leg
    swing_height: float = 0.05  # [m] apex
    k_raibert: float = 0.25  # velocity-error placement gain (capture value)
    k_extra: float = 0.095  # extra gain for small errors, saturating
    err_sat: float = 0.2  # [m/s] error scale where the extra gain fades
    step_reach: float = 0.30  # [m] max step offset from the anchor
    kp_cart: float = 300.0  # swing task-space stiffness
    kd_cart: float = 12.0
    y_off: float = 0.06  # lateral half-stance-width of the "com" anchor
    contact_gate: bool = True  # SRB force only for feet actually loaded
    k_int: float = 0.12  # integral placement trim gain
    v_int_max: float = 0.6  # [m] anti-windup clamp on the error integral
    cmd_slew: float = 0.75  # [m/s^2] command slew-rate limit
    # period_eff = period / (1 + speed_gain |v_cmd| + err_gain v_err)
    period_speed_gain: float = 0.35
    period_err_gain: float = 0.0
    period_err_cap: float = 1.0
    period_err_wz_fade: float = 0.3
    period_err_fade_v: float = 0.4
    # duty_eff = duty + gain * min(|wz_cmd|, 1), faded above fade_v
    duty_turn_gain: float = 0.16
    duty_max: float = 0.70
    duty_turn_fade_v: float = 0.4
    yaw_anticipate: float = 0.0
    anchor: str = "com"  # "com" (capture point) or "hip" (quadrupeds)
    stance_bias_comp: float = 1.0
    kp_posture: float = 60.0  # stance joint-space posture spring
    posture_ramp_s: float = 1.5  # its start-up ramp (0: full-on)
    # contact schedule over the SRB horizon (Di Carlo 2018 convex MPC)
    horizon_schedule: bool = False


class GaitState(NamedTuple):
    phase: torch.Tensor  # (B,) gait clock in [0, 1)
    liftoff_pos: torch.Tensor  # (B, nf, 3) foot position at last liftoff
    target_pos: torch.Tensor  # (B, nf, 3) current step target
    v_int: torch.Tensor  # (B, 3) integrated velocity error
    cmd_f: torch.Tensor  # (B, 3) slew-limited command actually tracked
    ground_z: torch.Tensor  # (B,) latched ground height from loaded feet
    t: torch.Tensor  # (B,) seconds since init (posture-spring ramp)


def _leg_phase(phase, leg_offset):
    return torch.remainder(phase + leg_offset, 1.0)


def heading_command(base_quat, cmd_vxy, heading_des,
                    gain: float = 0.5, wz_max: float = 1.0):
    """Heading-mode outer loop over the stepping controller: wz =
    clip(gain * wrap_to_pi(heading - yaw), +/-wz_max), recomputed every
    tick.  base_quat (B, 4), cmd_vxy (B, 2), heading_des (B,) -> (B, 3)
    [vx, vy, wz] command for SteppingController.control."""
    yaw = quat_ops.yaw(base_quat)
    wz = quat_ops.heading_wz(heading_des, yaw, gain, wz_max)
    return torch.cat([cmd_vxy, wz[..., None]], dim=-1)


class TickPlan(NamedTuple):
    """What `SteppingController.placement` decides in a tick."""
    kin: dynamics.Kinematics
    foot_pos: torch.Tensor  # (B, nf, 3)
    leg_ph: torch.Tensor  # (B, nf) leg phases at the tick's start
    stance: torch.Tensor  # (B, nf) clock stance after support continuity
    loaded: torch.Tensor  # (B, nf)
    ct: torch.Tensor  # (B, nf) SRB contact gate
    target: torch.Tensor  # (B, nf, 3) this tick's footstep targets
    period: torch.Tensor  # (B,)
    duty: torch.Tensor  # (B,)
    href: Optional[torch.Tensor]  # (B,) terrain base-height reference
    phase: torch.Tensor  # (B,) gait clock at the tick's start
    t: torch.Tensor  # (B,) seconds since init at the tick's start
    new: GaitState  # the state after the tick


class TunedStack(NamedTuple):
    """A ready-to-roll gait-MPC stack from `make_controller`."""
    ctrl: "SteppingController"
    q0: torch.Tensor  # default joint pose
    z0: float  # spawn / SRB reference height
    ctrl_dt: float  # control tick period [s]
    substeps: int  # physics substeps (at 200 Hz) per control tick


def make_controller(robot: str, height_fn=None, gait_overrides=None,
                    srb_overrides=None, gait: str = "trot",
                    device=None) -> TunedStack:
    """Tuned gait-MPC stack for a named robot, on the card unless `device`
    names another.

    * ``pointfoot``: biped alternating gait, 50 Hz control / 4 x 200 Hz
      substeps, CoM-anchored capture-point placement;
    * ``a1``: quadruped trot (diagonal pairs, hip anchoring, horizon contact
      schedule) at 200 Hz control;
    * ``anymal_c`` / ``anymal_b``: the same trot at ANYmal scale (slower
      cadence, stiffer SRB velocity weight, integral trim);
    * ``cassie``: toe-contact biped with six joints a leg, 200 Hz control
      and a full-on posture spring.

    `gait_overrides` / `srb_overrides` are dicts merged over the tuned
    defaults.  `gait` selects the quadruped footfall pattern: "trot" or
    "walk" (4-beat lateral sequence, duty 0.8); bipeds accept only the
    default alternating gait.
    """
    device = resolve_device(device)
    model = get_model(robot)
    feet = (model.collision_indices("foot")
            or model.collision_indices("FOOT")
            or model.collision_indices("toe"))
    if robot == "pointfoot":
        q0 = np.zeros(model.nj, np.float32)
        z0, ctrl_dt, substeps, offsets = 0.62, 0.02, 4, None
        gkw, skw = {}, dict(w_force_tangent=3e-3)
    elif robot == "a1":
        q0 = np.zeros(model.nj, np.float32)
        for i, nm in enumerate(model.joint_names):
            q0[i] = {"thigh": 0.9, "calf": -1.8}.get(nm.split("_")[1], 0.0)
        z0, ctrl_dt, substeps = 0.2662, 0.005, 1
        offsets = (0.0, 0.5, 0.5, 0.0)  # FR FL RR RL trot
        gkw = dict(anchor="hip", horizon_schedule=True, k_raibert=0.166,
                   swing_height=0.06, kp_cart=600.0, kd_cart=20.0,
                   k_int=0.0, kp_posture=0.0)
        skw = dict(height_target=z0, w_force_tangent=3e-3, f_max=200.0,
                   w_orient=100.0, w_omega=5.0)
    elif robot in ("anymal_c", "anymal_b"):
        q0 = np.zeros(model.nj, np.float32)
        for i, nm in enumerate(model.joint_names):
            sgn = 1.0 if nm[1] == "F" else -1.0  # LF/RF vs LH/RH mirror
            q0[i] = {"HFE": 0.4 * sgn, "KFE": -0.8 * sgn}.get(nm[3:], 0.0)
        z0 = 0.5488 if robot == "anymal_c" else 0.4968
        ctrl_dt, substeps = 0.005, 1
        offsets = (0.0, 0.5, 0.5, 0.0)  # LF RF LH RH trot
        gkw = dict(anchor="hip", horizon_schedule=True,
                   k_raibert=round((z0 / 9.81) ** 0.5, 3),
                   period=0.5, swing_height=0.08, kp_cart=600.0,
                   kd_cart=20.0, k_int=0.1, kp_posture=0.0)
        skw = dict(height_target=z0, w_force_tangent=3e-3,
                   f_max=500.0 if robot == "anymal_c" else 300.0,
                   w_orient=100.0, w_omega=5.0, w_vel=50.0)
    elif robot == "cassie":
        q0 = np.zeros(model.nj, np.float32)
        ang = dict(hip_abduction_left=0.1, hip_abduction_right=-0.1,
                   hip_flexion=1.0, thigh_joint=-1.8,
                   ankle_joint=1.57, toe_joint=-1.57)
        for i, nm in enumerate(model.joint_names):
            q0[i] = ang.get(nm, ang.get(nm.rsplit("_", 1)[0], 0.0))
        z0, ctrl_dt, substeps, offsets = 0.8516, 0.005, 1, None
        gkw = dict(k_raibert=0.295, period=0.4, swing_height=0.06,
                   kp_cart=600.0, kd_cart=20.0, k_int=0.1,
                   kp_posture=100.0, posture_ramp_s=0.0, y_off=0.13)
        skw = dict(height_target=z0, w_force_tangent=3e-3, f_max=400.0,
                   w_orient=100.0, w_omega=5.0)
    else:
        raise ValueError(f"no tuned gait stack for {robot!r} "
                         "(have: pointfoot, a1, anymal_b, anymal_c, "
                         "cassie)")
    if gait != "trot":
        if offsets is None:
            raise ValueError(f"gait={gait!r} needs a quadruped; "
                             f"{robot} uses the default alternating gait")
        if gait == "walk":
            # 4-beat lateral sequence; long double support
            offsets = (0.0, 0.5, 0.75, 0.25)
            gkw.update(duty=0.8, period=0.6)
        else:
            raise ValueError(f"unknown quadruped gait {gait!r} "
                             "(have: trot, walk)")
    gkw.update(gait_overrides or {})
    skw.update(srb_overrides or {})
    ctrl = SteppingController(model, PhysicsParams.nominal(model, 1, device),
                              feet, q0, srb_cfg=SRBConfig(**skw),
                              gait_cfg=GaitConfig(**gkw), dt=ctrl_dt,
                              height_fn=height_fn, offsets=offsets)
    return TunedStack(ctrl, torch.as_tensor(q0, device=device), z0, ctrl_dt,
                      substeps)


class SteppingController:
    """Gait-MPC: SRB stance forces + Raibert swing stepping, batched.

    `params_single` is one row of physics parameters
    (`PhysicsParams.nominal(model, 1, device)`), broadcast to every
    scenario; the model and the default pose move to its device.
    """

    # walking-tuned SRB weights: cheaper tangential force is the main
    # yaw-authority lever of a point-foot biped
    WALK_SRB = SRBConfig(w_force_tangent=3e-3)

    def __init__(self, model: RobotModel, params_single: PhysicsParams,
                 feet_idx, default_qpos, srb_cfg: SRBConfig = WALK_SRB,
                 gait_cfg: GaitConfig = GaitConfig(), dt: float = 0.02,
                 height_fn=None, offsets=None):
        device = params_single.kp.device
        self.model = model.to(device)
        self.params = params_single
        self.feet_idx = tuple(feet_idx)
        self.nf = len(self.feet_idx)
        self.default_qpos = torch.as_tensor(
            default_qpos, dtype=torch.float32).to(device)
        self.srb = srb_cfg
        self.gait = gait_cfg
        self.dt = dt
        self.height_fn = height_fn
        self.offsets = torch.tensor(
            offsets if offsets is not None
            else [i / self.nf for i in range(self.nf)],
            dtype=torch.float32, device=device)
        # hip anchor per foot: the leg's first joint
        self._hip_joint = tuple(
            _foot_ancestors(model, c)[0] for c in self.feet_idx)
        # every leg's joints (legs are disjoint) and the foot each serves
        anc = [_foot_ancestors(model, c) for c in self.feet_idx]
        self._leg_joints = torch.tensor([j for a in anc for j in a],
                                        device=device)
        self._leg_foot = torch.tensor(
            [k for k, a in enumerate(anc) for _ in a], device=device)
        member = torch.zeros(self.nf, model.nj, device=device)
        member[self._leg_foot, self._leg_joints] = 1.0
        self._member = member
        # neutral stance offset per leg (hip anchor -> default-pose foot,
        # base frame xy): "hip" anchor steps land at hip + R_yaw @ neutral
        neutral = PhysicsState.default(self.model, self.default_qpos, 1,
                                       device, base_height=1.0)
        fp0, hips0, _ = self._foot_positions(neutral)
        self._neutral_off = ((fp0 - hips0)[0]
                             * fp0.new_tensor([1.0, 1.0, 0.0]))

    def init(self, batch: int, phys: PhysicsState) -> GaitState:
        fp = self._foot_positions(phys)[0]
        zeros = fp.new_zeros
        return GaitState(
            phase=zeros(batch),
            liftoff_pos=fp,
            target_pos=fp,
            v_int=zeros(batch, 3),
            cmd_f=zeros(batch, 3),
            ground_z=torch.min(fp[..., 2], dim=-1).values,
            t=zeros(batch),
        )

    # ------------------------------------------------------------------

    def _foot_positions(self, phys: PhysicsState):
        """(foot positions (B, nf, 3), hip anchors (B, nf, 3), kinematics)."""
        B = phys.base_pos.shape[0]
        kin = dynamics.forward_kinematics(self.model, phys,
                                          self.params.broadcast(B))
        pts = _sphere_positions(self.model, kin, self.feet_idx)
        return pts, kin.joint_anchor[:, list(self._hip_joint)], kin

    def _leg_columns(self, S: torch.Tensor, rel: torch.Tensor):
        """J^T rows of every leg joint, (B, n_leg_joints, 3): the linear
        velocity its foot point gains per unit joint rate."""
        Sj = S[:, 6 + self._leg_joints]
        r = rel[:, self._leg_foot]
        return Sj[..., 3:] + torch.linalg.cross(Sj[..., :3], r, dim=-1)

    def _joint_torque(self, cols: torch.Tensor, f: torch.Tensor):
        """(B, nj) torques J^T f of per-foot forces f (B, nf, 3)."""
        per = torch.sum(cols * f[:, self._leg_foot], dim=-1)
        tau = f.new_zeros(f.shape[0], self.model.nj)
        return tau.index_add_(1, self._leg_joints, per)

    # ------------------------------------------------------------------
    # One tick in three stages (their times are chip_smoke.py's layers):
    # `placement` (FK, gait clock, contact, footstep targets), `stance_force`
    # (SRB problem and its solve) and `torques` (the torque map).

    def placement(self, phys: PhysicsState, command: torch.Tensor,
                  gait: GaitState) -> "TickPlan":
        """Gait clock, contact state and footstep targets of a tick."""
        g = self.gait
        dt = self.dt
        hfn = self.height_fn
        B = phys.base_pos.shape[0]
        dev = phys.base_pos.device
        z_axis = torch.tensor([0.0, 0.0, 1.0], device=dev)
        zeros_b = phys.base_pos.new_zeros(B, 1)

        # slew-limit the tracked command
        dmax = g.cmd_slew * dt
        cmd = gait.cmd_f + torch.clamp(command - gait.cmd_f, -dmax, dmax)
        cmd_xy0 = torch.cat([cmd[:, :2], zeros_b], dim=-1)
        speed = torch.linalg.vector_norm(cmd[:, :2], dim=-1)
        # error-adaptive cadence in the current yaw frame
        yaw = quat_ops.yaw(phys.base_quat)
        v_cmd_w0 = quat_ops.rotate(quat_ops.from_axis_angle(z_axis, yaw),
                                   cmd_xy0)
        v_err = torch.clamp_max(torch.linalg.vector_norm(
            (phys.base_lin_vel - v_cmd_w0)[:, :2], dim=-1), g.period_err_cap)
        v_err = v_err * torch.clamp(
            1.0 - torch.abs(cmd[:, 2]) / g.period_err_wz_fade, 0.0, 1.0)
        v_err = v_err * torch.clamp(
            1.0 - (speed - g.period_err_fade_v)
            / max(g.period_err_fade_v, 1e-6), 0.0, 1.0)
        period = g.period / (1.0 + g.period_speed_gain * speed
                             + g.period_err_gain * v_err)
        # widen double support while turning, faded out at speed
        fade = torch.clamp(
            1.0 - (speed - g.duty_turn_fade_v)
            / max(g.duty_turn_fade_v, 1e-6), 0.0, 1.0)
        duty = torch.clamp_max(
            g.duty + fade * g.duty_turn_gain * torch.clamp_max(
                torch.abs(cmd[:, 2]), 1.0), g.duty_max)
        foot_pos, hips, kin = self._foot_positions(phys)
        leg_ph = _leg_phase(gait.phase[:, None], self.offsets)  # (B, nf)
        stance = (leg_ph < duty[:, None]).to(foot_pos.dtype)
        # support continuity: lift off only while another leg is loaded
        fz_meas = phys.contact_force[:, list(self.feet_idx), 2]
        if hfn is None:
            foot_clear = foot_pos[..., 2]
        else:  # height above the local terrain
            foot_clear = foot_pos[..., 2] - hfn(foot_pos[..., 0],
                                                foot_pos[..., 1])
        loaded = ((fz_meas > 1.0) | (foot_clear < 0.035)).to(foot_pos.dtype)
        other_loaded = torch.sum(loaded, dim=1, keepdim=True) - loaded
        stance = torch.maximum(stance, (other_loaded < 0.5).to(stance.dtype))

        new_phase = torch.remainder(gait.phase + dt / period, 1.0)
        new_leg_ph = _leg_phase(new_phase[:, None], self.offsets)
        new_stance = (new_leg_ph < duty[:, None]).to(stance.dtype)
        just_lifted = (stance > 0.5) & (new_stance < 0.5)

        # Raibert footstep target (world), placement frame at the heading
        # anticipated to mid-stance
        yaw_step = yaw + g.yaw_anticipate * cmd[:, 2] * period
        q_yaw = quat_ops.from_axis_angle(z_axis, yaw_step)
        v = phys.base_lin_vel
        v_cmd_w = quat_ops.rotate(q_yaw, cmd_xy0)
        T_st = duty * period
        new_v_int = torch.clamp(gait.v_int + dt * (v - v_cmd_w),
                                -g.v_int_max, g.v_int_max)
        err = v - v_cmd_w
        sat = torch.clamp_max(g.err_sat / torch.clamp_min(
            torch.linalg.vector_norm(err[:, :2], dim=-1), 1e-6), 1.0)
        offset = (v_cmd_w * (T_st / 2)[:, None]
                  + (g.k_raibert + g.k_extra * sat)[:, None] * err
                  + g.k_int * new_v_int)
        offset = torch.cat([offset[:, :2], zeros_b], dim=-1)
        norm = torch.linalg.vector_norm(offset[:, :2], dim=-1)
        offset = offset * torch.clamp_max(
            g.step_reach / torch.clamp_min(norm, 1e-6), 1.0)[:, None]
        com = (torch.sum(self.model.mass[:, None] * kin.com_w, dim=1)
               / torch.sum(self.model.mass))
        q_yaw_f = q_yaw[:, None].expand(B, self.nf, 4)
        if g.anchor == "hip":
            # each leg anchors at its hip projection plus its neutral
            # stance offset in the yaw frame
            anchor_xy = hips + quat_ops.rotate(
                q_yaw_f, self._neutral_off.expand(B, self.nf, 3))
        else:
            # per-leg lateral stance bias, signed by the leg's hip side
            side = torch.sign(quat_ops.rotate_inverse(
                q_yaw_f, hips - phys.base_pos[:, None])[..., 1])
            lateral = torch.tensor([0.0, 1.0, 0.0], device=dev)
            bias = quat_ops.rotate(q_yaw_f,
                                   lateral * (side * g.y_off)[..., None])
            anchor_xy = com[:, None] + bias
        # ground estimate from the loaded feet; with none loaded keep the
        # last grounded estimate
        gz = torch.min(torch.where(loaded > 0.5, foot_pos[..., 2],
                                   torch.full_like(foot_pos[..., 2], 1e9)),
                       dim=1).values
        ground_z = torch.where(gz > 1e8, gait.ground_z, gz)
        anchor = torch.cat([anchor_xy[..., :2],
                            ground_z[:, None, None].expand(B, self.nf, 1)],
                           dim=-1)
        tgt = anchor + offset[:, None]
        if hfn is not None:
            tgt = self._edge_aware(tgt, v_cmd_w)

        # liftoff pose latches at the stance->swing edge; the target is
        # recomputed every tick while the leg swings
        new_liftoff = torch.where(just_lifted[..., None], foot_pos,
                                  gait.liftoff_pos)
        in_swing = stance < 0.5
        new_target = torch.where(in_swing[..., None], tgt, gait.target_pos)

        # SRB stance forces for clock-stance feet that are loaded; all
        # stance if none qualifies
        eligible = stance * loaded if g.contact_gate else stance
        ct = torch.where(torch.sum(eligible, dim=1, keepdim=True) > 0,
                         eligible, torch.ones_like(stance))
        # terrain-following base height reference
        href = None
        if hfn is not None:
            href = (torch.mean(hfn(foot_pos[..., 0], foot_pos[..., 1]),
                               dim=1) + self.srb.height_target)
        new_gait = GaitState(phase=new_phase, liftoff_pos=new_liftoff,
                             target_pos=new_target, v_int=new_v_int,
                             cmd_f=cmd, ground_z=ground_z, t=gait.t + dt)
        return TickPlan(kin=kin, foot_pos=foot_pos, leg_ph=leg_ph,
                        stance=stance, loaded=loaded, ct=ct, target=tgt,
                        period=period, duty=duty, href=href, phase=gait.phase,
                        t=gait.t, new=new_gait)

    def srb_tick_problem(self, phys: PhysicsState, plan: "TickPlan"):
        """The tick's SRB-LQR problem: the eight tensors of `srb_problem`
        (frozen contact), or those of `srb_problem_sched`."""
        g = self.gait
        params = self.params.broadcast(phys.base_pos.shape[0])
        cmd = plan.new.cmd_f
        if not g.horizon_schedule:
            return srb_problem(self.model, phys, params, plan.foot_pos,
                               plan.ct, cmd, self.srb, kin=plan.kin,
                               height_ref=plan.href)
        # future stance gates from the gait clock; step 0 keeps the
        # measured-load gating, and any support-free step falls back to
        # all-stance
        T = self.srb.horizon
        tt = torch.arange(T, device=plan.phase.device)
        ph_t = torch.remainder(
            plan.phase[:, None, None]
            + (tt[None, :, None] * self.srb.dt) / plan.period[:, None, None]
            + self.offsets, 1.0)
        ct_seq = (ph_t < plan.duty[:, None, None]).to(plan.ct.dtype)
        ct_seq[:, 0] = plan.ct
        ct_seq = torch.where(torch.sum(ct_seq, dim=2, keepdim=True) > 0,
                             ct_seq, torch.ones_like(ct_seq))
        # swing feet enter the plan at their predicted touchdown
        fp_sched = torch.where(plan.stance[..., None] > 0.5, plan.foot_pos,
                               plan.new.target_pos)
        return srb_problem_sched(self.model, phys, params, fp_sched, ct_seq,
                                 cmd, self.srb, kin=plan.kin,
                                 height_ref=plan.href)

    def solve_first_force(self, prob) -> torch.Tensor:
        """First planned force (B, 3 nf) of the tick's problem, before the
        cone projection (module docstring: kernel 6 on the card for frozen
        contact, else the plain sweep and the step-1 gains)."""
        T = self.srb.horizon
        if not self.gait.horizon_schedule:
            F, c_tot, L, Xd, Ud, XTd, x0, f_ff = prob
            if x0.device.type == "cuda":
                return riccati_cuda.srb_lqr(*prob, horizon=T)[:, 0]
            c_seq = c_tot[:, None].expand(-1, T, -1)
            L_seq = L[:, None].expand(-1, T, -1, -1)
            f_ff0 = f_ff
        else:
            F, c_seq, L_seq, Xd, Ud, XTd, x0, f_ff_seq = prob
            f_ff0 = f_ff_seq[:, 0]
        B, n = x0.shape
        m = L_seq.shape[-1]
        U = torch.diag_embed(Ud)
        Ps, ps = riccati.sequential_lqr_value(
            F[None].expand(T, B, n, n), c_seq.transpose(0, 1),
            L_seq.transpose(0, 1),
            torch.diag_embed(Xd)[None].expand(T, B, n, n),
            U[None].expand(T, B, m, m), torch.diag_embed(XTd))
        K, d = riccati.lqr_gains_from_value(F, c_seq[:, 0], L_seq[:, 0], U,
                                            Ps[1], ps[1])
        return f_ff0 + (-_mv(K, x0) - d)

    def stance_force(self, phys: PhysicsState, plan: "TickPlan"):
        """(first SRB force (B, nf, 3) after the cone projection, the LQR's
        deviation state x0 (B, 12))."""
        prob = self.srb_tick_problem(phys, plan)
        f0 = self.solve_first_force(prob)
        B = f0.shape[0]
        return _project_cone(f0.reshape(B, self.nf, 3), self.srb), prob[6]

    def torques(self, phys: PhysicsState, plan: "TickPlan",
                f0: torch.Tensor) -> torch.Tensor:
        """The torque map (B, nj): stance J^T f with bias compensation,
        posture spring and damping; swing task-space PD with gravity
        compensation; reach-down; the effort clip."""
        g = self.gait
        hfn = self.height_fn
        B = phys.base_pos.shape[0]
        dev = phys.base_pos.device
        params = self.params.broadcast(B)
        kin, foot_pos, stance = plan.kin, plan.foot_pos, plan.stance
        S = dynamics.motion_subspaces(self.model, kin, phys.base_pos)
        body_vel = dynamics.body_spatial_velocities(self.model, phys, S)
        C = dynamics.bias_forces(self.model, params, kin, S, phys.qvel,
                                 body_vel, phys.base_pos)
        rel = foot_pos - phys.base_pos[:, None]
        cols = self._leg_columns(S, rel)
        tau = self._joint_torque(cols, plan.ct[..., None] * -f0)
        stance_mask_j = torch.clamp_max(stance @ self._member, 1.0)
        swing_mask_j = torch.clamp_max((1.0 - stance) @ self._member, 1.0)
        if g.posture_ramp_s > 0.0:
            kp_post = (g.kp_posture * torch.clamp(
                plan.t / g.posture_ramp_s, 0.0, 1.0))[:, None]
        else:
            kp_post = g.kp_posture
        tau = tau + stance_mask_j * (
            g.stance_bias_comp * C[:, 6:]
            + kp_post * (self.default_qpos - phys.qpos)
            - self.srb.kd_stance * phys.qvel)

        # swing torques: task-space PD along the swing trajectory, whose
        # vertical profile completes at s = 0.8 and then pushes slightly
        # below the ground line
        duty, period = plan.duty[:, None], plan.period[:, None]
        T_sw = (1.0 - duty) * period
        s_ph = torch.clamp((plan.leg_ph - duty) / (1.0 - duty), 0, 1)
        p_lo, p_tg = plan.new.liftoff_pos, plan.new.target_pos
        sxy = torch.clamp_max(s_ph / 0.8, 1.0)
        p_des = p_lo + (p_tg - p_lo) * sxy[..., None]
        z_base = p_lo[..., 2] + (p_tg[..., 2] - p_lo[..., 2]) * sxy
        sz = sxy
        z_prof = (g.swing_height * torch.sin(math.pi * sz)
                  - 0.02 * torch.clamp((s_ph - 0.8) / 0.2, 0.0, 1.0))
        if hfn is not None:
            # obstacle clearance: lift the apex over the highest terrain
            # sampled along the xy path
            ss = torch.tensor([0.25, 0.5, 0.75], device=dev)
            xy = (p_lo[..., None, :2]
                  + (p_tg[..., :2] - p_lo[..., :2])[..., None, :]
                  * ss[:, None])
            h_path = torch.max(hfn(xy[..., 0], xy[..., 1]), dim=-1).values
            z_hi = torch.maximum(torch.maximum(p_lo[..., 2], p_tg[..., 2]),
                                 h_path)
            mid = 0.5 * (p_lo[..., 2] + p_tg[..., 2])
            z_prof = z_prof + (torch.clamp_min(z_hi - mid, 0.0)
                               * torch.sin(math.pi * sz))
        p_des = torch.cat([p_des[..., :2], (z_base + z_prof)[..., None]],
                          dim=-1)
        v_des = ((p_tg - p_lo) / (0.8 * T_sw)[..., None]
                 * (sxy < 1.0)[..., None])
        # z feedforward = d(z_prof)/dt
        dz = (g.swing_height * math.pi / 0.8 * torch.cos(math.pi * sz)
              * (sz < 1.0) - 0.02 / 0.2 * (s_ph > 0.8)) / T_sw
        v_des = torch.cat([v_des[..., :2], dz[..., None]], dim=-1)
        b_feet = [self.model.collision_body[c] for c in self.feet_idx]
        v_p = spatial.point_velocity(body_vel[:, b_feet], rel)
        f_sw = (g.kp_cart * (p_des - foot_pos)
                + g.kd_cart * (v_des - v_p))
        tau = tau + self._joint_torque(cols, (1.0 - stance)[..., None] * f_sw)
        # reach-down: clock-stance but unloaded, drive the foot to the
        # ground at its step target
        reach = stance * (1.0 - plan.loaded)
        ground = plan.new.ground_z[:, None].expand(B, self.nf)
        reach_z = (ground if hfn is None else p_tg[..., 2]) - 0.02
        p_reach = torch.cat([p_tg[..., :2], reach_z[..., None]], dim=-1)
        v_down = torch.tensor([0.0, 0.0, -0.3], device=dev)
        f_rc = (g.kp_cart * (p_reach - foot_pos)
                + g.kd_cart * (v_down - v_p))
        tau = tau + self._joint_torque(cols, reach[..., None] * f_rc)
        # gravity/Coriolis compensation of the swing-leg joints
        tau = tau + swing_mask_j * C[:, 6:]
        eff = self.model.effort_limit
        return torch.minimum(torch.maximum(tau, -eff), eff)

    def control(self, phys: PhysicsState, command: torch.Tensor,
                gait: GaitState, debug: bool = False):
        """One control tick: returns (torques (B, nj), new GaitState), and
        with debug=True also a dict of per-tick internals (planned forces
        f0, stance, loaded, ct, target, x0)."""
        plan = self.placement(phys, command, gait)
        f0, x0 = self.stance_force(phys, plan)
        tau = self.torques(phys, plan, f0)
        if debug:
            return tau, plan.new, dict(f0=f0, stance=plan.stance,
                                       loaded=plan.loaded, ct=plan.ct,
                                       target=plan.target, x0=x0)
        return tau, plan.new

    def _edge_aware(self, tgt: torch.Tensor, v_cmd_w: torch.Tensor):
        """Edge-aware placement: probe the terrain +-6 cm along the walk
        direction; a target on a height discontinuity (> 3 cm across the
        probe) shifts onto the side whose height matches the target's own;
        then the target z rides the terrain under the adjusted xy."""
        hfn = self.height_fn
        delta, edge_thresh = 0.06, 0.03
        dir_xy = v_cmd_w[:, :2] / torch.clamp_min(
            torch.linalg.vector_norm(v_cmd_w[:, :2], dim=-1), 1e-6)[:, None]
        dx, dy = dir_xy[:, None, 0], dir_xy[:, None, 1]
        tx, ty = tgt[..., 0], tgt[..., 1]
        h_c = hfn(tx, ty)
        h_f = hfn(tx + delta * dx, ty + delta * dy)
        h_b = hfn(tx - delta * dx, ty - delta * dy)
        on_edge = torch.abs(h_f - h_b) > edge_thresh
        shift = torch.where(torch.abs(h_c - h_f) <= torch.abs(h_c - h_b),
                            delta, -delta)
        tx = tx + torch.where(on_edge, shift * dx, 0.0)
        ty = ty + torch.where(on_edge, shift * dy, 0.0)
        return torch.stack([tx, ty, hfn(tx, ty)], dim=-1)


__all__ = ["GaitConfig", "GaitState", "SteppingController", "TunedStack",
           "heading_command", "make_controller"]
