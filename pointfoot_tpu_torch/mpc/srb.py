"""Single-rigid-body (SRB) MPC: the real-time 50 Hz planning layer
(pointfoot_tpu/mpc/srb.py), batched over scenarios.

The robot is a single rigid body with frozen world-frame inertia, controls
are ground-reaction forces at the stance feet (MIT Cheetah convex-MPC
lineage), and the resulting LQR solves in ONE Riccati sweep per scenario.

State  x = [p(3), rotvec(3), v(3), w(3)]  (world frame)
Input  u = [f_1(3), ..., f_nf(3)]         world foot forces
Dynamics (dt-discretized, inertia/foot positions frozen over the horizon):
    p'  = p + dt v
    th' = th + dt w
    v'  = v + dt (sum f_i / m + g)
    w'  = w + dt I^-1 sum r_i x f_i
Cost: velocity/height/orientation tracking + force regularization; swing
feet are removed from the force set by zeroing their columns (contact
mask).  Torques: tau = sum J_i^T f_i on stance legs, PD to the default pose
on swing legs.

Every function takes the scenarios as the leading axis of each tensor
(B, ...), the parameters included (`PhysicsParams.nominal(model, B, dev)`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import torch

from pointfoot_tpu_torch.mpc import riccati
from pointfoot_tpu_torch.ops import linalg as linalg_ops
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.ops import spatial
from pointfoot_tpu_torch.ops.cuda import riccati as riccati_cuda
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.model import (PhysicsParams, PhysicsState,
                                               RobotModel)

N_STATE = riccati_cuda.N_STATE


@dataclass(frozen=True)
class SRBConfig:
    # 12 steps x 20 ms = 240 ms lookahead (MIT convex-MPC uses ~10 steps)
    horizon: int = 12
    dt: float = 0.02
    w_vel: float = 10.0
    w_height: float = 50.0
    w_orient: float = 30.0
    w_omega: float = 2.0
    w_pos: float = 0.0
    w_force_normal: float = 1e-4
    w_force_tangent: float = 5e-3  # soft friction-cone: tangential force »
    mu: float = 0.7
    height_target: float = 0.62
    f_max: float = 400.0
    kp_swing: float = 40.0
    kd_swing: float = 1.5
    kp_stance: float = 5.0  # light posture hold against joint-space drift
    kd_stance: float = 1.0


class SRBPlan(NamedTuple):
    forces: torch.Tensor  # (B, T, nf, 3) planned world foot forces
    xs: torch.Tensor  # (B, T+1, 12) planned SRB states


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def _srb_matrices(mass, inertia_w_inv, foot_rel, contact, cfg: SRBConfig):
    """Time-invariant (over the horizon) dynamics matrices F (B, 12, 12) and
    L (B, 12, 3 nf) from mass (B,), inertia_w_inv (B, 3, 3), foot_rel
    (B, nf, 3) and contact (B, nf)."""
    n = N_STATE
    B, nf = foot_rel.shape[:2]
    dt = cfg.dt
    eye3 = torch.eye(3, dtype=foot_rel.dtype, device=foot_rel.device)
    F = torch.eye(n, dtype=foot_rel.dtype, device=foot_rel.device).repeat(
        B, 1, 1)
    F[:, 0:3, 6:9] += dt * eye3
    F[:, 3:6, 9:12] += dt * eye3
    L = foot_rel.new_zeros(B, n, 3 * nf)
    for i in range(nf):
        gate = contact[:, i]
        L[:, 6:9, 3 * i:3 * i + 3] = (gate * dt / mass)[:, None, None] * eye3
        L[:, 9:12, 3 * i:3 * i + 3] = (
            (gate * dt)[:, None, None] * inertia_w_inv
        ) @ spatial.skew(foot_rel[:, i])
    return F, L


def _com_and_inertia_inv(model: RobotModel, kin: dynamics.Kinematics):
    """Whole-robot CoM (B, 3) and the inverse of the frozen world-frame
    inertia about it (B, 3, 3)."""
    com = torch.sum(model.mass[:, None] * kin.com_w, dim=1) / torch.sum(
        model.mass)
    I_w = _srb_inertia(model, kin, com)
    eye3 = torch.eye(3, dtype=com.dtype, device=com.device)
    return com, linalg_ops.inv3(I_w + 1e-6 * eye3)


def _state_and_costs(phys: PhysicsState, command: torch.Tensor,
                     cfg: SRBConfig, nf: int, height_ref):
    """(Xd (B, 12), Ud (B, 3 nf), x0 (B, 12)): the diagonal costs and the
    current SRB state in deviation form, x - x_ref with positions relative;
    the reference is the current position at the height target, zero tilt
    and the commanded velocity."""
    B = phys.base_pos.shape[0]
    new = phys.base_pos.new_tensor
    zeros = phys.base_pos.new_zeros
    z_axis = new([0.0, 0.0, 1.0])
    yaw = quat_ops.yaw(phys.base_quat)
    yaw_q = quat_ops.from_axis_angle(z_axis, yaw)
    cmd_world = quat_ops.rotate(
        yaw_q, torch.cat([command[:, :2], zeros(B, 1)], dim=-1))
    h_ref = cfg.height_target if height_ref is None else height_ref
    h_ref = torch.as_tensor(h_ref, dtype=phys.base_pos.dtype,
                            device=phys.base_pos.device).expand(B)
    x_ref = torch.cat([
        zeros(B, 2), h_ref[:, None],
        zeros(B, 3),
        cmd_world,
        zeros(B, 2), command[:, 2:3],
    ], dim=-1)
    Xd = new([cfg.w_pos, cfg.w_pos, cfg.w_height,
              cfg.w_orient, cfg.w_orient, 0.0,
              cfg.w_vel, cfg.w_vel, cfg.w_vel,
              cfg.w_omega, cfg.w_omega, cfg.w_vel]).expand(B, N_STATE)
    Ud = new([cfg.w_force_tangent, cfg.w_force_tangent,
              cfg.w_force_normal]).repeat(nf).expand(B, 3 * nf)
    x0 = torch.cat([
        phys.base_pos * z_axis,
        quat_ops.to_rotvec(
            quat_ops.mul(phys.base_quat, quat_ops.conjugate(yaw_q))),
        phys.base_lin_vel,
        phys.base_ang_vel,
    ], dim=-1) - x_ref
    return Xd, Ud, x0


def srb_problem(model: RobotModel, phys: PhysicsState, params: PhysicsParams,
                foot_pos: torch.Tensor, contact: torch.Tensor,
                command: torch.Tensor, cfg: SRBConfig, kin=None,
                height_ref=None):
    """Assemble the per-scenario LQR problems (F, c_tot, L, Xd, Ud, XTd,
    x0, f_ff), shared by the plain and the kernel solver.

    foot_pos (B, nf, 3), contact (B, nf), command (B, 3).  height_ref:
    optional world-z base-height reference, a float or (B,) (terrain-
    following callers pass local-ground + cfg.height_target); None keeps the
    flat-ground absolute cfg.height_target.
    """
    mass = torch.sum(model.mass) + params.added_mass
    # world-frame inertia about the CoM (frozen)
    if kin is None:
        kin = dynamics.forward_kinematics(model, phys, params)
    com, I_inv = _com_and_inertia_inv(model, kin)

    foot_rel = foot_pos - com[:, None]
    F, L = _srb_matrices(mass, I_inv, foot_rel, contact, cfg)

    # gravity enters as the affine drift c
    c = mass.new_zeros(mass.shape[0], N_STATE)
    c[:, 8] = -9.81 * cfg.dt

    Xd, Ud, x0 = _state_and_costs(phys, command, cfg, foot_pos.shape[1],
                                  height_ref)
    f_ff = _static_ff(foot_rel, contact, mass)
    c_tot = c + _mv(L, f_ff)  # drift with feedforward applied (now ~zero)
    return F, c_tot, L, Xd, Ud, 5.0 * Xd, x0, f_ff


def _srb_inertia(model: RobotModel, kin: dynamics.Kinematics,
                 com: torch.Tensor) -> torch.Tensor:
    """Whole-robot world-frame rotational inertia about the CoM, (B, 3, 3).

    The whole robot, not the trunk alone: at the 200 Hz leg loop the
    whole-robot inertia keeps the tilt smallest (the JAX package's note at
    pointfoot_tpu/mpc/srb.py:152-160).
    """
    eye3 = torch.eye(3, dtype=com.dtype, device=com.device)
    I_w = com.new_zeros(com.shape[0], 3, 3)
    for b in range(model.nb):
        d = kin.com_w[:, b] - com
        I_w = I_w + kin.inertia_w[:, b] + model.mass[b] * (
            torch.sum(d * d, dim=-1)[:, None, None] * eye3
            - d[:, :, None] * d[:, None, :])
    return I_w


def _static_ff(foot_rel: torch.Tensor, contact: torch.Tensor,
               mass: torch.Tensor) -> torch.Tensor:
    """Gravity feedforward (B, 3 nf): MOMENT-BALANCED static force
    distribution.

    A uniform weight split leaves a residual pitch/roll moment whenever
    the feet are not directly under the CoM; the LQR then discovers that
    REDUCING normal force reduces the tipping moment (the SRB model does
    not know that losing contact means falling) and plans itself to the
    ground.  Solve min ||f|| s.t. sum f = m g, sum r x f = 0 instead.
    """
    B, nf = foot_rel.shape[:2]
    eye3 = torch.eye(3, dtype=foot_rel.dtype, device=foot_rel.device)
    blocks = []
    for i in range(nf):
        gate = contact[:, i, None, None]
        blocks.append(torch.cat(
            [gate * spatial.skew(foot_rel[:, i]),
             gate * eye3.expand(B, 3, 3)], dim=1))  # (B, 6, 3)
    A_stat = torch.cat(blocks, dim=2)  # (B, 6, m)
    b_stat = foot_rel.new_zeros(B, 6)
    b_stat[:, 5] = 9.81 * mass
    AAt = A_stat @ A_stat.transpose(-1, -2) + 1e-6 * torch.eye(
        6, dtype=foot_rel.dtype, device=foot_rel.device)
    return _mv(A_stat.transpose(-1, -2), linalg_ops.chol_solve(AAt, b_stat))


def srb_problem_sched(model: RobotModel, phys: PhysicsState,
                      params: PhysicsParams, foot_pos: torch.Tensor,
                      contact_seq: torch.Tensor, command: torch.Tensor,
                      cfg: SRBConfig, kin=None, height_ref=None):
    """srb_problem with a CONTACT SCHEDULE over the horizon.

    The frozen-contact problem makes roll about a two-point support line
    uncontrollable for the whole lookahead, which is fatal for a quadruped
    trot, whose diagonal stance pairs alternate faster than the horizon.
    The convex-MPC formulation (Di Carlo 2018, MIT Cheetah 3, public
    method) gates the force columns per STEP from the gait clock's future
    stance masks, so the planner corrects roll using the NEXT diagonal.
    Swing feet should be passed at their predicted touchdown (step target),
    not their current airborne position.

    contact_seq: (B, T, nf) per-horizon-step stance gates.
    Returns (F, c_seq (B, T, n), L_seq (B, T, n, m), Xd, Ud, XTd, x0,
    f_ff_seq (B, T, m)).
    """
    mass = torch.sum(model.mass) + params.added_mass
    if kin is None:
        kin = dynamics.forward_kinematics(model, phys, params)
    com, I_inv = _com_and_inertia_inv(model, kin)
    foot_rel = foot_pos - com[:, None]
    B, T, nf = contact_seq.shape
    n = N_STATE
    c = mass.new_zeros(B, 1, n)
    c[:, 0, 8] = -9.81 * cfg.dt

    # every (scenario, step) pair as one row of a B·T batch
    def per_step(a: torch.Tensor) -> torch.Tensor:
        return a[:, None].expand((B, T) + a.shape[1:]).reshape(
            (B * T,) + a.shape[1:])

    ct = contact_seq.reshape(B * T, nf)
    F_seq, L_seq = _srb_matrices(per_step(mass), per_step(I_inv),
                                 per_step(foot_rel), ct, cfg)
    f_ff_seq = _static_ff(per_step(foot_rel), ct, per_step(mass))
    L_seq = L_seq.reshape(B, T, n, 3 * nf)
    f_ff_seq = f_ff_seq.reshape(B, T, 3 * nf)
    c_seq = c + _mv(L_seq, f_ff_seq)
    F = F_seq.reshape(B, T, n, n)[:, 0]  # time-invariant (contact only in L)

    Xd, Ud, x0 = _state_and_costs(phys, command, cfg, nf, height_ref)
    return F, c_seq, L_seq, Xd, Ud, 5.0 * Xd, x0, f_ff_seq


def _project_cone(fs: torch.Tensor, cfg: SRBConfig) -> torch.Tensor:
    """Unilateral + friction-cone projection, fs (..., T, nf, 3)."""
    fz = torch.clamp(fs[..., 2], 0.0, cfg.f_max)
    lim = cfg.mu * fz[..., None]
    fxy = torch.minimum(torch.maximum(fs[..., :2], -lim), lim)
    return torch.cat([fxy, fz[..., None]], dim=-1)


def sequential_srb_lqr(F, c_tot, L, Xd, Ud, XTd, x0, f_ff, horizon: int):
    """The problems of `srb_problem` solved by the sequential Riccati sweep
    of mpc/riccati.py and a gain rollout: (forces (B, T, m) before the cone
    projection, states (B, T+1, 12)).  What ops/cuda/riccati.srb_lqr
    computes in one kernel."""
    T = horizon
    U = torch.diag_embed(Ud)

    def over_time(a: torch.Tensor) -> torch.Tensor:
        return a[None].expand((T,) + a.shape)

    Ps, ps = riccati.sequential_lqr_value(
        over_time(F), over_time(c_tot), over_time(L),
        over_time(torch.diag_embed(Xd)), over_time(U), torch.diag_embed(XTd))

    x = x0
    fs, xs = [], [x0]
    for t in range(T):
        K, d = riccati.lqr_gains_from_value(F, c_tot, L, U, Ps[t + 1],
                                            ps[t + 1])
        du = -_mv(K, x) - d
        fs.append(f_ff + du)
        x = _mv(F, x) + c_tot + _mv(L, du)
        xs.append(x)
    return torch.stack(fs, dim=1), torch.stack(xs, dim=1)


def srb_plan(model: RobotModel, phys: PhysicsState, params: PhysicsParams,
             foot_pos: torch.Tensor, contact: torch.Tensor,
             command: torch.Tensor, cfg: SRBConfig, kin=None) -> SRBPlan:
    """One 50 Hz re-plan of every scenario by the sequential Riccati sweep.

    foot_pos: (B, nf, 3) current world foot positions; contact: (B, nf)
    {0,1} stance mask; command: (B, 3) desired (vx, vy, wz) in the base
    frame.  Pass `kin` to reuse an existing forward-kinematics evaluation.
    """
    prob = srb_problem(model, phys, params, foot_pos, contact, command, cfg,
                       kin=kin)
    fs, xs = sequential_srb_lqr(*prob, horizon=cfg.horizon)
    B, T = fs.shape[:2]
    return SRBPlan(forces=_project_cone(fs.reshape(B, T, -1, 3), cfg), xs=xs)


def _foot_ancestors(model: RobotModel, cidx: int) -> tuple:
    """Joint indices on the path base -> foot sphere's body (static)."""
    b = model.collision_body[cidx]
    path = []
    while b > 0:
        path.append(b - 1)
        b = model.parent[b]
    return tuple(reversed(path))


def _sphere_positions(model: RobotModel, kin: dynamics.Kinematics,
                      spheres: Sequence[int]) -> torch.Tensor:
    """(B, len(spheres), 3) world positions of collision spheres."""
    return torch.stack([
        kin.body_pos[:, model.collision_body[c]]
        + _mv(kin.body_rot[:, model.collision_body[c]],
              model.collision_offset[c])
        for c in spheres], dim=1)


def forces_to_torques(model: RobotModel, phys: PhysicsState,
                      params: PhysicsParams, feet_idx, forces: torch.Tensor,
                      contact: torch.Tensor, default_qpos, cfg: SRBConfig,
                      kin=None) -> torch.Tensor:
    """Stance legs realize the planned ground reaction: tau = C_j - J^T f
    (gravity/bias compensation + force mapping over the foot's ANCESTOR
    joints only; other legs' columns are zero), with light joint damping
    against internal buckling; swing legs run PD to the default pose.
    forces (B, nf, 3), contact (B, nf) -> (B, nj)."""
    if kin is None:
        kin = dynamics.forward_kinematics(model, phys, params)
    default_qpos = torch.as_tensor(default_qpos, dtype=phys.qpos.dtype,
                                   device=phys.qpos.device)
    S = dynamics.motion_subspaces(model, kin, phys.base_pos)
    body_vel = dynamics.body_spatial_velocities(model, phys, S)
    C = dynamics.bias_forces(model, params, kin, S, phys.qvel, body_vel,
                             phys.base_pos)
    tau = torch.zeros_like(phys.qpos)
    stance_mask = torch.zeros_like(phys.qpos)
    foot_rel = _sphere_positions(model, kin, feet_idx) - phys.base_pos[:, None]
    for k, cidx in enumerate(feet_idx):
        rel = foot_rel[:, k]
        for j in _foot_ancestors(model, cidx):
            col = S[:, 6 + j, 3:] + torch.linalg.cross(S[:, 6 + j, :3], rel,
                                                       dim=-1)
            tau[:, j] += contact[:, k] * torch.sum(-col * forces[:, k],
                                                   dim=-1)
            stance_mask[:, j] += contact[:, k]
    stance_mask = torch.clamp_max(stance_mask, 1.0)
    # bias compensation + stabilizing joint damping on stance legs
    tau = tau + stance_mask * (C[:, 6:] - cfg.kd_stance * phys.qvel
                               + cfg.kp_stance * (default_qpos - phys.qpos))
    pd = cfg.kp_swing * (default_qpos - phys.qpos) - cfg.kd_swing * phys.qvel
    tau = tau + (1.0 - stance_mask) * pd
    return torch.minimum(torch.maximum(tau, -model.effort_limit),
                         model.effort_limit)


class SRBController:
    """Batched SRB-MPC: 50 Hz force re-planning + 200 Hz leg torque loop.

    Two-rate structure (what real convex-MPC stacks run): `plan` produces
    ground-reaction force schedules at the control rate; `leg_torques`
    re-maps the held plan force to joint torques at the SIM substep rate
    using the current kinematics.  Without the fast remap, feedforward
    torques go stale within a tick and the stance legs buckle.

    `params` holds one row per scenario; the model and the default pose move
    to its device.
    """

    def __init__(self, model: RobotModel, params: PhysicsParams, feet_idx,
                 default_qpos, cfg: SRBConfig = SRBConfig()):
        device = params.kp.device
        self.model = model.to(device)
        self.params = params
        self.feet_idx = tuple(feet_idx)
        self.default_qpos = torch.as_tensor(
            default_qpos, dtype=torch.float32).to(device)
        self.cfg = cfg

    def plan(self, phys: PhysicsState, foot_pos: torch.Tensor,
             contact: torch.Tensor, command: torch.Tensor) -> SRBPlan:
        """(B, ...) batched re-plan."""
        return srb_plan(self.model, phys, self.params, foot_pos, contact,
                        command, self.cfg)

    def leg_torques(self, phys: PhysicsState, forces: torch.Tensor,
                    contact: torch.Tensor, kin=None) -> torch.Tensor:
        """(B, nf, 3) planned forces -> (B, nj) torques at current state."""
        return forces_to_torques(self.model, phys, self.params,
                                 self.feet_idx, forces, contact,
                                 self.default_qpos, self.cfg, kin=kin)

    def control(self, phys: PhysicsState, foot_pos: torch.Tensor,
                contact: torch.Tensor, command: torch.Tensor):
        """One-shot: plan + map the first force (single-rate convenience)."""
        plans = self.plan(phys, foot_pos, contact, command)
        tau = self.leg_torques(phys, plans.forces[:, 0], contact)
        return tau, plans

    def feet_and_contact(self, phys: PhysicsState
                         ) -> Tuple[dynamics.Kinematics, torch.Tensor,
                                    torch.Tensor]:
        """One forward-kinematics evaluation, the world foot positions
        (B, nf, 3) and the stance mask (B, nf): a foot is in stance when its
        sphere carries more than 1 N of normal force; a scenario with no
        foot in stance plans with all of them."""
        kin = dynamics.forward_kinematics(self.model, phys, self.params)
        foot_pos = _sphere_positions(self.model, kin, self.feet_idx)
        ct = (phys.contact_force[:, list(self.feet_idx), 2] > 1.0).to(
            foot_pos.dtype)
        ct = torch.where(torch.sum(ct, dim=1, keepdim=True) > 0, ct,
                         torch.ones_like(ct))
        return kin, foot_pos, ct

    def tick_problem(self, phys: PhysicsState, command: torch.Tensor):
        """What a tick solves: (the eight tensors of `srb_problem`, the
        stance mask, the kinematics)."""
        kin, foot_pos, ct = self.feet_and_contact(phys)
        prob = srb_problem(self.model, phys, self.params, foot_pos, ct,
                           command, self.cfg, kin=kin)
        return prob, ct, kin

    def plan_tick_cuda(self, phys: PhysicsState, command: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused tick with the SRB-LQR kernel (ops/cuda/riccati.py), the
        counterpart of `plan_tick_pallas` (pointfoot_tpu/mpc/srb.py:395):
        problem assembly and torque mapping stay batched PyTorch; the
        Riccati sweep and the force rollout of all scenarios run as ONE
        kernel launch.  On CUDA tensors it launches the kernel (a failed
        build or launch raises); on CPU tensors the kernel's plain version
        runs.  Returns (torques (B, nj), forces (B, T, nf, 3))."""
        prob, ct, kin = self.tick_problem(phys, command)
        fs = riccati_cuda.srb_lqr(*prob, horizon=self.cfg.horizon)
        B, T = fs.shape[:2]
        fs = _project_cone(fs.reshape(B, T, len(self.feet_idx), 3), self.cfg)
        tau = self.leg_torques(phys, fs[:, 0], ct, kin=kin)
        return tau, fs

    def plan_tick(self, phys: PhysicsState, command: torch.Tensor,
                  ) -> Tuple[torch.Tensor, SRBPlan]:
        """Fused 50 Hz tick with the sequential Riccati solver: ONE
        forward-kinematics evaluation shared by foot positions, contact
        detection, the SRB plan, and the torque map.
        Returns (torques (B, nj), plans)."""
        kin, foot_pos, ct = self.feet_and_contact(phys)
        plan = srb_plan(self.model, phys, self.params, foot_pos, ct, command,
                        self.cfg, kin=kin)
        tau = self.leg_torques(phys, plan.forces[:, 0], ct, kin=kin)
        return tau, plan
