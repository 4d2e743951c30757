"""MPC state vectorization and stage costs from the PointFoot reward scales
(pointfoot_tpu/mpc/costs.py).

The MPC state chart is x = [base_pos(3), rotvec(3), qpos(nj),
base_lin_vel(3), base_ang_vel(3), qvel(nj)]: the quaternion is charted as
a rotation vector so iLQR's additive updates stay on the manifold.

Stage costs re-use the reference reward semantics as penalties: velocity
tracking, upright orientation, base height, vertical and roll-pitch
velocity damping, control effort, joint-velocity damping, with weights
from the pointfoot_rough reward scales, sign-flipped.

The cost is written without in-place writes, over any leading dims, so
`torch.func` differentiates it and one call costs a whole batch of rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.physics.model import PhysicsState, RobotModel


def state_to_vec(phys: PhysicsState) -> torch.Tensor:
    """(..., 12 + 2 nj) chart of a state."""
    return torch.cat([
        phys.base_pos,
        quat_ops.to_rotvec(phys.base_quat),
        phys.qpos,
        phys.base_lin_vel,
        phys.base_ang_vel,
        phys.qvel,
    ], dim=-1)


def vec_to_state(x: torch.Tensor, template: PhysicsState,
                 nj: int) -> PhysicsState:
    """The state of chart rows x (..., 12 + 2 nj); the contact force, which
    the chart does not hold, is the template's (one row, broadcast)."""
    cf = template.contact_force
    return PhysicsState(
        base_pos=x[..., 0:3],
        base_quat=quat_ops.from_rotvec(x[..., 3:6]),
        qpos=x[..., 6:6 + nj],
        base_lin_vel=x[..., 6 + nj:9 + nj],
        base_ang_vel=x[..., 9 + nj:12 + nj],
        qvel=x[..., 12 + nj:12 + 2 * nj],
        contact_force=cf.expand(x.shape[:-1] + cf.shape[-2:]),
    )


@dataclass(frozen=True)
class CostWeights:
    """Stage-cost weights (defaults from pointfoot_rough reward scales)."""

    tracking_lin_vel: float = 10.0
    tracking_ang_vel: float = 5.0
    lin_vel_z: float = 0.5
    ang_vel_xy: float = 0.05
    orientation: float = 5.0
    base_height: float = 10.0
    torques: float = 2.5e-4
    qvel: float = 1e-4
    qpos_home: float = 0.1  # stay near default joint pose
    terminal_scale: float = 5.0
    base_height_target: float = 0.62
    tracking_sigma: float = 0.25


def _sq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def pointfoot_stage_cost(model: RobotModel, weights: CostWeights,
                         default_qpos, command, horizon: int):
    """Build `cost_fn(x, u, t)` for ilqr_solve.

    `command` = (vx, vy, wz) desired base-frame velocities, (3,) for every
    row or (B, 3) for B scenarios: its leading dims line up with those of
    x from the left, so x (B, ..., n) takes scenario b's command for every
    row x[b, ...].  The terminal step (t >= horizon) is the state cost
    scaled by `terminal_scale`, with no control term.
    """
    nj = model.nj
    w = weights
    cmd_all = torch.as_tensor(command, dtype=torch.float32)
    qdef = torch.as_tensor(default_qpos, dtype=torch.float32)

    def cost_fn(x, u, t):
        cmd = cmd_all.to(x.device)
        cmd = cmd.reshape(cmd.shape[:-1] + (1,) * (x.dim() - cmd.dim())
                          + cmd.shape[-1:])
        pos = x[..., 0:3]
        q = quat_ops.from_rotvec(x[..., 3:6])
        qpos = x[..., 6:6 + nj]
        lin = x[..., 6 + nj:9 + nj]
        ang = x[..., 9 + nj:12 + nj]
        qvel = x[..., 12 + nj:12 + 2 * nj]
        v_body = quat_ops.rotate_inverse(q, lin)
        w_body = quat_ops.rotate_inverse(q, ang)
        down = torch.tensor([0.0, 0.0, -1.0], dtype=x.dtype, device=x.device)
        g_proj = quat_ops.rotate_inverse(q, down.expand(lin.shape))

        # tracking terms: quadratic (exp-of-error rewards linearize poorly)
        c = w.tracking_lin_vel * _sq(v_body[..., :2] - cmd[..., :2])
        c = c + w.tracking_ang_vel * (w_body[..., 2] - cmd[..., 2]) ** 2
        c = c + w.lin_vel_z * v_body[..., 2] ** 2
        c = c + w.ang_vel_xy * _sq(w_body[..., :2])
        c = c + w.orientation * _sq(g_proj[..., :2])
        c = c + w.base_height * (pos[..., 2] - w.base_height_target) ** 2
        c = c + w.qpos_home * _sq(qpos - qdef.to(x.device))
        c = c + w.qvel * _sq(qvel)
        ctrl_cost = w.torques * _sq(u)
        return torch.where(torch.as_tensor(t, device=x.device) >= horizon,
                           w.terminal_scale * c, c + ctrl_cost)

    return cost_fn
