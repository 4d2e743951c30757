"""ANYmal C with its actuator network on the scan path: the plain route of
the port's `anymal_c_rough` env, a subclass of the frozen legged_env.py.

The port steps this task through its scan path (envs/legged_env.py
`_physics_rollout`): each of the `decimation` substeps runs one tick of the
ANYdrive v3 actuator LSTM (actuator.py) on every joint's position error and
velocity, clamps the torque to the effort limits, and takes one
`physics.dynamics.step_batched` on its mega-kernel route, kernels 4 and 3
on the card.  This env takes the same substeps through their plain twins
(scan_substep.py); the final state's sphere positions, which the fused
rollout returns and the scan path does not, come from the forward
kinematics the port's env runs for its feet (`body_poses`).  Everything
after the physics (rewards, resets, observations, commands, pushes, the
curriculum) is the frozen env's, in the same order of random draws.

The task is legged_gym's `AnymalCRoughCfg` / `AnymalCRoughCfgPPO`
(legged_gym/envs/anymal_c/mixed_terrains/anymal_c_rough_config.py) as the
port registers it.  Departures from legged_gym's published description:

- Physics.  legged_gym steps Isaac Gym's PhysX on the URDF's collision
  shapes and a triangle mesh of the terrain; here the bodies touch the
  ground through the model's collision spheres with implicit soft contact
  (the sim's contact stiffness and damping) against the height and normal
  of the table terrain, and the articulated dynamics are the port's
  (rowdyn.py).
- Actuator torque.  legged_gym's `anymal.py` hands the TorchScript
  network's torque to the simulator unclipped; here it is clamped to the
  model's effort limits, as the JAX package does.  The network's weights
  are the baked copy of `anydrive_v3_lstm.pt` (assets/), evaluated in
  float32 with the biases of a layer summed once.
- Terrain.  The table terrain is the port's generator (grid.py) with legged
  gym's sizes and proportions (10 x 20 terrains of 8 m at 0.1 m), drawn
  from its own seed, so the heights are not legged_gym's.
- Randomness.  The draws come from torch generators seeded by the run; they
  follow the port's order, not Isaac Gym's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from benchmark.reference import quat as quat_ops
from benchmark.reference.actuator import (actuator_net_torque, init_carry,
                                          load_anydrive_weights)
from benchmark.reference.config import LeggedEnvCfg
from benchmark.reference.legged_env import EnvState, LeggedEnv
from benchmark.reference.model import PhysicsState, RobotModel
from benchmark.reference.scan_substep import step_batched_plain


def _skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix, batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _axis_angle_mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation (B, 3, 3) about a constant unit axis."""
    K = _skew(axis)
    s = torch.sin(angle)[:, None, None]
    c = torch.cos(angle)[:, None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def body_poses(model: RobotModel, state: PhysicsState
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World body-frame origins (B, nb, 3) and rotations (B, nb, 3, 3): the
    port's physics/dynamics.forward_kinematics, cut to the poses."""
    pos = [state.base_pos]
    rot = [quat_ops.to_matrix(state.base_quat)]
    joint_rot_mats = quat_ops.to_matrix(model.joint_rot)  # (nj, 3, 3)
    for b in range(1, model.nb):
        j = b - 1
        p = model.parent[b]
        anchor = pos[p] + rot[p] @ model.joint_pos[j]
        frame0 = rot[p] @ joint_rot_mats[j]
        rot.append(frame0 @ _axis_angle_mat(model.joint_axis[j],
                                            state.qpos[:, j]))
        pos.append(anchor)
    return torch.stack(pos, dim=1), torch.stack(rot, dim=1)


class AnymalEnv(LeggedEnv):
    """The frozen env with the actuator network on the scan path."""

    def __init__(self, cfg: LeggedEnvCfg, device):
        if not cfg.control.use_actuator_network:
            raise ValueError("AnymalEnv steps the actuator network's task")
        # the frozen env refuses the actuator network: build it without,
        # then hold the configuration as it runs
        super().__init__(dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, use_actuator_network=False)), device)
        self.cfg = cfg
        self.actuator_weights = load_anydrive_weights(self.device)

    def init_state(self, seed: int = 0,
                   random_episode_step: bool = False) -> EnvState:
        """The frozen env's fresh state with the actuator network's zero
        carry (B, nj, LAYERS, 2, HIDDEN); no draw depends on it."""
        state = super().init_state(seed, random_episode_step)
        return state.replace(actuator_carry=init_carry(
            (self.num_envs, self.model.nj), self.device))

    def _sphere_positions(self, phys: PhysicsState) -> torch.Tensor:
        """(B, nc, 3) world collision-sphere centres, each as the port's
        env computes a foot's."""
        m = self.model
        body_pos, body_rot = body_poses(m, phys)
        return torch.stack([
            body_pos[:, m.collision_body[c]]
            + body_rot[:, m.collision_body[c]] @ m.collision_offset[c]
            for c in range(len(m.collision_body))], dim=1)

    def _physics_rollout(self, state: EnvState, actions: torch.Tensor):
        """Decimation loop: an actuator tick, then one substep through the
        plain twins of kernels 4 and 3; the queued push on substep 0 only.
        Returns (physics, last torques, actuator carry, sphere positions of
        the final state)."""
        c = self.cfg.control
        phys = state.physics
        act_carry = state.actuator_carry
        no_push = torch.zeros_like(state.push_force)
        for i in range(c.decimation):
            pos_err = (actions * c.action_scale + self.default_qpos
                       - phys.qpos)
            tau, act_carry = actuator_net_torque(
                self.actuator_weights, act_carry, pos_err, phys.qvel)
            tau = torch.clamp(tau, -self.torque_limit, self.torque_limit)
            phys = step_batched_plain(
                self.model, state.params, phys, tau, self.height_fn,
                self.cfg.sim.dt,
                external_force=state.push_force if i == 0 else no_push,
                gravity=self.cfg.sim.gravity)
        return phys, tau, act_carry, self._sphere_positions(phys)
