"""Robot model, per-env physics parameters and dynamic state
(a frozen copy of the port's physics/model.py) as dataclasses of tensors."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch


def _to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclass(frozen=True)
class RobotModel:
    """Static articulated-body model; joint j connects parent[j+1] to body
    j+1.  Float arrays are float32 tensors."""

    nb: int
    parent: Tuple[int, ...]
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    collision_body: Tuple[int, ...]
    collision_names: Tuple[str, ...]
    joint_pos: torch.Tensor  # (nj, 3) anchor in parent frame
    joint_rot: torch.Tensor  # (nj, 4) child frame in parent frame at q=0, xyzw
    joint_axis: torch.Tensor  # (nj, 3)
    q_lower: torch.Tensor  # (nj,)
    q_upper: torch.Tensor
    effort_limit: torch.Tensor
    velocity_limit: torch.Tensor
    joint_damping: torch.Tensor
    joint_friction: torch.Tensor
    mass: torch.Tensor  # (nb,)
    com: torch.Tensor  # (nb, 3) body frame
    inertia: torch.Tensor  # (nb, 3, 3) about the CoM, body frame
    collision_offset: torch.Tensor  # (nc, 3)
    collision_radius: torch.Tensor  # (nc,)

    @property
    def nj(self) -> int:
        return self.nb - 1

    @property
    def nv(self) -> int:
        return 6 + self.nb - 1

    def collision_indices(self, substr: str) -> Tuple[int, ...]:
        """Indices of collision spheres whose link name contains substr."""
        return tuple(i for i, n in enumerate(self.collision_names)
                     if substr in n)

    def to(self, device) -> "RobotModel":
        return _to(self, device)


@dataclass(frozen=True)
class PhysicsParams:
    """Per-env randomized physics parameters (leading batch dim)."""

    friction: torch.Tensor  # (B, nc)
    joint_friction: torch.Tensor  # (B, nj)
    added_mass: torch.Tensor  # (B,)
    com_offset: torch.Tensor  # (B, 3)
    kp: torch.Tensor  # (B, nj)
    kd: torch.Tensor  # (B, nj)
    contact_stiffness: torch.Tensor  # (B,)
    contact_damping: torch.Tensor  # (B,)

    @classmethod
    def nominal(cls, model: RobotModel, batch: int, device,
                kp: float = 40.0, kd: float = 1.5, friction: float = 1.0,
                contact_stiffness: float = 1.2e4,
                contact_damping: float = 1.2e3) -> "PhysicsParams":
        nc = len(model.collision_body)
        nj = model.nj

        def full(shape, v):
            return torch.full((batch,) + shape, v, dtype=torch.float32,
                              device=device)

        return cls(
            friction=full((nc,), friction),
            joint_friction=model.joint_friction.to(device).expand(
                batch, nj).clone(),
            added_mass=full((), 0.0),
            com_offset=full((3,), 0.0),
            kp=full((nj,), kp),
            kd=full((nj,), kd),
            contact_stiffness=full((), contact_stiffness),
            contact_damping=full((), contact_damping),
        )

    def broadcast(self, batch: int) -> "PhysicsParams":
        """The parameters of `batch` rows: a one-row set expanded without a
        copy (what a planner's single-env parameters become for its rows);
        a set of `batch` rows is unchanged, and any other size raises."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).expand(
                (batch,) + getattr(self, f.name).shape[1:])
            for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class PhysicsState:
    """World-frame base pose and velocity, joint state, contact forces."""

    base_pos: torch.Tensor  # (B, 3)
    base_quat: torch.Tensor  # (B, 4) xyzw, body -> world
    base_lin_vel: torch.Tensor  # (B, 3) world, at the base origin
    base_ang_vel: torch.Tensor  # (B, 3) world
    qpos: torch.Tensor  # (B, nj)
    qvel: torch.Tensor  # (B, nj)
    contact_force: torch.Tensor  # (B, nc, 3) world force on each sphere

    @classmethod
    def default(cls, model: RobotModel, default_qpos, batch: int, device,
                base_height: float = 0.8) -> "PhysicsState":
        """`batch` copies of the robot at rest: upright at `base_height`,
        joints at `default_qpos`, no contact force."""
        nc = len(model.collision_body)
        qpos = torch.as_tensor(default_qpos, dtype=torch.float32,
                               device=device).reshape(model.nj)

        def rows(values):
            return torch.tensor(values, dtype=torch.float32,
                                device=device).expand(batch, -1).clone()

        def zeros(*shape):
            return torch.zeros((batch,) + shape, dtype=torch.float32,
                               device=device)

        return cls(
            base_pos=rows([0.0, 0.0, base_height]),
            base_quat=rows([0.0, 0.0, 0.0, 1.0]),
            base_lin_vel=zeros(3), base_ang_vel=zeros(3),
            qpos=qpos.expand(batch, -1).clone(), qvel=zeros(model.nj),
            contact_force=zeros(nc, 3))

    def replace(self, **changes) -> "PhysicsState":
        return dataclasses.replace(self, **changes)
