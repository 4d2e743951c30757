"""Quaternion algebra in (x, y, z, w) order (pointfoot_tpu/ops/quat.py).

Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

from pointfoot_tpu_torch.device import const


def normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Unit-normalize, guarding against zero norm."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (body -> world), (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle -> quaternion (xyzw)."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]],
                     dim=-1)


def from_euler_zyx(roll: torch.Tensor, pitch: torch.Tensor,
                   yaw: torch.Tensor) -> torch.Tensor:
    """Intrinsic roll(x)-pitch(y)-yaw(z) Euler -> quaternion (URDF rpy)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def from_rotvec(rv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation vector (axis * angle) -> quaternion, Taylor-safe at 0."""
    angle = torch.linalg.vector_norm(rv, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < eps
    k = torch.where(small, 0.5 + angle ** 2 / 48.0,
                    torch.sin(half) / torch.where(small, 1.0, angle))
    return torch.cat([rv * k, torch.cos(half)], dim=-1)


def to_rotvec(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternion -> rotation vector (inverse of from_rotvec)."""
    qn = normalize(q)
    # keep w >= 0 for the short rotation
    w = qn[..., 3:4]
    qn = qn * torch.sign(torch.where(w == 0, 1.0, w))
    sin_half = torch.linalg.vector_norm(qn[..., :3], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, qn[..., 3:4])
    small = sin_half < eps
    scale = torch.where(small, 2.0,
                        angle / torch.where(small, 1.0, sin_half))
    return qn[..., :3] * scale


def integrate(q: torch.Tensor, omega_world: torch.Tensor,
              dt: float) -> torch.Tensor:
    """q' = normalize(q + dt/2 [ω, 0] ⊗ q), world-frame angular velocity."""
    dq = mul(torch.cat([omega_world, torch.zeros_like(omega_world[..., :1])],
                       dim=-1), q)
    return normalize(q + 0.5 * dt * dq)


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u, v = torch.broadcast_tensors(u, v)
    return torch.linalg.cross(u, v, dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (body -> world), expanded Rodrigues form."""
    qvec = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qvec, v)
    return v + w * t + _cross(qvec, t)


def rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q⁻¹ (world -> body)."""
    qvec = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qvec, v)
    return v - w * t + _cross(qvec, t)


def yaw(q: torch.Tensor) -> torch.Tensor:
    """Heading angle: atan2 of the rotated +x axis."""
    fwd = rotate(q, const((1.0, 0.0, 0.0), q).expand(q.shape[:-1] + (3,)))
    return torch.atan2(fwd[..., 1], fwd[..., 0])


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """Yaw-only component of q (x and y zeroed, renormalized)."""
    return normalize(q * const((0.0, 0.0, 1.0, 1.0), q))


def apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q."""
    return rotate(yaw_quat(q), v)


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-π, π]."""
    wrapped = torch.remainder(angle, 2.0 * math.pi)
    return torch.where(wrapped > math.pi, wrapped - 2.0 * math.pi, wrapped)


def heading_wz(heading_des: torch.Tensor, yaw_now: torch.Tensor,
               gain: float = 0.5, wz_max: float = 1.0) -> torch.Tensor:
    """Heading controller: wz = clip(gain * wrap_to_pi(err), ±wz_max)."""
    return torch.clamp(gain * wrap_to_pi(heading_des - yaw_now),
                       -wz_max, wz_max)
