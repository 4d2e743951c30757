"""Quaternion algebra in (x, y, z, w) order (pointfoot_tpu/ops/quat.py).

Only the subset the env layer uses.  Every function broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

import math

import torch


def normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Unit-normalize, guarding against zero norm."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


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
    fwd = rotate(q, q.new_tensor([1.0, 0.0, 0.0]).expand(q.shape[:-1] + (3,)))
    return torch.atan2(fwd[..., 1], fwd[..., 0])


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """Yaw-only component of q (x and y zeroed, renormalized)."""
    return normalize(q * q.new_tensor([0.0, 0.0, 1.0, 1.0]))


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
