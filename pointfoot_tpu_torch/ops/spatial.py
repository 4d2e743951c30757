"""6-D spatial (Plücker) algebra in world-aligned coordinates
(pointfoot_tpu/ops/spatial.py).

Spatial vectors are stacked [angular; linear] (Featherstone) and expressed
about a per-env origin at the current base position, which keeps float32
magnitudes small however far a robot walks.  Every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

from typing import Optional

import torch


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u, v = torch.broadcast_tensors(u, v)
    return torch.linalg.cross(u, v, dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix, batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v ×m m ([w; v0] × [w2; v2])."""
    w, vl = v[..., :3], v[..., 3:]
    w2, v2 = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, w2), _cross(w, v2) + _cross(vl, w2)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v ×f f (dual of motion_cross)."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, n) + _cross(vl, fl), _cross(w, fl)], dim=-1)


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    inertia_com: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) spatial inertia about the working origin:
    [[I_C + m c̃ c̃ᵀ, m c̃], [m c̃ᵀ, m E]] for mass (...,), CoM relative to
    the origin (..., 3) and CoM inertia in world axes (..., 3, 3)."""
    cx = skew(com)
    m = mass[..., None, None]
    top_left = inertia_com + m * (cx @ cx.transpose(-1, -2))
    top_right = m * cx
    bot_left = top_right.transpose(-1, -2)
    eye = torch.eye(3, dtype=com.dtype, device=com.device).expand(
        top_left.shape)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def revolute_subspace(axis_world: torch.Tensor,
                      anchor_rel: torch.Tensor) -> torch.Tensor:
    """Motion subspace of a revolute joint: [axis; anchor × axis]."""
    return torch.cat([axis_world, _cross(anchor_rel, axis_world)], dim=-1)


def point_velocity(spatial_vel: torch.Tensor,
                   point_rel: torch.Tensor) -> torch.Tensor:
    """Linear velocity of a body-fixed point (point − origin) from the
    body's spatial velocity [w; v_origin]."""
    w, v = spatial_vel[..., :3], spatial_vel[..., 3:]
    return v + _cross(w, point_rel)


def force_at_point(force: torch.Tensor, point_rel: torch.Tensor,
                   torque: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Spatial force about the origin of a linear force at a point."""
    n = _cross(point_rel, force)
    if torque is not None:
        n = n + torque
    return torch.cat([n, force], dim=-1)


def rotate_inertia(rot: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """R I Rᵀ, batched."""
    return rot @ inertia @ rot.transpose(-1, -2)
