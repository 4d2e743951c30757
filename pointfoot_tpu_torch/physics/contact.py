"""Compliant sphere-vs-heightfield contact with implicit damping terms
(pointfoot_tpu/physics/contact.py).

Per active sphere, with penetration `pen` along the terrain normal: a
spring k·pen whose excess beyond the static-rest band fades as the point
exits, normal damping capped so the predicted normal force stays
non-negative, and regularized Coulomb friction.  Damping and friction enter
the velocity solve implicitly as dt·JᵀDJ (physics/dynamics.py).  The same
force law, written over per-env rows, is physics/rowdyn.py, the body of the
substep kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pointfoot_tpu_torch.ops import spatial

# PhysX max_depenetration_velocity parity: only penetration in excess of
# the static-rest band fades as the contact point exits at this speed.
MAX_DEPENETRATION_VEL = 1.0  # m/s
# static-rest band: ordinary stance and touchdown loads live in this depth
# and always carry their full spring.
PEN_REST = 0.05  # m


class ContactTerms(NamedTuple):
    """What the implicit velocity solve needs from the contact model."""

    jac: torch.Tensor  # (B, nc, 3, nv) point Jacobians
    f_spring: torch.Tensor  # (B, nc, 3) explicit stiffness forces
    damp: torch.Tensor  # (B, nc, 3, 3) implicit damping matrices
    normal: torch.Tensor  # (B, nc, 3)
    active: torch.Tensor  # (B, nc) bool


def _ancestor_joints(model, b: int) -> Tuple[int, ...]:
    """Joint indices on the path base -> body b."""
    out = []
    while b > 0:
        out.append(b - 1)
        b = model.parent[b]
    return tuple(reversed(out))


def terrain_normal(height_fn, x, y, eps: float = 0.02):
    """Finite-difference unit surface normal of a height function."""
    dhdx = (height_fn(x + eps, y) - height_fn(x - eps, y)) / (2 * eps)
    dhdy = (height_fn(x, y + eps) - height_fn(x, y - eps)) / (2 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def query_surface(height_fn, x, y):
    """(height, unit normal) of the terrain under (x, y): one gather through
    the `surface_fn` a terrain attaches to its height function, else finite
    differences of the bare height function."""
    surf = getattr(height_fn, "surface_fn", None)
    if surf is not None:
        return surf(x, y)
    return height_fn(x, y), terrain_normal(height_fn, x, y)


def contact_terms(model, params, kin, body_vel: torch.Tensor,
                  S: torch.Tensor, origin: torch.Tensor, height_fn,
                  surface=None) -> ContactTerms:
    """Jacobians, spring forces and damping matrices of every sphere, for a
    batch: kin fields (B, nb, ...), body_vel (B, nb, 6), S (B, nv, 6),
    origin (B, 3).  The terrain under each sphere comes from `height_fn`,
    or from `surface` = (heights (B, nc), unit normals (B, nc, 3)) when
    given, as the substep kernel takes it."""
    nc = len(model.collision_body)
    nv = model.nv
    B = origin.shape[0]
    dev, dt_ = origin.device, origin.dtype
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    k = params.contact_stiffness
    d = params.contact_damping
    pos = torch.stack([
        kin.body_pos[:, b] + kin.body_rot[:, b] @ model.collision_offset[c]
        for c, b in enumerate(model.collision_body)], dim=1)  # (B, nc, 3)
    if surface is None:
        # one query for all spheres: the terrain is elementwise in (x, y),
        # and one stacked query dispatches nc times fewer kernels
        surface = query_surface(height_fn, pos[..., 0], pos[..., 1])
    jacs, springs, damps, normals, actives = [], [], [], [], []
    for c in range(nc):
        b = model.collision_body[c]
        p = pos[:, c]
        h, n = surface[0][:, c], surface[1][:, c]
        gap = (p[:, 2] - model.collision_radius[c] - h) * n[:, 2]
        # penetration cap: a deep one-substep tunnel gets a bounded kick
        pen = torch.clamp_max(torch.clamp_min(-gap, 0.0), 0.2)
        active = pen > 0.0
        rel = p - origin

        J = torch.zeros(B, 3, nv, dtype=dt_, device=dev)
        J[:, :, 0:3] = -spatial.skew(rel)
        J[:, :, 3:6] = eye3
        for j in _ancestor_joints(model, b):
            J[:, :, 6 + j] = S[:, 6 + j, 3:] + torch.linalg.cross(
                S[:, 6 + j, :3], rel, dim=-1)

        v_p = spatial.point_velocity(body_vel[:, b], rel)
        v_n = torch.sum(n * v_p, dim=-1)
        v_t = v_p - n * v_n[:, None]
        vt_norm = torch.linalg.vector_norm(v_t, dim=-1)

        # depenetration-velocity cap: the excess-penetration spring fades
        # over v_n in [0, 1] m/s, the static-rest band over [1, 1.5] m/s
        s_dep = torch.clamp(1.0 - v_n / MAX_DEPENETRATION_VEL, 0.0, 1.0)
        s_band = torch.clamp(
            1.0 - 2.0 * (v_n / MAX_DEPENETRATION_VEL - 1.0), 0.0, 1.0)
        pen_load = torch.clamp_max(pen, PEN_REST)
        f_n_spring = k * (pen_load * s_band + (pen - pen_load) * s_dep)
        f_spring = torch.where(active, f_n_spring, 0.0)[:, None] * n

        # unilateral contact: the implicit normal damping may not turn the
        # predicted normal force into adhesion at the pre-step speed
        d_cap = f_n_spring / torch.clamp_min(v_n, 0.05)
        d_n = torch.where(active, torch.minimum(d, d_cap), 0.0)
        # friction cone at the predicted normal force
        f_n_hat = torch.clamp_min(
            f_n_spring - d_n * torch.clamp_min(v_n, 0.0), 0.0)
        mu = params.friction[:, c]
        c_t = torch.where(
            active,
            torch.clamp_max(mu * f_n_hat / torch.clamp_min(vt_norm, 1e-3),
                            2e3),
            0.0)
        nn = n[:, :, None] * n[:, None, :]
        D = d_n[:, None, None] * nn + c_t[:, None, None] * (eye3 - nn)

        jacs.append(J)
        springs.append(f_spring)
        damps.append(D)
        normals.append(n)
        actives.append(active)

    return ContactTerms(
        jac=torch.stack(jacs, dim=1), f_spring=torch.stack(springs, dim=1),
        damp=torch.stack(damps, dim=1), normal=torch.stack(normals, dim=1),
        active=torch.stack(actives, dim=1))


def contact_forces(model, params, kin, body_vel: torch.Tensor,
                   S: torch.Tensor, origin: torch.Tensor, height_fn
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit evaluation, batched as `contact_terms`: the force of each
    sphere at the current velocity (B, nc, 3) and their generalized force
    (B, nv).  For physics/dynamics.forward_dynamics and tests; the
    simulator's step applies damping and friction implicitly instead."""
    terms = contact_terms(model, params, kin, body_vel, S, origin, height_fn)
    forces = resolve_forces(model, terms, kin, body_vel, origin)
    tau = torch.einsum("bciv,bci->bv", terms.jac, forces)
    return forces, tau


def resolve_forces(model, terms: ContactTerms, kin, body_vel: torch.Tensor,
                   origin: torch.Tensor) -> torch.Tensor:
    """(B, nc, 3): the force each sphere applies at the current body
    velocities, explicitly."""
    out = []
    for c, b in enumerate(model.collision_body):
        p = kin.body_pos[:, b] + kin.body_rot[:, b] @ model.collision_offset[c]
        v_p = spatial.point_velocity(body_vel[:, b], p - origin)
        f = terms.f_spring[:, c] - (terms.damp[:, c] @ v_p[..., None])[..., 0]
        out.append(_project_cone(f, terms.normal[:, c], terms.active[:, c]))
    return torch.stack(out, dim=1)


def _project_cone(f: torch.Tensor, n: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """No adhesion: the normal part clamped at 0, the tangential part kept
    (the friction coefficient already cones it); 0 where not in contact."""
    f_n = torch.sum(f * n, dim=-1, keepdim=True)
    f_t = f - f_n * n
    return torch.where(active[..., None], torch.clamp_min(f_n, 0.0) * n + f_t,
                       0.0)
