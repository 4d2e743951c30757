"""Articulated floating-base dynamics: FK, CRBA, RNEA, implicit step
(pointfoot_tpu/physics/dynamics.py), batched.

Generalized velocity u = [ω_world(3); v_base_world(3); q̇(nj)], spatial
algebra in world-aligned axes about the current base position
(ops/spatial.py).  Every function takes the batch as the leading axis of
each state and parameter tensor; the model's tensors lie on the same
device.

`forward_dynamics` is the explicit acceleration with contact forces at the
current velocity (tests and smooth models).  `step_batched` is the substep
the env's scan path calls.  It picks one of
three routes, as the JAX function does:

- mega-kernel, B >= MEGA_MIN_BATCH: the sphere-xy FK kernel, the terrain
  surface query, the substep kernel (ops/cuda/substep.py), whose wrappers
  run their plain versions for CPU tensors;
- batched Cholesky, CUDA and CHOL_MIN_BATCH <= B < MEGA_MIN_BATCH: batched
  assembly, the Cholesky kernel (ops/cuda/cholesky.py), `finish_step`;
- plain, otherwise: batched assembly, `linalg.chol_solve`, `finish_step`.

The mega-kernel route runs in the span `physics.step_batched`
(utils/profiling.py): the FK, the surface query and the substep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pointfoot_tpu_torch.ops import linalg as linalg_ops
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.ops import spatial
from pointfoot_tpu_torch.ops.cuda import cholesky as chol_cuda
from pointfoot_tpu_torch.ops.cuda import substep as substep_cuda
from pointfoot_tpu_torch.physics import contact as contact_mod
from pointfoot_tpu_torch.physics.model import (PhysicsParams, PhysicsState,
                                               RobotModel)
from pointfoot_tpu_torch.utils import profiling

# step_batched's routes, at the JAX thresholds: the substep mega-kernel
# from one 8 x 512 grid block of envs (pointfoot_tpu/physics/dynamics.py:502
# with _BLOCK of pointfoot_tpu/ops/pallas/substep.py:35-41); the batched
# Cholesky kernel from CHOL_MIN_BATCH = 128 envs, one 128-lane block
# (dynamics.py:514, ops/cuda/cholesky.py).
MEGA_MIN_BATCH = 4096
CHOL_MIN_BATCH = chol_cuda.CHOL_MIN_BATCH


class Kinematics(NamedTuple):
    """World-frame forward kinematics of a batch."""

    body_pos: torch.Tensor  # (B, nb, 3) world body-frame origins
    body_rot: torch.Tensor  # (B, nb, 3, 3) body -> world
    joint_axis_w: torch.Tensor  # (B, nj, 3) world joint axes
    joint_anchor: torch.Tensor  # (B, nj, 3) world anchors
    com_w: torch.Tensor  # (B, nb, 3) world CoM positions
    inertia_w: torch.Tensor  # (B, nb, 3, 3) CoM inertia in world axes


def _axis_angle_mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation (B, 3, 3) about a constant unit axis."""
    K = spatial.skew(axis)
    s = torch.sin(angle)[:, None, None]
    c = torch.cos(angle)[:, None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def forward_kinematics(model: RobotModel, state: PhysicsState,
                       params: PhysicsParams) -> Kinematics:
    """World poses of all bodies (python loop over the static tree)."""
    nb = model.nb
    B = state.base_pos.shape[0]
    pos = [state.base_pos]
    rot = [quat_ops.to_matrix(state.base_quat)]
    axes, anchors = [], []
    joint_rot_mats = quat_ops.to_matrix(model.joint_rot)  # (nj, 3, 3)
    for b in range(1, nb):
        j = b - 1
        p = model.parent[b]
        anchor = pos[p] + rot[p] @ model.joint_pos[j]
        frame0 = rot[p] @ joint_rot_mats[j]
        axes.append(frame0 @ model.joint_axis[j])
        rot.append(frame0 @ _axis_angle_mat(model.joint_axis[j],
                                            state.qpos[:, j]))
        pos.append(anchor)
        anchors.append(anchor)
    body_pos = torch.stack(pos, dim=1)
    body_rot = torch.stack(rot, dim=1)
    # base CoM shift from domain randomization
    com_body = model.com.expand(B, nb, 3).clone()
    com_body[:, 0] = com_body[:, 0] + params.com_offset
    com_w = body_pos + torch.einsum("bnij,bnj->bni", body_rot, com_body)
    empty = body_pos.new_zeros(B, 0, 3)
    return Kinematics(
        body_pos=body_pos, body_rot=body_rot,
        joint_axis_w=torch.stack(axes, dim=1) if nb > 1 else empty,
        joint_anchor=torch.stack(anchors, dim=1) if nb > 1 else empty,
        com_w=com_w,
        inertia_w=spatial.rotate_inertia(body_rot, model.inertia))


def _effective_masses(model: RobotModel, params: PhysicsParams
                      ) -> torch.Tensor:
    """(B, nb) masses with the randomized base payload."""
    m = model.mass.expand(params.added_mass.shape[0], model.nb).clone()
    m[:, 0] = m[:, 0] + params.added_mass
    return m


def motion_subspaces(model: RobotModel, kin: Kinematics,
                     origin: torch.Tensor) -> torch.Tensor:
    """(B, nv, 6) motion-subspace rows about `origin` (the base position);
    the base rows are the identity basis."""
    B = origin.shape[0]
    base = torch.eye(6, dtype=origin.dtype, device=origin.device).expand(
        B, 6, 6)
    if model.nj == 0:
        return base
    joint_rows = spatial.revolute_subspace(
        kin.joint_axis_w, kin.joint_anchor - origin[:, None])
    return torch.cat([base, joint_rows], dim=1)


def body_spatial_velocities(model: RobotModel, state: PhysicsState,
                            S: torch.Tensor) -> torch.Tensor:
    """(B, nb, 6) spatial velocity of each body about the base origin."""
    vels = [torch.cat([state.base_ang_vel, state.base_lin_vel], dim=-1)]
    for b in range(1, model.nb):
        j = b - 1
        vels.append(vels[model.parent[b]]
                    + S[:, 6 + j] * state.qvel[:, j:j + 1])
    return torch.stack(vels, dim=1)


def _body_inertias(model, params, kin, origin) -> torch.Tensor:
    return spatial.spatial_inertia(_effective_masses(model, params),
                                   kin.com_w - origin[:, None],
                                   kin.inertia_w)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def mass_matrix(model: RobotModel, params: PhysicsParams, kin: Kinematics,
                S: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """(B, nv, nv) joint-space inertia matrix by CRBA."""
    nb, nj, nv = model.nb, model.nj, model.nv
    I_bodies = _body_inertias(model, params, kin, origin)
    Ic = [I_bodies[:, b] for b in range(nb)]
    for b in range(nb - 1, 0, -1):
        Ic[model.parent[b]] = Ic[model.parent[b]] + Ic[b]
    M = S.new_zeros(S.shape[0], nv, nv)
    M[:, :6, :6] = Ic[0]
    for j in range(nj):
        b = j + 1
        F = (Ic[b] @ S[:, 6 + j, :, None])[..., 0]
        M[:, 6 + j, 6 + j] = _dot(S[:, 6 + j], F)
        # movable ancestors
        i = model.parent[b]
        while i > 0:
            jj = i - 1
            v = _dot(S[:, 6 + jj], F)
            M[:, 6 + j, 6 + jj] = v
            M[:, 6 + jj, 6 + j] = v
            i = model.parent[i]
        # base coupling (S_base is the identity)
        M[:, :6, 6 + j] = F
        M[:, 6 + j, :6] = F
    return M


def inverse_dynamics(model: RobotModel, params: PhysicsParams,
                     kin: Kinematics, S: torch.Tensor, qvel: torch.Tensor,
                     body_vel: torch.Tensor, origin: torch.Tensor,
                     udot: torch.Tensor, gravity: float = 9.81
                     ) -> torch.Tensor:
    """RNEA: (B, nv) generalized forces realizing `udot`, with gravity as a
    pseudo-acceleration of the base."""
    nb, nv = model.nb, model.nv
    I_bodies = _body_inertias(model, params, kin, origin)

    def imul(b, x):
        return (I_bodies[:, b] @ x[..., None])[..., 0]

    # a fill on the device: setting an element from a host scalar copies it
    # to the card and waits, which a CUDA graph cannot capture
    a_grav = torch.zeros(6, dtype=S.dtype, device=S.device)
    a_grav[5:].fill_(gravity)
    accs = [a_grav + udot[:, :6]]
    for b in range(1, nb):
        j = b - 1
        vj = S[:, 6 + j] * qvel[:, j:j + 1]
        accs.append(accs[model.parent[b]] + S[:, 6 + j] * udot[:, 6 + j:7 + j]
                    + spatial.motion_cross(body_vel[:, b], vj))
    f_sub = [imul(b, accs[b])
             + spatial.force_cross(body_vel[:, b], imul(b, body_vel[:, b]))
             for b in range(nb)]
    tau = S.new_zeros(S.shape[0], nv)
    for b in range(nb - 1, 0, -1):
        tau[:, 6 + b - 1] = _dot(S[:, 6 + b - 1], f_sub[b])
        f_sub[model.parent[b]] = f_sub[model.parent[b]] + f_sub[b]
    tau[:, :6] = f_sub[0]
    return tau


def bias_forces(model: RobotModel, params: PhysicsParams, kin: Kinematics,
                S: torch.Tensor, qvel: torch.Tensor, body_vel: torch.Tensor,
                origin: torch.Tensor, gravity: float = 9.81) -> torch.Tensor:
    """(B, nv) Coriolis, centrifugal and gravity forces (RNEA, u̇ = 0)."""
    zero = S.new_zeros(S.shape[0], model.nv)
    return inverse_dynamics(model, params, kin, S, qvel, body_vel, origin,
                            zero, gravity)


def _applied_generalized_force(model: RobotModel, params: PhysicsParams,
                               state: PhysicsState, joint_torque: torch.Tensor,
                               external_force: Optional[torch.Tensor],
                               external_torque: Optional[torch.Tensor]
                               ) -> torch.Tensor:
    """Actuation, joint dry friction, joint-limit springs and the external
    base push, (B, nv)."""
    B = joint_torque.shape[0]
    tau = joint_torque.new_zeros(B, model.nv)
    jt = joint_torque - params.joint_friction * torch.tanh(state.qvel / 0.05)
    # joint-limit position compliance: the in-solve half of the limit
    # semantics (see the pointer above finish_step)
    k_lim = 200.0
    over = torch.clamp_min(state.qpos - model.q_upper, 0.0)
    under = torch.clamp_min(model.q_lower - state.qpos, 0.0)
    tau[:, 6:] = jt + (-k_lim * over + k_lim * under)
    if external_force is not None:
        # applied at the base origin, which is the spatial origin
        if external_torque is not None:
            tau[:, :3] = tau[:, :3] + external_torque
        tau[:, 3:6] = tau[:, 3:6] + external_force
    return tau


def forward_dynamics(model: RobotModel, params: PhysicsParams,
                     state: PhysicsState, joint_torque: torch.Tensor,
                     height_fn, external_force: Optional[torch.Tensor] = None,
                     external_torque: Optional[torch.Tensor] = None,
                     gravity: float = 9.81):
    """The explicit generalized acceleration u̇ (B, nv) and contact forces
    (B, nc, 3): (M + 1e-6 I) u̇ = τ - b_joint q̇ + Jᵀf - C, with the contact
    forces at the current velocity.  For tests and smooth models; the
    simulator's `step` solves for the velocity implicitly instead (stable
    for stiff contact).  The solve is the plain `linalg.chol_solve`, on
    every device, as in JAX."""
    origin = state.base_pos
    kin = forward_kinematics(model, state, params)
    S = motion_subspaces(model, kin, origin)
    body_vel = body_spatial_velocities(model, state, S)
    M = mass_matrix(model, params, kin, S, origin)
    C = bias_forces(model, params, kin, S, state.qvel, body_vel, origin,
                    gravity)
    tau = _applied_generalized_force(model, params, state, joint_torque,
                                     external_force, external_torque)
    tau[:, 6:] = tau[:, 6:] - model.joint_damping * state.qvel
    f_contact, tau_contact = contact_mod.contact_forces(
        model, params, kin, body_vel, S, origin, height_fn)
    rhs = tau + tau_contact - C
    eye = torch.eye(model.nv, dtype=M.dtype, device=M.device)
    return linalg_ops.chol_solve(M + 1e-6 * eye, rhs), f_contact


def assemble_velocity_solve(model: RobotModel, params: PhysicsParams,
                            state: PhysicsState, joint_torque: torch.Tensor,
                            height_fn, dt: float,
                            external_force: Optional[torch.Tensor] = None,
                            external_torque: Optional[torch.Tensor] = None,
                            gravity: float = 9.81, surface=None):
    """The implicit velocity system (A (B, nv, nv), rhs (B, nv)) and the
    contact terms:
        A   = M + dt·JᵀDJ + dt·diag(b_joint) + 1e-6 I
        rhs = M u + dt·(τ + Jᵀf₀ − C).
    `surface` (heights (B, nc), normals (B, nc, 3)) replaces the terrain
    queries of `height_fn` when given (contact.contact_terms)."""
    origin = state.base_pos
    kin = forward_kinematics(model, state, params)
    S = motion_subspaces(model, kin, origin)
    body_vel = body_spatial_velocities(model, state, S)
    M = mass_matrix(model, params, kin, S, origin)
    C = bias_forces(model, params, kin, S, state.qvel, body_vel, origin,
                    gravity)
    tau = _applied_generalized_force(model, params, state, joint_torque,
                                     external_force, external_torque)
    terms = contact_mod.contact_terms(model, params, kin, body_vel, S, origin,
                                      height_fn, surface)
    Jt_f0 = torch.einsum("bciv,bci->bv", terms.jac, terms.f_spring)
    JtDJ = torch.einsum("bciv,bcij,bcjw->bvw", terms.jac, terms.damp,
                        terms.jac)
    nv = model.nv
    u = torch.cat([state.base_ang_vel, state.base_lin_vel, state.qvel],
                  dim=-1)
    A = M + dt * JtDJ + 1e-6 * torch.eye(nv, dtype=M.dtype, device=M.device)
    idx = torch.arange(6, nv, device=M.device)
    A[:, idx, idx] = A[:, idx, idx] + dt * model.joint_damping
    rhs = (M @ u[..., None])[..., 0] + dt * (tau + Jt_f0 - C)
    return A, rhs, terms


# Joint limits are enforced post-solve, as the JAX package decided from a
# trained-policy A/B: a velocity clip and a hard position stop 0.2 rad past
# the limits here, a stiff one-sided spring over that band in
# _applied_generalized_force.  The measurements and the reasons are the
# note above finish_step in pointfoot_tpu/physics/dynamics.py:342-376.

def finish_step(model: RobotModel, state: PhysicsState, u_new: torch.Tensor,
                terms: contact_mod.ContactTerms, dt: float) -> PhysicsState:
    """Contact sensor forces at the post-step velocity and the position
    update."""
    v_p_new = torch.einsum("bciv,bv->bci", terms.jac, u_new)
    f_c = terms.f_spring - torch.einsum("bcij,bcj->bci", terms.damp, v_p_new)
    f_n = torch.sum(f_c * terms.normal, dim=-1)
    f_t = f_c - f_n[..., None] * terms.normal
    f_c = torch.where(terms.active[..., None],
                      torch.clamp_min(f_n, 0.0)[..., None] * terms.normal
                      + f_t, 0.0)

    ang, lin, qvel = u_new[:, :3], u_new[:, 3:6], u_new[:, 6:]
    # u_new's linear part is the spatial velocity at the old base origin;
    # the stored state holds the material base-point velocity, which adds
    # the velocity-product term ω × v, evaluated at the trapezoidal midpoint
    ang_m = 0.5 * (state.base_ang_vel + ang)
    lin_m = 0.5 * (state.base_lin_vel + lin)
    lin = lin + dt * torch.linalg.cross(ang_m, lin_m, dim=-1)
    # Isaac Gym velocity clamps
    ang = torch.clamp(ang, -64.0, 64.0)
    lin = torch.clamp(lin, -50.0, 50.0)
    qvel = torch.clamp(qvel, -model.velocity_limit, model.velocity_limit)
    pos = state.base_pos + dt * lin
    quat = quat_ops.integrate(state.base_quat, ang, dt)
    qpos = torch.clamp(state.qpos + dt * qvel, model.q_lower - 0.2,
                       model.q_upper + 0.2)
    return PhysicsState(base_pos=pos, base_quat=quat, base_lin_vel=lin,
                        base_ang_vel=ang, qpos=qpos, qvel=qvel,
                        contact_force=f_c)


def step(model: RobotModel, params: PhysicsParams, state: PhysicsState,
         joint_torque: torch.Tensor, height_fn, dt: float,
         external_force: Optional[torch.Tensor] = None,
         external_torque: Optional[torch.Tensor] = None,
         gravity: float = 9.81, surface=None) -> PhysicsState:
    """One physics substep on any device: semi-implicit Euler with implicit
    contact and joint damping,
        (M + dt·JᵀDJ + dt·diag(b_joint)) u⁺ = M u + dt·(τ + Jᵀf_spring − C),
    then positions integrate with u⁺.  With `surface` given it is the plain
    counterpart of the substep kernel on the same surface rows."""
    A, rhs, terms = assemble_velocity_solve(
        model, params, state, joint_torque, height_fn, dt, external_force,
        external_torque, gravity, surface)
    u_new = linalg_ops.chol_solve(A, rhs)
    return finish_step(model, state, u_new, terms, dt)


def step_batched(model: RobotModel, params: PhysicsParams,
                 state: PhysicsState, joint_torque: torch.Tensor, height_fn,
                 dt: float, external_force: Optional[torch.Tensor] = None,
                 gravity: float = 9.81) -> PhysicsState:
    """One substep of a batch, on the route its device and size select
    (module docstring).  `external_force` (B, 3) acts on the base."""
    ext = (external_force if external_force is not None
           else torch.zeros_like(state.base_pos))
    B = state.base_pos.shape[0]
    on_cuda = state.base_pos.device.type == "cuda"
    if B >= MEGA_MIN_BATCH:
        # terrain enters as surface rows gathered at the sphere positions of
        # the same pre-step state, which is what contact_terms would query
        with profiling.span("physics.step_batched"):
            surface = None
            if not getattr(height_fn, "is_flat", False):
                xy = substep_cuda.fk_contact_xy(model, state)
                surface = contact_mod.query_surface(height_fn, xy[..., 0],
                                                    xy[..., 1])
            return substep_cuda.substep(model, params, state, joint_torque,
                                        dt, gravity=gravity,
                                        external_force=ext, surface=surface)
    A, rhs, terms = assemble_velocity_solve(
        model, params, state, joint_torque, height_fn, dt, ext, None,
        gravity)
    if on_cuda and B >= CHOL_MIN_BATCH:
        nv = model.nv
        x_t = chol_cuda.chol_solve_lanes(
            A.reshape(B, nv * nv).t().contiguous(), rhs.t().contiguous())
        u_new = x_t.t()
    else:
        u_new = linalg_ops.chol_solve(A, rhs)
    return finish_step(model, state, u_new, terms, dt)
