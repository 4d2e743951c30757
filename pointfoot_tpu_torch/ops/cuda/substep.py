"""Fused decimation rollout (pointfoot_tpu/ops/pallas/substep.py).

One kernel launch per physics substep, with the PD torque and the FK of the
output inside it, and the state kept as rows × envs ((R, B) float32,
contiguous) across the loop.  Between substeps only the terrain surface
query runs, in plain PyTorch.  On non-flat terrain one FK launch seeds the
first surface query.

Two wrappers launch the kernels of csrc/substep.cu for CUDA tensors:
`rollout_step` (one substep) and `fk_rows` (collision-sphere positions).
For CPU tensors they run their plain versions, `rollout_step_plain` and
`fk_rows_plain`, built on physics/rowdyn.py.  Each wrapper counts its
launches in `.launches`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.physics import rowdyn
from pointfoot_tpu_torch.physics.contact import query_surface
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState

CONTROL_TYPES = ("P", "V", "T")


def state_layout(nj: int):
    return [("base_pos", 3), ("base_quat", 4), ("base_lin_vel", 3),
            ("base_ang_vel", 3), ("qpos", nj), ("qvel", nj),
            ("last_qvel", nj)]


def ctrl_layout(nj: int, nc: int):
    return [("actions", nj), ("kp", nj), ("kd", nj), ("friction", nc),
            ("joint_friction", nj), ("added_mass", 1), ("com_offset", 3),
            ("k_contact", 1), ("d_contact", 1), ("push", 3)]


def _rows(layout) -> int:
    return sum(c for _, c in layout)


_MC_CACHE = {}


def model_consts(model) -> rowdyn.ModelConsts:
    """ModelConsts of `model`, built once per model object."""
    hit = _MC_CACHE.get(id(model))
    if hit is None or hit[0] is not model:
        hit = (model, rowdyn.ModelConsts(model))
        _MC_CACHE[id(model)] = hit
    return hit[1]


def _read(rows: torch.Tensor, layout):
    idx, out = 0, {}
    for name, cnt in layout:
        out[name] = [rows[idx + i] for i in range(cnt)]
        idx += cnt
    return out


def _stack(vals, like: torch.Tensor) -> torch.Tensor:
    """(len(vals), B) from rows; folded constants broadcast to a row."""
    return torch.stack([
        v if isinstance(v, torch.Tensor) else torch.full_like(like, v)
        for v in vals])


# ------------------------------------------------------------ plain versions

def rollout_step_plain(mc: rowdyn.ModelConsts, state_rows: torch.Tensor,
                       ctrl_rows: torch.Tensor,
                       surf_rows: Optional[torch.Tensor], with_push: bool,
                       default_qpos: Sequence[float], action_scale: float,
                       control_type: str, sim_dt: float, gravity: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One substep on rows: (state rows, extra rows = tau, contact force,
    sphere xyz of the new state)."""
    nj, nc = mc.nj, mc.nc
    sv = _read(state_rows, state_layout(nj))
    cv = _read(ctrl_rows, ctrl_layout(nj, nc))
    st = {
        "base_pos": sv["base_pos"], "base_quat": sv["base_quat"],
        "base_lin_vel": sv["base_lin_vel"],
        "base_ang_vel": sv["base_ang_vel"],
        "qpos": sv["qpos"], "qvel": sv["qvel"],
        "last_qvel": sv["last_qvel"],
        "actions": cv["actions"], "kp": cv["kp"], "kd": cv["kd"],
        "friction": cv["friction"], "joint_friction": cv["joint_friction"],
        "added_mass": cv["added_mass"][0], "com_offset": cv["com_offset"],
        "k_contact": cv["k_contact"][0], "d_contact": cv["d_contact"][0],
        # the queued push acts on substep 0 only
        "ext_force": cv["push"] if with_push else [0.0, 0.0, 0.0],
    }
    st["tau"] = rowdyn.pd_torque_rows(mc, st, default_qpos, action_scale,
                                      control_type, sim_dt)
    surface = None
    if surf_rows is not None:
        surface = [(surf_rows[c], [surf_rows[nc + 3 * c + i]
                                   for i in range(3)]) for c in range(nc)]
    out = rowdyn.substep_rows(mc, st, sim_dt, gravity, surface=surface)
    xyz = rowdyn.fk_contact_pos(mc, {
        "base_pos": out["base_pos"], "base_quat": out["base_quat"],
        "qpos": out["qpos"]})
    like = state_rows[0]
    new_state = _stack(
        out["base_pos"] + out["base_quat"] + out["base_lin_vel"]
        + out["base_ang_vel"] + out["qpos"] + out["qvel"]
        + sv["qvel"],  # next substep's last_qvel
        like)
    extra = _stack(
        st["tau"] + [f for fc in out["contact_force"] for f in fc]
        + [v for p in xyz for v in p], like)
    return new_state, extra


def fk_rows_plain(mc: rowdyn.ModelConsts, state_rows: torch.Tensor
                  ) -> torch.Tensor:
    """(3·nc, B) world xyz of every collision sphere from state rows."""
    sv = _read(state_rows, state_layout(mc.nj))
    xyz = rowdyn.fk_contact_pos(mc, {
        "base_pos": sv["base_pos"], "base_quat": sv["base_quat"],
        "qpos": sv["qpos"]})
    return _stack([v for p in xyz for v in p], state_rows[0])


# ------------------------------------------------------- kernel wrappers

def _check_rows(name: str, t: torch.Tensor, rows: int, B: int,
                device: torch.device):
    if t.device != device or t.dtype != torch.float32 or \
            t.shape != (rows, B) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous float32 ({rows}, {B}) on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _launched(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def rollout_step(mc: rowdyn.ModelConsts, state_rows: torch.Tensor,
                 ctrl_rows: torch.Tensor, surf_rows: Optional[torch.Tensor],
                 with_push: bool, default_qpos: Sequence[float],
                 action_scale: float, control_type: str, sim_dt: float,
                 gravity: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One substep: the CUDA kernel for CUDA rows, the plain version for CPU
    rows.  Same arguments and results as `rollout_step_plain`."""
    args = (mc, state_rows, ctrl_rows, surf_rows, with_push, default_qpos,
            action_scale, control_type, sim_dt, gravity)
    dev = state_rows.device
    if dev.type == "cpu":
        return rollout_step_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"rollout_step: unsupported device {dev}")
    lib = build.load(mc)
    nj, nc = mc.nj, mc.nc
    B = state_rows.shape[1]
    R_state, R_ctrl = _rows(state_layout(nj)), _rows(ctrl_layout(nj, nc))
    R_extra = nj + 6 * nc
    if lib.layout != (nj, nc, R_state, R_ctrl, 4 * nc, R_extra):
        raise RuntimeError(f"kernel layout {lib.layout} does not match the "
                           f"model (nj={nj}, nc={nc})")
    _check_rows("state_rows", state_rows, R_state, B, dev)
    _check_rows("ctrl_rows", ctrl_rows, R_ctrl, B, dev)
    if surf_rows is not None:
        _check_rows("surf_rows", surf_rows, 4 * nc, B, dev)
    out_state = torch.empty_like(state_rows)
    out_extra = torch.empty((R_extra, B), dtype=torch.float32, device=dev)
    err = lib.lib.pf_rollout_substep(
        state_rows.data_ptr(), ctrl_rows.data_ptr(),
        None if surf_rows is None else surf_rows.data_ptr(),
        out_state.data_ptr(), out_extra.data_ptr(), B, int(with_push),
        CONTROL_TYPES.index(control_type), lib.JointVec(default_qpos),
        float(action_scale), float(sim_dt), float(gravity), _stream(dev))
    _launched(err, "rollout_substep_kernel")
    rollout_step.launches += 1
    return out_state, out_extra


rollout_step.launches = 0


def fk_rows(mc: rowdyn.ModelConsts, state_rows: torch.Tensor
            ) -> torch.Tensor:
    """Collision-sphere xyz rows: the CUDA kernel for CUDA rows, the plain
    version for CPU rows."""
    dev = state_rows.device
    if dev.type == "cpu":
        return fk_rows_plain(mc, state_rows)
    if dev.type != "cuda":
        raise ValueError(f"fk_rows: unsupported device {dev}")
    lib = build.load(mc)
    B = state_rows.shape[1]
    _check_rows("state_rows", state_rows, _rows(state_layout(mc.nj)), B, dev)
    out = torch.empty((3 * mc.nc, B), dtype=torch.float32, device=dev)
    err = lib.lib.pf_fk_from_state(state_rows.data_ptr(), out.data_ptr(), B,
                                   _stream(dev))
    _launched(err, "fk_from_state_kernel")
    fk_rows.launches += 1
    return out


fk_rows.launches = 0


def reset_launch_counts():
    rollout_step.launches = 0
    fk_rows.launches = 0


# ------------------------------------------------------------- public API

def _pack(cols) -> torch.Tensor:
    """(B, ...) columns -> contiguous (R, B) float32 rows."""
    x = torch.cat([c.reshape(c.shape[0], -1).to(torch.float32)
                   for c in cols], dim=-1)
    return x.t().contiguous()


def pack_state(phys: PhysicsState, last_qvel: torch.Tensor) -> torch.Tensor:
    """State rows in `state_layout` order."""
    return _pack([phys.base_pos, phys.base_quat, phys.base_lin_vel,
                  phys.base_ang_vel, phys.qpos, phys.qvel, last_qvel])


def pack_ctrl(actions: torch.Tensor, params: PhysicsParams,
              push: torch.Tensor) -> torch.Tensor:
    """Control rows in `ctrl_layout` order."""
    return _pack([actions, params.kp, params.kd, params.friction,
                  params.joint_friction, params.added_mass[:, None],
                  params.com_offset, params.contact_stiffness[:, None],
                  params.contact_damping[:, None], push])


def surface_rows(height_fn, xyz_rows: torch.Tensor, nc: int) -> torch.Tensor:
    """Surface rows (nc heights, then 3·nc normal components) under the
    spheres whose xyz rows are given."""
    x = xyz_rows.view(nc, 3, -1)
    h, n = query_surface(height_fn, x[:, 0], x[:, 1])
    return torch.cat([h, n.permute(0, 2, 1).reshape(3 * nc, -1)],
                     dim=0).contiguous()


def fk_from_state(model, phys: PhysicsState) -> torch.Tensor:
    """(B, nc, 3) world xyz of every collision sphere."""
    mc = model_consts(model)
    xyz = fk_rows(mc, pack_state(phys, phys.qvel))
    return xyz.t().reshape(-1, mc.nc, 3)


def _rollout(step_fn, fk_fn, model, params: PhysicsParams,
             phys: PhysicsState, actions, last_qvel, push, height_fn,
             sim_dt: float, n_sub: int, default_qpos: Sequence[float],
             action_scale: float, control_type: str, gravity: float):
    mc = model_consts(model)
    nj, nc = mc.nj, mc.nc
    B = phys.base_pos.shape[0]
    flat = getattr(height_fn, "is_flat", False)
    dq = tuple(float(v) for v in default_qpos)
    state_rows = pack_state(phys, last_qvel)
    ctrl_rows = pack_ctrl(actions, params, push)
    xyz = None if flat else fk_fn(mc, state_rows)
    extra = None
    for i in range(n_sub):
        surf_rows = None if flat else surface_rows(height_fn, xyz, nc)
        state_rows, extra = step_fn(
            mc, state_rows, ctrl_rows, surf_rows, i == 0, dq, action_scale,
            control_type, sim_dt, gravity)
        xyz = extra[nj + 3 * nc:]

    s = state_rows.t()
    e = extra.t()
    o, off = 0, {}
    for name, cnt in state_layout(nj):
        off[name] = s[:, o:o + cnt]
        o += cnt
    new_phys = PhysicsState(
        base_pos=off["base_pos"], base_quat=off["base_quat"],
        base_lin_vel=off["base_lin_vel"], base_ang_vel=off["base_ang_vel"],
        qpos=off["qpos"], qvel=off["qvel"],
        contact_force=e[:, nj:nj + 3 * nc].reshape(B, nc, 3),
    )
    return new_phys, e[:, :nj], e[:, nj + 3 * nc:].reshape(B, nc, 3)


def rollout_substeps(model, params: PhysicsParams, phys: PhysicsState,
                     actions: torch.Tensor, last_qvel: torch.Tensor,
                     push: torch.Tensor, height_fn, sim_dt: float,
                     n_sub: int, default_qpos: Sequence[float],
                     action_scale: float, control_type: str,
                     gravity: float = 9.81):
    """The decimation loop: `n_sub` substeps, PD torque recomputed in each,
    `push` (B, 3) applied on substep 0 only.  `height_fn` is flat when it
    has `is_flat` set; otherwise its surface is queried at the spheres'
    positions before every substep.  `default_qpos` holds nj floats.

    Returns (PhysicsState, last torque (B, nj), sphere_pos (B, nc, 3)),
    sphere_pos being the FK of the final state.
    """
    return _rollout(rollout_step, fk_rows, model, params, phys, actions,
                    last_qvel, push, height_fn, sim_dt, n_sub, default_qpos,
                    action_scale, control_type, gravity)


def rollout_substeps_plain(model, params: PhysicsParams, phys: PhysicsState,
                           actions: torch.Tensor, last_qvel: torch.Tensor,
                           push: torch.Tensor, height_fn, sim_dt: float,
                           n_sub: int, default_qpos: Sequence[float],
                           action_scale: float, control_type: str,
                           gravity: float = 9.81):
    """`rollout_substeps` through the plain versions on any device."""
    return _rollout(rollout_step_plain, fk_rows_plain, model, params, phys,
                    actions, last_qvel, push, height_fn, sim_dt, n_sub,
                    default_qpos, action_scale, control_type, gravity)
