"""The fused decimation rollout through its plain versions: a frozen copy
of the plain route of the port's ops/cuda/substep.py (`rollout_substeps_plain`,
`rollout_step_plain`, `fk_rows_plain` and the row layouts they read).

The port's kernels 1 and 2 (`rollout_substep_kernel`,
`fk_from_state_kernel`) are held to these functions; the reference runs
them on any device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from benchmark.reference import rowdyn
from benchmark.reference.contact import query_surface
from benchmark.reference.model import PhysicsParams, PhysicsState

def state_layout(nj: int):
    return [("base_pos", 3), ("base_quat", 4), ("base_lin_vel", 3),
            ("base_ang_vel", 3), ("qpos", nj), ("qvel", nj),
            ("last_qvel", nj)]


def ctrl_layout(nj: int, nc: int):
    return [("actions", nj), ("kp", nj), ("kd", nj), ("friction", nc),
            ("joint_friction", nj), ("added_mass", 1), ("com_offset", 3),
            ("k_contact", 1), ("d_contact", 1), ("push", 3)]


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


_GRAPHS = {}


def rollout_step_replayed(mc: rowdyn.ModelConsts, state_rows: torch.Tensor,
                          ctrl_rows: torch.Tensor,
                          surf_rows: Optional[torch.Tensor], with_push: bool,
                          default_qpos: Sequence[float], action_scale: float,
                          control_type: str, sim_dt: float, gravity: float):
    """`rollout_step_plain` on CUDA rows, captured once per argument set
    as a CUDA graph and replayed: the same kernels in the same order on
    the same inputs, so the same results, without the host dispatching
    each of the plain version's thousands of operations again.  CPU rows
    run the plain version itself."""
    if state_rows.device.type != "cuda":
        return rollout_step_plain(mc, state_rows, ctrl_rows, surf_rows,
                                  with_push, default_qpos, action_scale,
                                  control_type, sim_dt, gravity)
    key = (id(mc), state_rows.shape, ctrl_rows.shape,
           None if surf_rows is None else surf_rows.shape, with_push,
           tuple(default_qpos), action_scale, control_type, sim_dt, gravity,
           state_rows.device)
    hit = _GRAPHS.get(key)
    if hit is None or hit[0] is not mc:
        if any(h[0] is not mc for h in _GRAPHS.values()):
            _GRAPHS.clear()  # another model's (an earlier env's) graphs
        ins = [state_rows.clone(), ctrl_rows.clone(),
               None if surf_rows is None else surf_rows.clone()]

        def step():
            return rollout_step_plain(mc, ins[0], ins[1], ins[2], with_push,
                                      default_qpos, action_scale,
                                      control_type, sim_dt, gravity)
        side = torch.cuda.Stream(state_rows.device)
        side.wait_stream(torch.cuda.current_stream(state_rows.device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(state_rows.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = step()
        hit = (mc, graph, ins, outs)
        _GRAPHS[key] = hit
    _, graph, ins, outs = hit
    ins[0].copy_(state_rows)
    ins[1].copy_(ctrl_rows)
    if surf_rows is not None:
        ins[2].copy_(surf_rows)
    graph.replay()
    return outs[0].clone(), outs[1].clone()


def rollout_substeps_plain(model, params: PhysicsParams, phys: PhysicsState,
                           actions: torch.Tensor, last_qvel: torch.Tensor,
                           push: torch.Tensor, height_fn, sim_dt: float,
                           n_sub: int, default_qpos: Sequence[float],
                           action_scale: float, control_type: str,
                           gravity: float = 9.81):
    """`rollout_substeps` through the plain versions on any device (each
    substep replayed from its CUDA graph on the card)."""
    return _rollout(rollout_step_replayed, fk_rows_plain, model, params,
                    phys, actions, last_qvel, push, height_fn, sim_dt, n_sub,
                    default_qpos, action_scale, control_type, gravity)


