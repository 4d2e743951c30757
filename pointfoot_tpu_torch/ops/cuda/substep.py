"""Physics substep kernels (pointfoot_tpu/ops/pallas/substep.py).

Two routes, each with the state kept as rows × envs ((R, B) float32,
contiguous) inside:

- the fused decimation rollout, `rollout_substeps`: one kernel launch per
  physics substep, with the PD torque and the FK of the output inside it.
  Between substeps only the terrain surface query runs, in plain PyTorch.
  On non-flat terrain one FK launch seeds the first surface query.  A
  rank of a data-parallel run calls it on its own rows, where JAX wraps
  the kernels in `shard_map` (pointfoot_tpu/ops/pallas/substep.py:449);
  the physics is env-parallel, so nothing crosses ranks;
- one substep with the torque, push and surface as inputs, `substep`, and
  the sphere-xy FK that feeds its surface query, `fk_contact_xy`: the
  mega-kernel route of physics/dynamics.step_batched.

The two substep kernels give each env a group of four lanes and a slab of
shared memory for its working set (csrc/rowdyn.cuh, substep_group), eight
envs a one-warp block; the two sphere FK kernels (xy from the FK rows, xyz
from the state rows) share one walk that gives an env one thread a leg, a
warp a leg of 32 envs.

Four wrappers launch the kernels of csrc/substep.cu for CUDA tensors:
`rollout_step` (one rollout substep), `fk_rows` (collision-sphere xyz),
`step_rows` (one substep) and `fk_xy_rows` (collision-sphere xy).  For CPU
tensors they run their plain versions (`..._plain`), built on
physics/rowdyn.py.  Each wrapper counts its launches in the counter
`kernel.<kernel>` of utils/profiling.py (`kernel.rollout_substep`,
`kernel.fk_from_state`, `kernel.substep`, `kernel.fk_contact_xy`).  The
kernels have no backward pass: a wrapper raises for CUDA inputs that
require grad while grad mode is on (`_grad.refuse_grad`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda._grad import refuse_grad
from pointfoot_tpu_torch.physics import rowdyn
from pointfoot_tpu_torch.physics.contact import query_surface
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.utils import profiling

CONTROL_TYPES = ("P", "V", "T")


def state_layout(nj: int):
    return [("base_pos", 3), ("base_quat", 4), ("base_lin_vel", 3),
            ("base_ang_vel", 3), ("qpos", nj), ("qvel", nj),
            ("last_qvel", nj)]


def ctrl_layout(nj: int, nc: int):
    return [("actions", nj), ("kp", nj), ("kd", nj), ("friction", nc),
            ("joint_friction", nj), ("added_mass", 1), ("com_offset", 3),
            ("k_contact", 1), ("d_contact", 1), ("push", 3)]


def substep_in_layout(nj: int, nc: int):
    """Input rows of `step_rows` (the surface rows come separately)."""
    return [("base_pos", 3), ("base_quat", 4), ("base_lin_vel", 3),
            ("base_ang_vel", 3), ("qpos", nj), ("qvel", nj), ("tau", nj),
            ("ext_force", 3), ("friction", nc), ("joint_friction", nj),
            ("added_mass", 1), ("com_offset", 3), ("k_contact", 1),
            ("d_contact", 1)]


def substep_out_layout(nj: int, nc: int):
    return [("base_pos", 3), ("base_quat", 4), ("base_lin_vel", 3),
            ("base_ang_vel", 3), ("qpos", nj), ("qvel", nj),
            ("contact_force", 3 * nc)]


def fk_in_layout(nj: int):
    """Input rows of `fk_xy_rows`."""
    return [("base_pos", 3), ("base_quat", 4), ("qpos", nj)]


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


def step_rows_plain(mc: rowdyn.ModelConsts, in_rows: torch.Tensor,
                    surf_rows: Optional[torch.Tensor], dt: float,
                    gravity: float) -> torch.Tensor:
    """One substep on rows: `substep_in_layout` rows and optional surface
    rows (nc heights, then 3·nc normal components) in,
    `substep_out_layout` rows out."""
    nj, nc = mc.nj, mc.nc
    st = _read(in_rows, substep_in_layout(nj, nc))
    for name in ("added_mass", "k_contact", "d_contact"):
        st[name] = st[name][0]
    surface = None
    if surf_rows is not None:
        surface = [(surf_rows[c], [surf_rows[nc + 3 * c + i]
                                   for i in range(3)]) for c in range(nc)]
    out = rowdyn.substep_rows(mc, st, dt, gravity, surface=surface)
    return _stack(
        out["base_pos"] + out["base_quat"] + out["base_lin_vel"]
        + out["base_ang_vel"] + out["qpos"] + out["qvel"]
        + [f for fc in out["contact_force"] for f in fc], in_rows[0])


def fk_xy_rows_plain(mc: rowdyn.ModelConsts, rows: torch.Tensor
                     ) -> torch.Tensor:
    """(2·nc, B) world xy of every collision sphere from `fk_in_layout`
    rows."""
    xy = rowdyn.fk_contact_xy(mc, _read(rows, fk_in_layout(mc.nj)))
    return _stack([v for p in xy for v in p], rows[0])


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


def _device(name: str, t: torch.Tensor) -> torch.device:
    """The device of a wrapper's input: cpu (plain version) or cuda."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _library(mc: rowdyn.ModelConsts) -> build.KernelLibrary:
    """The kernels built for mc, checked against this module's layouts."""
    lib = build.load(mc)
    nj, nc = mc.nj, mc.nc
    want = (nj, nc, _rows(state_layout(nj)), _rows(ctrl_layout(nj, nc)),
            4 * nc, nj + 6 * nc, _rows(substep_in_layout(nj, nc)),
            _rows(substep_out_layout(nj, nc)), _rows(fk_in_layout(nj)))
    if lib.layout != want:
        raise RuntimeError(f"kernel layout {lib.layout} does not match the "
                           f"model's {want}")
    return lib


def rollout_step(mc: rowdyn.ModelConsts, state_rows: torch.Tensor,
                 ctrl_rows: torch.Tensor, surf_rows: Optional[torch.Tensor],
                 with_push: bool, default_qpos: Sequence[float],
                 action_scale: float, control_type: str, sim_dt: float,
                 gravity: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One substep: the CUDA kernel for CUDA rows, the plain version for CPU
    rows.  Same arguments and results as `rollout_step_plain`."""
    args = (mc, state_rows, ctrl_rows, surf_rows, with_push, default_qpos,
            action_scale, control_type, sim_dt, gravity)
    dev = _device("rollout_step", state_rows)
    if dev.type == "cpu":
        return rollout_step_plain(*args)
    refuse_grad("rollout_substep_kernel", "rollout_step_plain", state_rows,
                ctrl_rows, surf_rows)
    lib = _library(mc)
    nj, nc = mc.nj, mc.nc
    B = state_rows.shape[1]
    R_state, R_ctrl = _rows(state_layout(nj)), _rows(ctrl_layout(nj, nc))
    R_extra = nj + 6 * nc
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
    profiling.count("kernel.rollout_substep")
    return out_state, out_extra


def fk_rows(mc: rowdyn.ModelConsts, state_rows: torch.Tensor
            ) -> torch.Tensor:
    """Collision-sphere xyz rows: the CUDA kernel for CUDA rows, the plain
    version for CPU rows."""
    dev = _device("fk_rows", state_rows)
    if dev.type == "cpu":
        return fk_rows_plain(mc, state_rows)
    refuse_grad("fk_from_state_kernel", "fk_rows_plain", state_rows)
    lib = _library(mc)
    B = state_rows.shape[1]
    _check_rows("state_rows", state_rows, _rows(state_layout(mc.nj)), B, dev)
    out = torch.empty((3 * mc.nc, B), dtype=torch.float32, device=dev)
    err = lib.lib.pf_fk_from_state(state_rows.data_ptr(), out.data_ptr(), B,
                                   _stream(dev))
    _launched(err, "fk_from_state_kernel")
    profiling.count("kernel.fk_from_state")
    return out


def step_rows(mc: rowdyn.ModelConsts, in_rows: torch.Tensor,
              surf_rows: Optional[torch.Tensor], dt: float,
              gravity: float) -> torch.Tensor:
    """One substep on rows: the CUDA kernel for CUDA rows, the plain
    version for CPU rows.  Same arguments and result as `step_rows_plain`;
    without surface rows the ground is flat at z = 0."""
    dev = _device("step_rows", in_rows)
    if dev.type == "cpu":
        return step_rows_plain(mc, in_rows, surf_rows, dt, gravity)
    refuse_grad("substep_kernel", "step_rows_plain", in_rows, surf_rows)
    lib = _library(mc)
    nj, nc = mc.nj, mc.nc
    B = in_rows.shape[1]
    _check_rows("in_rows", in_rows, _rows(substep_in_layout(nj, nc)), B, dev)
    if surf_rows is not None:
        _check_rows("surf_rows", surf_rows, 4 * nc, B, dev)
    out = torch.empty((_rows(substep_out_layout(nj, nc)), B),
                      dtype=torch.float32, device=dev)
    err = lib.lib.pf_substep(
        in_rows.data_ptr(),
        None if surf_rows is None else surf_rows.data_ptr(),
        out.data_ptr(), B, float(dt), float(gravity), _stream(dev))
    _launched(err, "substep_kernel")
    profiling.count("kernel.substep")
    return out


def fk_xy_rows(mc: rowdyn.ModelConsts, rows: torch.Tensor) -> torch.Tensor:
    """Collision-sphere xy rows: the CUDA kernel for CUDA rows, the plain
    version for CPU rows."""
    dev = _device("fk_xy_rows", rows)
    if dev.type == "cpu":
        return fk_xy_rows_plain(mc, rows)
    refuse_grad("fk_contact_xy_kernel", "fk_xy_rows_plain", rows)
    lib = _library(mc)
    B = rows.shape[1]
    _check_rows("rows", rows, _rows(fk_in_layout(mc.nj)), B, dev)
    out = torch.empty((2 * mc.nc, B), dtype=torch.float32, device=dev)
    err = lib.lib.pf_fk_contact_xy(rows.data_ptr(), out.data_ptr(), B,
                                   _stream(dev))
    _launched(err, "fk_contact_xy_kernel")
    profiling.count("kernel.fk_contact_xy")
    return out



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


def _unpack(rows: torch.Tensor, layout) -> dict:
    """(R, B) rows -> {name: (B, count)} columns."""
    cols, o = {}, 0
    t = rows.t()
    for name, cnt in layout:
        cols[name] = t[:, o:o + cnt]
        o += cnt
    return cols


def pack_substep_in(state: PhysicsState, params: PhysicsParams,
                    joint_torque: torch.Tensor,
                    external_force: torch.Tensor) -> torch.Tensor:
    """Input rows of `step_rows`, in `substep_in_layout` order."""
    return _pack([
        state.base_pos, state.base_quat, state.base_lin_vel,
        state.base_ang_vel, state.qpos, state.qvel, joint_torque,
        external_force, params.friction, params.joint_friction,
        params.added_mass[:, None], params.com_offset,
        params.contact_stiffness[:, None], params.contact_damping[:, None]])


def pack_surface(surface: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Surface rows from (heights (B, nc), normals (B, nc, 3))."""
    h, n = surface
    return _pack([h, n.reshape(h.shape[0], -1)])


def pack_fk_in(state: PhysicsState) -> torch.Tensor:
    """Input rows of `fk_xy_rows`, in `fk_in_layout` order."""
    return _pack([state.base_pos, state.base_quat, state.qpos])


def _substep(step_fn, model, params: PhysicsParams, state: PhysicsState,
             joint_torque, dt, gravity, external_force, surface):
    mc = model_consts(model)
    nj, nc = mc.nj, mc.nc
    B = state.base_pos.shape[0]
    ext = (external_force if external_force is not None
           else torch.zeros_like(state.base_pos))
    in_rows = pack_substep_in(state, params, joint_torque, ext)
    surf_rows = None if surface is None else pack_surface(surface)
    out = _unpack(step_fn(mc, in_rows, surf_rows, dt, gravity),
                  substep_out_layout(nj, nc))
    return PhysicsState(
        base_pos=out["base_pos"], base_quat=out["base_quat"],
        base_lin_vel=out["base_lin_vel"], base_ang_vel=out["base_ang_vel"],
        qpos=out["qpos"], qvel=out["qvel"],
        contact_force=out["contact_force"].reshape(B, nc, 3))


def substep(model, params: PhysicsParams, state: PhysicsState,
            joint_torque: torch.Tensor, dt: float, gravity: float = 9.81,
            external_force: Optional[torch.Tensor] = None,
            surface: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> PhysicsState:
    """One batched substep through the substep kernel (`step_rows`).

    `joint_torque` (B, nj) and `external_force` (B, 3, on the base) apply
    as given; `surface` is None (flat ground at z = 0) or (heights (B, nc),
    unit normals (B, nc, 3)) under each collision sphere.
    """
    return _substep(step_rows, model, params, state, joint_torque, dt,
                    gravity, external_force, surface)


def substep_plain(model, params: PhysicsParams, state: PhysicsState,
                  joint_torque: torch.Tensor, dt: float,
                  gravity: float = 9.81,
                  external_force: Optional[torch.Tensor] = None,
                  surface: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> PhysicsState:
    """`substep` through the plain version on any device."""
    return _substep(step_rows_plain, model, params, state, joint_torque, dt,
                    gravity, external_force, surface)


def _fk_xy(fn, model, state: PhysicsState) -> torch.Tensor:
    mc = model_consts(model)
    return fn(mc, pack_fk_in(state)).t().reshape(-1, mc.nc, 2)


def fk_contact_xy(model, state: PhysicsState) -> torch.Tensor:
    """(B, nc, 2) world xy of every collision sphere, the terrain-query
    positions of `substep`'s surface, through the FK-xy kernel."""
    return _fk_xy(fk_xy_rows, model, state)


def fk_contact_xy_plain(model, state: PhysicsState) -> torch.Tensor:
    """`fk_contact_xy` through the plain version on any device."""
    return _fk_xy(fk_xy_rows_plain, model, state)
