"""One substep of the scan path through its plain versions: a frozen copy
of the plain route of the port's ops/cuda/substep.py for `step_rows_plain`
and `fk_xy_rows_plain`, the plain twins of kernels 3 (`substep_kernel`)
and 4 (`fk_contact_xy_kernel`), with the row layouts they read, and of the
mega-kernel route of the port's physics/dynamics.py::step_batched that
chains them: the sphere-xy FK of the pre-step state, the terrain surface
query at those points, then the substep with the torque, push and surface
as inputs.  Built on the frozen rowdyn.py; runs on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference import rowdyn
from benchmark.reference.contact import query_surface
from benchmark.reference.model import PhysicsParams, PhysicsState
from benchmark.reference.substep import _pack, _read, _stack, model_consts


def substep_in_layout(nj: int, nc: int):
    """Input rows of `step_rows_plain` (the surface rows come
    separately)."""
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
    """Input rows of `fk_xy_rows_plain`."""
    return [("base_pos", 3), ("base_quat", 4), ("qpos", nj)]


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
    """Input rows of `step_rows_plain`, in `substep_in_layout` order."""
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
    """Input rows of `fk_xy_rows_plain`, in `fk_in_layout` order."""
    return _pack([state.base_pos, state.base_quat, state.qpos])


def substep_plain(model, params: PhysicsParams, state: PhysicsState,
                  joint_torque: torch.Tensor, dt: float, gravity: float,
                  external_force: torch.Tensor,
                  surface: Optional[Tuple[torch.Tensor, torch.Tensor]]
                  ) -> PhysicsState:
    """One batched substep through `step_rows_plain`: `surface` is None
    (flat ground at z = 0) or (heights (B, nc), unit normals (B, nc, 3))
    under each collision sphere."""
    mc = model_consts(model)
    nj, nc = mc.nj, mc.nc
    B = state.base_pos.shape[0]
    in_rows = pack_substep_in(state, params, joint_torque, external_force)
    surf_rows = None if surface is None else pack_surface(surface)
    out = _unpack(step_rows_plain(mc, in_rows, surf_rows, dt, gravity),
                  substep_out_layout(nj, nc))
    return PhysicsState(
        base_pos=out["base_pos"], base_quat=out["base_quat"],
        base_lin_vel=out["base_lin_vel"], base_ang_vel=out["base_ang_vel"],
        qpos=out["qpos"], qvel=out["qvel"],
        contact_force=out["contact_force"].reshape(B, nc, 3))


def fk_contact_xy_plain(model, state: PhysicsState) -> torch.Tensor:
    """(B, nc, 2) world xy of every collision sphere, the terrain-query
    positions of the substep's surface."""
    mc = model_consts(model)
    return fk_xy_rows_plain(mc, pack_fk_in(state)).t().reshape(-1, mc.nc, 2)


def step_batched_plain(model, params: PhysicsParams, state: PhysicsState,
                       joint_torque: torch.Tensor, height_fn, dt: float,
                       external_force: Optional[torch.Tensor] = None,
                       gravity: float = 9.81) -> PhysicsState:
    """The mega-kernel route of `step_batched` through the plain twins:
    terrain enters as surface rows gathered at the sphere positions of the
    pre-step state; on flat ground (`height_fn.is_flat`) there is none."""
    ext = (external_force if external_force is not None
           else torch.zeros_like(state.base_pos))
    surface = None
    if not getattr(height_fn, "is_flat", False):
        xy = fk_contact_xy_plain(model, state)
        surface = query_surface(height_fn, xy[..., 0], xy[..., 1])
    return substep_plain(model, params, state, joint_torque, dt, gravity,
                         ext, surface)
