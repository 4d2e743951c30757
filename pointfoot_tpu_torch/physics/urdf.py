"""URDF -> RobotModel compiler (pointfoot_tpu/physics/urdf.py).

Offline replacement for Isaac Gym's `gym.load_asset` +
`collapse_fixed_joints`: parses the URDF kinematic tree, merges welded
(fixed-joint) links into their nearest movable ancestor with
parallel-axis inertia composition, and approximates every collision
geometry with a sphere (exact for URDF spheres, the PointFoot feet;
bounding for box and cylinder, which serve only fall and
penalized-contact detection).  numpy in float64 up to the final
RobotModel, whose arrays are float32 CPU tensors as physics/assets.py
builds them.

Welded links keep their identity as named collision sites, so
`foot_name`-based indexing still works on a welded foot link.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pointfoot_tpu_torch.physics.model import RobotModel

_MOVABLE = ("revolute", "continuous", "prismatic")


def _vec(s: Optional[str], default="0 0 0") -> np.ndarray:
    return np.array([float(x) for x in (s or default).split()], dtype=np.float64)


def _rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> xyzw quaternion (robust Shepperd)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


@dataclass
class _Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    collisions: List[Tuple[np.ndarray, float]] = field(default_factory=list)  # (offset, radius)


@dataclass
class _Joint:
    name: str
    jtype: str
    parent: str
    child: str
    origin_pos: np.ndarray
    origin_rot: np.ndarray  # 3x3
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0
    damping: float = 0.0
    friction: float = 0.0


def _parse_inertial(link_el) -> Tuple[float, np.ndarray, np.ndarray]:
    inertial = link_el.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(inertial.find("mass").get("value"))
    origin = inertial.find("origin")
    com = _vec(origin.get("xyz") if origin is not None else None)
    rot = _rpy_to_mat(_vec(origin.get("rpy") if origin is not None else None))
    ine = inertial.find("inertia")
    g = lambda k: float(ine.get(k, 0.0))
    I = np.array(
        [[g("ixx"), g("ixy"), g("ixz")],
         [g("ixy"), g("iyy"), g("iyz")],
         [g("ixz"), g("iyz"), g("izz")]]
    )
    # inertia given in the inertial frame -> rotate into link frame
    return mass, com, rot @ I @ rot.T


def _parse_collisions(link_el) -> List[Tuple[np.ndarray, float]]:
    out = []
    for col in link_el.findall("collision"):
        origin = col.find("origin")
        off = _vec(origin.get("xyz") if origin is not None else None)
        geom = col.find("geometry")
        if geom is None:
            continue
        for g in geom:
            if g.tag == "sphere":
                out.append((off, float(g.get("radius"))))
            elif g.tag == "cylinder":
                out.append((off, float(g.get("radius"))))
            elif g.tag == "box":
                size = _vec(g.get("size"), "0.1 0.1 0.1")
                out.append((off, float(min(size)) / 2.0))
            else:  # mesh etc. — coarse probe point
                out.append((off, 0.02))
    return out


def _merge_inertia(
    m1, c1, I1, m2, c2, I2
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Weld two bodies expressed in the same frame (parallel-axis theorem)."""
    m = m1 + m2
    if m <= 0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    c = (m1 * c1 + m2 * c2) / m

    def shift(mi, ci, Ii):
        d = ci - c
        return Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, c, shift(m1, c1, I1) + shift(m2, c2, I2)


def load_urdf(path: str) -> Tuple[RobotModel, Dict[str, int]]:
    """Compile a URDF file into a RobotModel.

    Returns (model, joint_name->index map).  Kinematic loops are not
    supported (trees only); fixed-joint subtrees are welded into the nearest
    movable ancestor.
    """
    root = ET.parse(path).getroot()
    links: Dict[str, _Link] = {}
    for el in root.findall("link"):
        mass, com, I = _parse_inertial(el)
        links[el.get("name")] = _Link(el.get("name"), mass, com, I,
                                      _parse_collisions(el))

    joints: List[_Joint] = []
    for el in root.findall("joint"):
        origin = el.find("origin")
        axis_el = el.find("axis")
        lim = el.find("limit")
        dyn = el.find("dynamics")
        axis = _vec(axis_el.get("xyz") if axis_el is not None else None, "1 0 0")
        n = np.linalg.norm(axis)
        if n > 0:
            axis = axis / n
        # URDF defaults a missing lower/upper to 0, which would LOCK the
        # joint at q=0 (the anymal_c URDF writes <limit effort velocity/>
        # only).  Real consumers (Isaac Gym; reference trains anymal_c
        # with moving joints) treat exactly that 0/0 case as unlimited —
        # do the same, but ONLY for 0/0: a nonzero lower==upper is an
        # intentional pin, and an inverted range is an authoring error
        # worth failing loudly on rather than silently unlocking.
        lo = float(lim.get("lower", 0.0)) if lim is not None else -1e9
        hi = float(lim.get("upper", 0.0)) if lim is not None else 1e9
        if lo == hi == 0.0:
            lo, hi = -1e9, 1e9
        elif lo > hi:
            raise ValueError(
                f"joint {el.get('name')!r}: inverted limit range "
                f"[{lo}, {hi}]")
        joints.append(
            _Joint(
                name=el.get("name"),
                jtype=el.get("type"),
                parent=el.find("parent").get("link"),
                child=el.find("child").get("link"),
                origin_pos=_vec(origin.get("xyz") if origin is not None else None),
                origin_rot=_rpy_to_mat(
                    _vec(origin.get("rpy") if origin is not None else None)
                ),
                axis=axis,
                lower=lo,
                upper=hi,
                effort=float(lim.get("effort", 1e9)) if lim is not None else 1e9,
                velocity=float(lim.get("velocity", 1e9)) if lim is not None else 1e9,
                damping=float(dyn.get("damping", 0.0)) if dyn is not None else 0.0,
                friction=float(dyn.get("friction", 0.0)) if dyn is not None else 0.0,
            )
        )

    child_of = {j.child: j for j in joints}
    root_links = [n for n in links if n not in child_of]
    if len(root_links) != 1:
        raise ValueError(f"expected single root link, got {root_links}")

    # ---- assign movable-body indices by DFS over movable joints ----
    children: Dict[str, List[_Joint]] = {n: [] for n in links}
    for j in joints:
        children[j.parent].append(j)

    body_names: List[str] = [root_links[0]]
    joint_list: List[_Joint] = []
    parent_idx: List[int] = [-1]
    # transform of each *link frame* relative to its owning movable body frame
    link_owner: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {
        root_links[0]: (0, np.zeros(3), np.eye(3))
    }

    def visit(link_name: str):
        owner, opos, orot = link_owner[link_name]
        for j in children[link_name]:
            if j.jtype in _MOVABLE:
                if j.jtype == "prismatic":
                    raise NotImplementedError("prismatic joints not supported yet")
                idx = len(body_names)
                body_names.append(j.child)
                parent_idx.append(owner)
                # anchor expressed in owner's frame
                j.origin_pos = opos + orot @ j.origin_pos
                j.origin_rot = orot @ j.origin_rot
                joint_list.append(j)
                link_owner[j.child] = (idx, np.zeros(3), np.eye(3))
            else:  # fixed: weld into owner
                cpos = opos + orot @ j.origin_pos
                crot = orot @ j.origin_rot
                link_owner[j.child] = (owner, cpos, crot)
            visit(j.child)

    visit(root_links[0])

    nb = len(body_names)
    nj = nb - 1

    # ---- merge inertials of welded links into owners ----
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for name, link in links.items():
        owner, opos, orot = link_owner[name]
        m2 = link.mass
        c2 = opos + orot @ link.com
        I2 = orot @ link.inertia @ orot.T
        mass[owner], com[owner], inertia[owner] = _merge_inertia(
            mass[owner], com[owner], inertia[owner], m2, c2, I2
        )

    # ---- collision spheres, named after their source link ----
    col_body: List[int] = []
    col_names: List[str] = []
    col_off: List[np.ndarray] = []
    col_rad: List[float] = []
    for name, link in links.items():
        owner, opos, orot = link_owner[name]
        for off, rad in link.collisions:
            col_body.append(owner)
            col_names.append(name)
            col_off.append(opos + orot @ off)
            col_rad.append(rad)
    order = np.argsort(np.array(col_body), kind="stable")
    col_body = [col_body[i] for i in order]
    col_names = [col_names[i] for i in order]
    col_off = [col_off[i] for i in order]
    col_rad = [col_rad[i] for i in order]

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32))

    def rows(arrays, width):
        return f32(np.stack(arrays) if arrays else np.zeros((0, width)))

    model = RobotModel(
        nb=nb,
        parent=tuple(parent_idx),
        body_names=tuple(body_names),
        joint_names=tuple(j.name for j in joint_list),
        collision_body=tuple(col_body),
        collision_names=tuple(col_names),
        joint_pos=rows([j.origin_pos for j in joint_list], 3),
        joint_rot=rows([_mat_to_quat(j.origin_rot) for j in joint_list], 4),
        joint_axis=rows([j.axis for j in joint_list], 3),
        q_lower=f32([j.lower for j in joint_list]),
        q_upper=f32([j.upper for j in joint_list]),
        effort_limit=f32([j.effort for j in joint_list]),
        velocity_limit=f32([j.velocity for j in joint_list]),
        joint_damping=f32([j.damping for j in joint_list]),
        joint_friction=f32([j.friction for j in joint_list]),
        mass=f32(mass),
        com=f32(com),
        inertia=f32(inertia),
        collision_offset=rows(col_off, 3),
        collision_radius=f32(col_rad),
    )
    return model, {j.name: i for i, j in enumerate(joint_list)}
