"""Headless skeleton visualizer: rollout frames to PNG / GIF
(pointfoot_tpu/utils/visualizer.py).

A matplotlib 3-D line skeleton of the kinematic tree over a terrain patch,
one PNG per frame or an animated GIF through Pillow.  A frame is one env:
a PhysicsState and PhysicsParams of one row; its kinematics run on the
state's device and come to the CPU before matplotlib draws them.
"""

from __future__ import annotations

from io import BytesIO
from typing import List

import numpy as np
import torch

from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.model import (PhysicsParams, PhysicsState,
                                               RobotModel)


def _kinematics(model: RobotModel, phys_single: PhysicsState,
                params_single: PhysicsParams):
    """World body origins (nb, 3) and rotations (nb, 3, 3) of the one env,
    as numpy."""
    model = model.to(phys_single.base_pos.device)
    with torch.no_grad():
        kin = dynamics.forward_kinematics(model, phys_single, params_single)
    return kin.body_pos[0].cpu().numpy(), kin.body_rot[0].cpu().numpy()


def body_positions(model: RobotModel, phys_single: PhysicsState,
                   params_single: PhysicsParams) -> np.ndarray:
    """(nb, 3) world body origins of one env."""
    return _kinematics(model, phys_single, params_single)[0]


def _terrain_heights(terrain, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """The terrain's `height_at` on a numpy grid, queried on the device
    that holds the terrain's tensors."""
    dev = getattr(getattr(terrain, "env_origins", None), "device", "cpu")
    x = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    with torch.no_grad():
        return terrain.height_at(x, y).cpu().numpy()


def render_frame(model: RobotModel, phys_single: PhysicsState,
                 params_single: PhysicsParams, terrain=None,
                 ax=None, lim: float = 1.0):
    """Draw one frame; returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos, rot = _kinematics(model, phys_single, params_single)
    if ax is None:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
    else:
        fig = ax.figure
        ax.cla()
    # kinematic tree edges
    for b in range(1, model.nb):
        p = model.parent[b]
        ax.plot(*zip(pos[p], pos[b]), "o-", color="tab:blue", lw=2, ms=3)
    # collision spheres (feet etc.)
    offsets = model.collision_offset.cpu().numpy()
    radii = model.collision_radius.cpu().numpy()
    for c, b in enumerate(model.collision_body):
        center = pos[b] + rot[b] @ offsets[c]
        ax.scatter(*center, s=60 * float(radii[c]) / 0.03,
                   color="tab:red", alpha=0.6)
    base = pos[0]
    # terrain patch under the robot
    if terrain is not None:
        xs = np.linspace(base[0] - lim, base[0] + lim, 24)
        ys = np.linspace(base[1] - lim, base[1] + lim, 24)
        X, Y = np.meshgrid(xs, ys)
        Z = _terrain_heights(terrain, X, Y)
        ax.plot_surface(X, Y, Z, alpha=0.25, color="gray", lw=0)
    else:
        ax.plot([base[0] - lim, base[0] + lim], [base[1], base[1]], [0, 0],
                color="gray", alpha=0.4)
    ax.set_xlim(base[0] - lim, base[0] + lim)
    ax.set_ylim(base[1] - lim, base[1] + lim)
    ax.set_zlim(0, 2 * lim)
    ax.set_box_aspect((1, 1, 1))
    return fig


def render_rollout(model: RobotModel, states: List[PhysicsState],
                   params_single: PhysicsParams, out_path: str,
                   terrain=None, fps: int = 25) -> str:
    """Render a list of one-env PhysicsStates to a GIF (or a PNG of the
    first when there is one frame or `out_path` is no .gif)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    frames = []
    for st in states:
        render_frame(model, st, params_single, terrain=terrain, ax=ax)
        buf = BytesIO()
        fig.savefig(buf, format="png", dpi=80)
        buf.seek(0)
        frames.append(Image.open(buf).convert("P"))
    plt.close(fig)
    if len(frames) == 1 or not out_path.endswith(".gif"):
        frames[0].save(out_path)
    else:
        frames[0].save(out_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
    return out_path
