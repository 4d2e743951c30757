"""Terrain config, table terrain and plane terrain
(a frozen copy of the port's terrain/grid.py).

`build_terrain` composes (num_rows levels x num_cols types) sub-terrains
from terrain/heightfield.py into one global heightfield with a border, in
float64 numpy drawing from one `np.random.default_rng(seed)` in the JAX
package's loop order, so its tables are bit-identical to the reference's.
`TerrainGrid` holds them as float32 tensors on one device and answers the
env's queries with one indexed read each: `height_at` (bilinear),
`height_scan_at` (min of 3 neighbours) and `surface_at` (the cell's plane:
height and unit normal).  The packed lookup tables those reads index are
built once, at construction: the JAX package derives them in the trace and
XLA hoists them out of the step, where an eager port would rebuild a
2.7 M-cell table on every query.  `flat_grid` is the plane terrain as a
degenerate grid of zeros.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference import heightfield as hfgen


@dataclass(frozen=True)
class TerrainCfg:
    """Terrain config: the JAX package's fields that a terrain or the
    env's curriculum reads, with its names and defaults."""

    mesh_type: str = "trimesh"  # 'plane' | 'heightfield' | 'trimesh'
    horizontal_scale: float = 0.1  # [m] cell size
    border_size: float = 25.0  # [m]
    curriculum: bool = True
    static_friction: float = 1.0  # ground friction when not randomized
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10  # difficulty levels
    num_cols: int = 20  # terrain types
    max_init_terrain_level: int = 5
    # proportions over the 8 families (cumulated into thresholds)
    terrain_proportions: Tuple[float, ...] = (0.1, 0.1, 0.35, 0.25, 0.2)
    # fill every cell with one named sub-terrain:
    # selected_kwargs={'type': <generator name>, **its arguments}
    selected: bool = False
    selected_kwargs: dict = field(default_factory=dict)
    # demotion rule: False scales the required distance by the seconds the
    # episode ran and judges it on the along-command progress; True is the
    # reference's rule (full episode length, net displacement)
    reference_exact_demotion: bool = False
    # cap on the stairs_up step height (m); None or <= 0 = reference-exact
    stairs_up_height_cap: Optional[float] = None
    # promotion rule: True promotes on distance > clip(0.5 |cmd| T, 2 m,
    # terrain_length / 2) instead of the fixed terrain_length / 2
    cmd_conditioned_promotion: bool = False
    # closed-form hashed terrain (terrain/procedural.py) instead of tables
    procedural: bool = False


def _as_f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


class TerrainGrid:
    """A global heightfield and the env origins, as tensors on one device.

    Besides the heights, `min3` (min of the cell and its +x and +y
    neighbours: the height-scan lookup as one read) and `slope` ((R, C, 2)
    forward-difference gradient: the contact plane from one read) come
    precomputed in float64.  A query clips its grid coordinates to
    [0, R - 2] x [0, C - 2] in float32, floors them and reads row
    x0 * C + y0 of a packed table.
    """

    def __init__(self, height: torch.Tensor, min3: torch.Tensor,
                 slope: torch.Tensor, hscale: float, border: float,
                 env_origins: torch.Tensor, num_levels: int, num_types: int,
                 terrain_length: float):
        self.height = height  # (R, C) float32 meters
        self.min3 = min3  # (R, C)
        self.slope = slope  # (R, C, 2) dh/dx, dh/dy per cell
        self.hscale = hscale
        self.border = border  # [m] offset of the grid origin
        self.env_origins = env_origins  # (levels, types, 3)
        self.num_levels = num_levels
        self.num_types = num_types
        self.terrain_length = terrain_length
        h = height
        sx = torch.cat([h[1:], h[-1:]], dim=0)
        sy = torch.cat([h[:, 1:], h[:, -1:]], dim=1)
        sxy = torch.cat([sy[1:], sy[-1:]], dim=0)
        # (R·C, 4): h, h(x+1), h(y+1), h(x+1, y+1) of each cell
        self._corners = torch.stack([h, sx, sy, sxy], dim=-1).reshape(-1, 4)
        # (R·C, 3): h, dh/dx, dh/dy of each cell
        self._plane = torch.cat([h[..., None], slope], dim=-1).reshape(-1, 3)
        self._min3 = min3.reshape(-1)

    def _cell_index(self, x, y):
        R, C = self.height.shape
        px = torch.clamp((x + self.border) / self.hscale, 0.0, R - 2.0)
        py = torch.clamp((y + self.border) / self.hscale, 0.0, C - 2.0)
        # a NaN coordinate (an exploded env, quarantined by the step) reads
        # cell 0 and keeps its NaN through the fractional part
        x0 = torch.nan_to_num(torch.floor(px)).to(torch.int64)
        y0 = torch.nan_to_num(torch.floor(py)).to(torch.int64)
        return x0, y0, px, py, x0 * C + y0

    def height_at(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Bilinear height."""
        x0, y0, px, py, idx = self._cell_index(x, y)
        fx = px - x0
        fy = py - y0
        q = self._corners[idx]
        h00, h10, h01, h11 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                + h01 * (1 - fx) * fy + h11 * fx * fy)

    def height_scan_at(self, x: torch.Tensor, y: torch.Tensor
                       ) -> torch.Tensor:
        """The height-scan lookup: min of the cell and its +x and +y
        neighbours."""
        return self._min3[self._cell_index(x, y)[4]]

    def surface_at(self, x: torch.Tensor, y: torch.Tensor):
        """(height, unit normal) of the cell's contact plane."""
        x0, y0, px, py, idx = self._cell_index(x, y)
        q = self._plane[idx]
        h00, gx, gy = q[..., 0], q[..., 1], q[..., 2]
        h = h00 + gx * (px - x0) * self.hscale + gy * (py - y0) * self.hscale
        n = torch.stack([-gx, -gy, torch.ones_like(gx)], dim=-1)
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        return h, n


def _derived_fields(height: np.ndarray, hscale: float):
    """min3 and slope of a heightfield, in float64 (see TerrainGrid)."""
    h = np.asarray(height, np.float64)
    h_xp = np.roll(h, -1, axis=0)
    h_xp[-1] = h[-1]
    h_yp = np.roll(h, -1, axis=1)
    h_yp[:, -1] = h[:, -1]
    min3 = np.minimum(np.minimum(h, h_xp), h_yp)
    gx = (h_xp - h) / hscale
    gy = (h_yp - h) / hscale
    return min3, np.stack([gx, gy], axis=-1)


def _grid(height: np.ndarray, hscale: float, border: float,
          origins: np.ndarray, terrain_length: float, device
          ) -> TerrainGrid:
    min3, slope = _derived_fields(height, hscale)
    return TerrainGrid(
        height=_as_f32(height, device), min3=_as_f32(min3, device),
        slope=_as_f32(slope, device), hscale=hscale, border=border,
        env_origins=_as_f32(origins, device), num_levels=origins.shape[0],
        num_types=origins.shape[1], terrain_length=terrain_length)


def flat_grid(size: float = 40.0, hscale: float = 0.5, num_levels: int = 1,
              num_types: int = 1, spacing: float = 3.0,
              device="cpu") -> TerrainGrid:
    """Plane terrain as a degenerate grid of zeros, the env origins on a
    square lattice `spacing` apart."""
    R = C = int(size / hscale)
    origins = np.zeros((num_levels, num_types, 3), np.float32)
    for i in range(num_levels):
        for j in range(num_types):
            origins[i, j] = (i * spacing, j * spacing, 0.0)
    return _grid(np.zeros((R, C)), hscale, size / 2, origins, size, device)


def _make_subterrain(cfg: TerrainCfg, choice: float, difficulty: float,
                     rng: np.random.Generator,
                     shape: Tuple[int, int]) -> np.ndarray:
    """One sub-terrain cell: the family by `choice` against the cumulated
    proportions, its parameters scaled by `difficulty`."""
    hs = cfg.horizontal_scale
    hf = np.zeros(shape, np.float64)
    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    discrete_obstacles_height = 0.05 + difficulty * 0.2
    stepping_stones_size = 1.5 * (1.05 - difficulty)
    stone_distance = 0.05 if difficulty == 0 else 0.1
    gap_size = 1.0 * difficulty
    pit_depth = 1.0 * difficulty
    cum = list(np.cumsum(list(cfg.terrain_proportions)))
    p = cum + [cum[-1] if cum else 0.0] * (7 - len(cum))
    if choice < p[0]:
        if choice < p[0] / 2:
            slope = -slope
        hfgen.pyramid_sloped(hf, hs, slope, platform_size=3.0)
    elif choice < p[1]:
        hfgen.pyramid_sloped(hf, hs, slope, platform_size=3.0)
        hfgen.random_uniform(hf, hs, rng, -0.05, 0.05, 0.005, 0.2)
    elif choice < p[3]:
        if choice < p[2]:
            # stairs up: only a positive cap applies, as in procedural.py
            if (cfg.stairs_up_height_cap is not None
                    and cfg.stairs_up_height_cap > 0.0):
                step_height = min(step_height, cfg.stairs_up_height_cap)
            step_height = -step_height
        hfgen.pyramid_stairs(hf, hs, step_width=0.31, step_height=step_height,
                             platform_size=3.0)
    elif choice < p[4]:
        hfgen.discrete_obstacles(hf, hs, rng, discrete_obstacles_height,
                                 1.0, 2.0, 20, platform_size=3.0)
    elif choice < p[5]:
        hfgen.stepping_stones(hf, hs, rng, stepping_stones_size,
                              stone_distance, max_height=0.0,
                              platform_size=4.0)
    elif choice < p[6]:
        hfgen.gap(hf, hs, gap_size, platform_size=3.0)
    else:
        hfgen.pit(hf, hs, pit_depth, platform_size=4.0)
    return hf


_SELECTED_GENERATORS = {
    "pyramid_sloped": lambda hf, hs, rng, kw: hfgen.pyramid_sloped(
        hf, hs, **kw),
    "random_uniform": lambda hf, hs, rng, kw: hfgen.random_uniform(
        hf, hs, rng, **kw),
    "pyramid_stairs": lambda hf, hs, rng, kw: hfgen.pyramid_stairs(
        hf, hs, **kw),
    "discrete_obstacles": lambda hf, hs, rng, kw: hfgen.discrete_obstacles(
        hf, hs, rng, **kw),
    "stepping_stones": lambda hf, hs, rng, kw: hfgen.stepping_stones(
        hf, hs, rng, **kw),
    "gap": lambda hf, hs, rng, kw: hfgen.gap(hf, hs, **kw),
    "pit": lambda hf, hs, rng, kw: hfgen.pit(hf, hs, **kw),
}


def build_terrain(cfg: TerrainCfg, seed: int = 0,
                  device="cpu") -> TerrainGrid:
    """The curriculum grid: level i (difficulty i / (num_rows - 1)) by type
    j (choice j / num_cols + 0.001), or random difficulties and choices
    without the curriculum, or every cell one named generator with
    `cfg.selected`.  An env origin sits at the centre of its sub-terrain, at
    the highest cell of the 1 m square around it."""
    rng = np.random.default_rng(seed)
    hs = cfg.horizontal_scale
    cell_r = int(cfg.terrain_length / hs)
    cell_c = int(cfg.terrain_width / hs)
    border = int(cfg.border_size / hs)
    R = cfg.num_rows * cell_r + 2 * border
    C = cfg.num_cols * cell_c + 2 * border
    big = np.zeros((R, C), np.float64)
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3), np.float32)
    w = max(int(0.5 / hs), 1)
    for i in range(cfg.num_rows):
        for j in range(cfg.num_cols):
            if cfg.selected:
                kw = dict(cfg.selected_kwargs)
                gen = _SELECTED_GENERATORS[kw.pop("type")]
                hf = gen(np.zeros((cell_r, cell_c)), hs, rng, kw)
            else:
                if cfg.curriculum:
                    difficulty = i / max(cfg.num_rows - 1, 1)
                    choice = j / cfg.num_cols + 0.001
                else:
                    difficulty = float(rng.choice([0.5, 0.75, 0.9]))
                    choice = float(rng.uniform(0, 1))
                hf = _make_subterrain(cfg, choice, difficulty, rng,
                                      (cell_r, cell_c))
            r0, c0 = border + i * cell_r, border + j * cell_c
            big[r0:r0 + cell_r, c0:c0 + cell_c] = hf
            cx = r0 + cell_r // 2
            cy = c0 + cell_c // 2
            z = big[cx - w:cx + w, cy - w:cy + w].max()
            origins[i, j] = ((cx - border) * hs, (cy - border) * hs, z)
    return _grid(big, hs, cfg.border_size, origins, cfg.terrain_length,
                 device)
