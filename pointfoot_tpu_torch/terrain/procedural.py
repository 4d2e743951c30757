"""Procedural curriculum terrain (pointfoot_tpu/terrain/procedural.py).

Heights are a closed-form function of the global cell index: every random
draw is a stateless splitmix32-style hash of (seed, cell, draw).  The hash
must match the JAX package bit for bit, since every committed rough policy
trained on this realization.  PyTorch has no logical right shift for
uint32 on the CPU, so the hash runs in int64 holding values in [0, 2^32)
and masks after every multiply; `_mul32` keeps each product inside int64.
The same code runs on python ints.

The JAX package evaluates the closed form in every query because a TPU
gather costs more than the hash.  On a CUDA device the opposite holds, and
an eager query is bound by the host's dispatch of its ~2,400 operations:
there `ProceduralTerrain` evaluates the closed form once, at construction,
over the whole grid (`materialize`), and answers each query with one
indexed read of packed per-cell tables (a `TerrainGrid`), bit for bit what
the closed form computes on that device.  On the CPU the queries keep the
closed form.

The env's two queries, `surface_at` and `height_scan_at`, run in the
spans `terrain.surface` and `terrain.scan` and count their points in
`terrain.points`, and those the tables answer in `terrain.table_points`;
the one-time build runs in the span `terrain.materialize`
(utils/profiling.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pointfoot_tpu_torch.terrain.grid import TerrainCfg, TerrainGrid
from pointfoot_tpu_torch.utils import profiling

_M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ hashing

def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32): a constant above 2^31 enters as
    c - 2^32, which leaves the low 32 bits unchanged and the int64 product
    without overflow."""
    if c >= 1 << 31:
        c -= 1 << 32
    return (x * c) & _M32


def _mix(x):
    """splitmix32 finalizer."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _fold(h, k):
    if isinstance(k, torch.Tensor):
        k = k.to(torch.int64) & _M32
    else:
        k = int(k) & _M32
    return _mix(h ^ ((_mul32(k, 0x85EBCA6B) + 0xC2B2AE35) & _M32))


def hash_u32(seed: int, *keys):
    """Stateless hash of integer keys -> values in [0, 2^32) (int64)."""
    h = (int(seed) & _M32) ^ 0x9E3779B9
    for k in keys:
        h = _fold(h, k)
    return h


def _to_unif(h):
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def hash_unif(seed: int, *keys):
    """Uniform [0, 1) float32 from a stateless hash."""
    return _to_unif(hash_u32(seed, *keys))


def hash_prefix(seed: int, *keys):
    """Partial hash state after folding `keys`: a bit-exact prefix of
    hash_u32(seed, *keys, more...), hoisted out of per-draw chains."""
    return hash_u32(seed, *keys)


def hash_unif_from(prefix, *keys):
    """Continue a hash_prefix with more keys -> uniform [0, 1) float32."""
    h = prefix
    for k in keys:
        h = _fold(h, k)
    return _to_unif(h)


# draw salts (one namespace per random consumer)
_S_ROUGH = 1
_S_RECT = 2
_S_STONE_OFF = 3
_S_STONE_H = 4
_S_DIFF = 5
_S_CHOICE = 6


@dataclass(frozen=True)
class ProcSpec:
    """Static description of the procedural curriculum grid."""

    hscale: float = 0.1
    cell_r: int = 80  # cells per sub-terrain
    cell_c: int = 80
    border: int = 250  # border cells
    num_rows: int = 10  # difficulty levels
    num_cols: int = 20  # terrain type columns
    proportions: Tuple[float, ...] = (0.1, 0.1, 0.35, 0.25, 0.2)
    curriculum: bool = True
    seed: int = 0
    stairs_up_cap: float = -1.0  # only a positive value applies

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_rows * self.cell_r + 2 * self.border,
                self.num_cols * self.cell_c + 2 * self.border)


def _thresholds(spec: ProcSpec):
    cum = list(np.cumsum(spec.proportions))
    return cum + [cum[-1] if cum else 0.0] * (7 - len(cum))


# ------------------------------------------------- closed-form sub-terrains
# (u, v): int64 cell coords inside the sub-terrain; difficulty-derived
# arguments are float32 tensors.  Static sizes are python numbers, truncated
# exactly as the JAX module does.

def _pyramid_sloped(spec, u, v, slope, platform_size=3.0):
    rows, cols, hs = spec.cell_r, spec.cell_c, spec.hscale
    cx, cy = (rows - 1) / 2.0, (cols - 1) / 2.0
    dx = 1.0 - torch.abs(u - cx) / cx
    dy = 1.0 - torch.abs(v - cy) / cy
    d = torch.minimum(dx, dy)
    max_h = slope * (rows / 2.0) * hs
    plat = int(platform_size / hs / 2)
    r0, r1 = int(cx) - plat, int(cx) + plat
    c0, c1 = int(cy) - plat, int(cy) + plat
    d_corner = min(1.0 - max(abs(r0 - cx), abs(r1 - 1 - cx)) / cx,
                   1.0 - max(abs(c0 - cy), abs(c1 - 1 - cy)) / cy)
    in_plat = (u >= r0) & (u < r1) & (v >= c0) & (v < c1)
    return torch.where(in_plat, max_h * d_corner, max_h * d)


def _rough_noise(spec, i, j, u, v, min_h=-0.05, max_h=0.05, step=0.005,
                 downsampled_scale=0.2):
    ds = max(int(downsampled_scale / spec.hscale), 1)
    n_levels = len(np.arange(min_h, max_h + step, step))
    uu = hash_unif(spec.seed + _S_ROUGH, i, j, u // ds, v // ds)
    idx = torch.clamp_max((uu * n_levels).to(torch.int64), n_levels - 1)
    return min_h + idx.to(torch.float32) * step


def _pyramid_stairs(spec, u, v, step_height, step_width=0.31,
                    platform_size=3.0):
    rows, cols, hs = spec.cell_r, spec.cell_c, spec.hscale
    sw = max(int(step_width / hs), 1)
    plat = max(int(platform_size / hs), 1)
    n_iter = 0
    r0, r1, c0, c1 = 0, rows, 0, cols
    while (r1 - r0) > plat and (c1 - c0) > plat:
        r0, r1, c0, c1 = r0 + sw, r1 - sw, c0 + sw, c1 - sw
        n_iter += 1
    k = torch.minimum(
        torch.minimum(u // sw, (rows - 1 - u) // sw),
        torch.minimum(v // sw, (cols - 1 - v) // sw))
    k = torch.clamp_max(k, n_iter)
    return step_height * k.to(torch.float32)


def _discrete_obstacles(spec, i, j, u, v, max_height, min_size=1.0,
                        max_size=2.0, num_rects=20, platform_size=3.0):
    rows, cols, hs = spec.cell_r, spec.cell_c, spec.hscale
    h = torch.zeros_like(max_height)
    pfx = hash_prefix(spec.seed + _S_RECT, i, j)
    for k in range(num_rects):
        uw = hash_unif_from(pfx, 8 * k + 0)
        ul = hash_unif_from(pfx, 8 * k + 1)
        ur = hash_unif_from(pfx, 8 * k + 2)
        uc = hash_unif_from(pfx, 8 * k + 3)
        uh = hash_unif_from(pfx, 8 * k + 4)
        w = ((uw * (max_size - min_size) + min_size) / hs).to(torch.int64)
        ln = ((ul * (max_size - min_size) + min_size) / hs).to(torch.int64)
        r = (ur * torch.clamp_min(rows - w, 1).to(torch.float32)
             ).to(torch.int64)
        c = (uc * torch.clamp_min(cols - ln, 1).to(torch.float32)
             ).to(torch.int64)
        hidx = torch.clamp_max((uh * 4).to(torch.int64), 3)
        # heights table [-mh, -mh/2, mh/2, mh] without a gather
        sign = torch.where(hidx >= 2, 1.0, -1.0)
        mag = torch.where((hidx == 1) | (hidx == 2), 0.5, 1.0)
        rect_h = sign * mag * max_height
        inside = (u >= r) & (u < r + w) & (v >= c) & (v < c + ln)
        h = torch.where(inside, rect_h, h)
    plat = max(int(platform_size / hs / 2), 1)
    cx, cy = rows // 2, cols // 2
    in_plat = ((u >= cx - plat) & (u < cx + plat)
               & (v >= cy - plat) & (v < cy + plat))
    return torch.where(in_plat, 0.0, h)


def _stepping_stones(spec, i, j, u, v, stone_size, stone_distance,
                     max_height=0.0, platform_size=4.0, depth=-10.0):
    rows, cols, hs = spec.cell_r, spec.cell_c, spec.hscale
    ss = torch.clamp_min((stone_size / hs).to(torch.int64), 1)
    sd = (stone_distance / hs).to(torch.int64)
    pitch = ss + sd
    band = v // torch.clamp_min(pitch, 1)
    on_col = (v - band * pitch) < ss
    off = (hash_unif(spec.seed + _S_STONE_OFF, i, j, band)
           * ss.to(torch.float32)).to(torch.int64) - ss
    urow = u - off
    stone_row = urow // torch.clamp_min(pitch, 1)
    on_row = (urow - stone_row * pitch) < ss
    if max_height > 0.0:
        stone_h = ((hash_unif(spec.seed + _S_STONE_H, i, j, band, stone_row)
                    * 2.0 - 1.0) * max_height)
    else:
        stone_h = 0.0
    h = torch.where(on_col & on_row, stone_h, depth)
    plat = max(int(platform_size / hs / 2), 1)
    cx, cy = rows // 2, cols // 2
    in_plat = ((u >= cx - plat) & (u < cx + plat)
               & (v >= cy - plat) & (v < cy + plat))
    return torch.where(in_plat, 0.0, h)


def _gap(spec, u, v, gap_size, platform_size=3.0, depth=-8.0):
    rows, cols, hs = spec.cell_r, spec.cell_c, spec.hscale
    g = (gap_size / hs).to(torch.int64)
    p = max(int(platform_size / hs / 2), 1)
    cx, cy = rows // 2, cols // 2
    in_moat = ((u >= cx - p - g) & (u < cx + p + g)
               & (v >= cy - p - g) & (v < cy + p + g))
    in_plat = (u >= cx - p) & (u < cx + p) & (v >= cy - p) & (v < cy + p)
    return torch.where(in_plat, 0.0, torch.where(in_moat, depth, 0.0))


def _pit(spec, u, v, pit_depth, platform_size=4.0):
    rows, cols, hs = spec.cell_r, spec.cell_c, spec.hscale
    p = max(int(platform_size / hs / 2), 1)
    cx, cy = rows // 2, cols // 2
    in_plat = (u >= cx - p) & (u < cx + p) & (v >= cy - p) & (v < cy + p)
    return torch.where(in_plat, -pit_depth, 0.0)


# ------------------------------------------------------------ full grid

def cell_height(spec: ProcSpec, gi: torch.Tensor, gj: torch.Tensor):
    """Height of global grid cell (gi, gj), any integer shape (broadcast).
    Border cells and out-of-range indices are flat 0."""
    gi = gi.to(torch.int64)
    gj = gj.to(torch.int64)
    bi = gi - spec.border
    bj = gj - spec.border
    inside = ((bi >= 0) & (bi < spec.num_rows * spec.cell_r)
              & (bj >= 0) & (bj < spec.num_cols * spec.cell_c))
    # clamp so every branch sees valid sub-cell coords; masked at the end
    bi = torch.clamp(bi, 0, spec.num_rows * spec.cell_r - 1)
    bj = torch.clamp(bj, 0, spec.num_cols * spec.cell_c - 1)
    i = bi // spec.cell_r
    j = bj // spec.cell_c
    u = bi - i * spec.cell_r
    v = bj - j * spec.cell_c

    if spec.curriculum:
        difficulty = i.to(torch.float32) / max(spec.num_rows - 1, 1)
        choice = j.to(torch.float32) / spec.num_cols + 0.001
    else:
        du = hash_unif(spec.seed + _S_DIFF, i, j)
        didx = torch.clamp_max((du * 3).to(torch.int64), 2)
        difficulty = (0.5 + didx.to(torch.float32) * 0.25
                      + torch.where(didx == 2, -0.1, 0.0))
        choice = hash_unif(spec.seed + _S_CHOICE, i, j)

    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    disc_height = 0.05 + difficulty * 0.2
    stones_size = 1.5 * (1.05 - difficulty)
    stone_distance = torch.where(difficulty == 0.0, 0.05, 0.1)
    gap_size = 1.0 * difficulty
    pit_depth = 1.0 * difficulty

    p = _thresholds(spec)
    h = torch.zeros(torch.broadcast_shapes(u.shape, v.shape),
                    dtype=torch.float32, device=u.device)

    # evaluate only families with probability mass
    if p[0] > 0.0:  # sloped pyramid (negative slope on the first half)
        s = torch.where(choice < p[0] / 2, -slope, slope)
        hb = _pyramid_sloped(spec, u, v, s)
        h = torch.where(choice < p[0], hb, h)
    if p[1] > p[0]:  # rough sloped pyramid
        hb = (_pyramid_sloped(spec, u, v, slope)
              + _rough_noise(spec, i, j, u, v))
        h = torch.where((choice >= p[0]) & (choice < p[1]), hb, h)
    if p[3] > p[1]:  # stairs (up below p[2], down below p[3])
        up_h = (torch.clamp_max(step_height, spec.stairs_up_cap)
                if spec.stairs_up_cap > 0.0 else step_height)
        sh = torch.where(choice < p[2], -up_h, step_height)
        hb = _pyramid_stairs(spec, u, v, sh)
        h = torch.where((choice >= p[1]) & (choice < p[3]), hb, h)
    if p[4] > p[3]:  # discrete obstacles
        hb = _discrete_obstacles(spec, i, j, u, v, disc_height)
        h = torch.where((choice >= p[3]) & (choice < p[4]), hb, h)
    if p[5] > p[4]:  # stepping stones
        hb = _stepping_stones(spec, i, j, u, v, stones_size, stone_distance)
        h = torch.where((choice >= p[4]) & (choice < p[5]), hb, h)
    if p[6] > p[5]:  # gap
        hb = _gap(spec, u, v, gap_size)
        h = torch.where((choice >= p[5]) & (choice < p[6]), hb, h)
    if len(spec.proportions) > 6:  # pit tail
        hb = _pit(spec, u, v, pit_depth)
        h = torch.where(choice >= p[6], hb, h)
    return torch.where(inside, h, 0.0)


_ROWS = 128  # rows a block of `materialize`, as in the JAX package


def materialize(spec: ProcSpec, device="cpu") -> torch.Tensor:
    """`cell_height` over the whole index grid -> (R, C) float32 heights on
    `device`.  The function is elementwise, so each entry equals what a
    query evaluates for that cell on the same device.  Row blocks of
    `_ROWS` keep the int64 temporaries at a few MB."""
    R, C = spec.shape
    gj = torch.arange(C, device=device)[None, :]
    out = torch.empty((R, C), dtype=torch.float32, device=device)
    for r0 in range(0, R, _ROWS):
        gi = torch.arange(r0, min(r0 + _ROWS, R), device=device)[:, None]
        out[r0:r0 + _ROWS] = cell_height(spec, gi, gj)
    return out


def _table(spec: ProcSpec, env_origins: torch.Tensor,
           terrain_length: float) -> TerrainGrid:
    """The materialized closed form as a TerrainGrid on the origins'
    device.  Its derived columns are the closed-form query's own float32
    operations on that device (TerrainGrid's float64 `_derived_fields`
    would differ by an ulp), so every read is what the query computes.  The
    last row and column are never read: a query's cell is clamped to
    [0, R - 2] x [0, C - 2]."""
    with profiling.span("terrain.materialize"):
        h = materialize(spec, env_origins.device)
        h00, h10, h01 = h[:-1, :-1], h[1:, :-1], h[:-1, 1:]
        min3 = torch.zeros_like(h)
        min3[:-1, :-1] = torch.minimum(torch.minimum(h00, h10), h01)
        slope = h.new_zeros(h.shape + (2,))
        slope[:-1, :-1, 0] = (h10 - h00) / spec.hscale
        slope[:-1, :-1, 1] = (h01 - h00) / spec.hscale
        return TerrainGrid(h, min3, slope, spec.hscale,
                           spec.border * spec.hscale, env_origins,
                           spec.num_rows, spec.num_cols, terrain_length)


class ProceduralTerrain:
    """Query interface over the closed form: `height_at` (bilinear),
    `height_scan_at` (min of 3 neighbours), `surface_at` (cell plane: height
    and unit normal), plus the curriculum metadata the env reads.

    With `table` (by default: when the origins live on a CUDA device) the
    closed form is materialized once and `self.table`, a TerrainGrid,
    answers the queries.  A NaN coordinate then reads cell 0 of its axis,
    a border cell, which is 0 as the closed form reads it.  Without, each
    query evaluates its neighbour cells in one stacked `cell_height` call:
    the function is elementwise, so the result is the same as one call per
    neighbour, with a third of the kernel launches.
    """

    def __init__(self, spec: ProcSpec, env_origins: torch.Tensor,
                 terrain_length: float, table: Optional[bool] = None):
        self.spec = spec
        self.hscale = spec.hscale
        self.border = spec.border * spec.hscale
        self.env_origins = env_origins
        self.num_levels = spec.num_rows
        self.num_types = spec.num_cols
        self.terrain_length = terrain_length
        if table is None:
            table = env_origins.is_cuda
        self.table: Optional[TerrainGrid] = (
            _table(spec, env_origins, terrain_length) if table else None)

    def to(self, device) -> "ProceduralTerrain":
        return ProceduralTerrain(self.spec, self.env_origins.to(device),
                                 self.terrain_length)

    def _cell(self, x, y):
        R, C = self.spec.shape
        px = torch.clamp((x + self.border) / self.hscale, 0.0, R - 2.0)
        py = torch.clamp((y + self.border) / self.hscale, 0.0, C - 2.0)
        x0 = torch.floor(px).to(torch.int64)
        y0 = torch.floor(py).to(torch.int64)
        return x0, y0, px, py

    def _cells(self, x0, y0, offsets):
        gi = torch.stack([x0 + a for a, _ in offsets])
        gj = torch.stack([y0 + b for _, b in offsets])
        return cell_height(self.spec, gi, gj).unbind(0)

    def height_at(self, x, y):
        if self.table is not None:
            return self.table.height_at(x, y)
        x0, y0, px, py = self._cell(x, y)
        fx = px - x0
        fy = py - y0
        h00, h10, h01, h11 = self._cells(
            x0, y0, ((0, 0), (1, 0), (0, 1), (1, 1)))
        return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                + h01 * (1 - fx) * fy + h11 * fx * fy)

    def height_scan_at(self, x, y):
        if self.table is not None:
            profiling.count("terrain.table_points", x.numel())
            return self.table.height_scan_at(x, y)
        profiling.count("terrain.points", x.numel())
        with profiling.span("terrain.scan"):
            x0, y0, _, _ = self._cell(x, y)
            h00, h10, h01 = self._cells(x0, y0, ((0, 0), (1, 0), (0, 1)))
            return torch.minimum(torch.minimum(h00, h10), h01)

    def surface_at(self, x, y):
        if self.table is not None:
            profiling.count("terrain.table_points", x.numel())
            return self.table.surface_at(x, y)
        profiling.count("terrain.points", x.numel())
        with profiling.span("terrain.surface"):
            x0, y0, px, py = self._cell(x, y)
            h00, h10, h01 = self._cells(x0, y0, ((0, 0), (1, 0), (0, 1)))
            gx = (h10 - h00) / self.hscale
            gy = (h01 - h00) / self.hscale
            h = (h00 + gx * (px - x0) * self.hscale
                 + gy * (py - y0) * self.hscale)
            n = torch.stack([-gx, -gy, torch.ones_like(gx)], dim=-1)
            n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
            return h, n


def build_procedural(cfg: TerrainCfg, seed: int = 0,
                     device="cpu") -> ProceduralTerrain:
    """ProceduralTerrain from a TerrainCfg, on `device` (materialized there
    when it is a CUDA device).  An env origin sits at the centre of its
    sub-terrain, at the highest cell of the 1 m square around it; only
    those squares are evaluated, on the CPU, whatever the device: the CPU's
    and the card's closed forms are not promised to agree to the ulp."""
    hs = cfg.horizontal_scale
    spec = ProcSpec(
        hscale=hs,
        cell_r=int(cfg.terrain_length / hs),
        cell_c=int(cfg.terrain_width / hs),
        border=int(cfg.border_size / hs),
        num_rows=cfg.num_rows,
        num_cols=cfg.num_cols,
        proportions=tuple(cfg.terrain_proportions),
        curriculum=cfg.curriculum,
        seed=seed,
        stairs_up_cap=(-1.0 if cfg.stairs_up_height_cap is None
                       else float(cfg.stairs_up_height_cap)),
    )
    w = max(int(0.5 / hs), 1)
    cx = (spec.border + np.arange(cfg.num_rows) * spec.cell_r
          + spec.cell_r // 2)
    cy = (spec.border + np.arange(cfg.num_cols) * spec.cell_c
          + spec.cell_c // 2)
    win = np.arange(-w, w)
    gi = torch.from_numpy(cx[:, None, None, None] + win[None, None, :, None])
    gj = torch.from_numpy(cy[None, :, None, None] + win[None, None, None, :])
    z = cell_height(spec, gi, gj).amax(dim=(-2, -1)).numpy()
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3), np.float32)
    for i in range(cfg.num_rows):
        for j in range(cfg.num_cols):
            origins[i, j] = ((cx[i] - spec.border) * hs,
                             (cy[j] - spec.border) * hs, z[i, j])
    return ProceduralTerrain(spec, torch.from_numpy(origins).to(device),
                             cfg.terrain_length)
