"""Sub-terrain heightfield generators (a frozen copy of the port's terrain/heightfield.py).

Pure numpy in float64, seeded through an explicit `np.random.Generator`:
each generator fills a (rows, cols) array of heights in meters in place,
given the horizontal cell size.  The code is the JAX package's, draw for
draw, so the tables terrain/grid.py composes from it are bit-identical to
the reference's.
"""

from __future__ import annotations

import numpy as np


def pyramid_sloped(hf: np.ndarray, hscale: float, slope: float,
                   platform_size: float = 1.0) -> np.ndarray:
    """Pyramid ramp rising toward the center (negative slope -> inverted)."""
    rows, cols = hf.shape
    cx, cy = (rows - 1) / 2, (cols - 1) / 2
    x = np.arange(rows)[:, None]
    y = np.arange(cols)[None, :]
    # normalized distance-to-edge in [0, 1] (1 at center)
    dx = 1.0 - np.abs(x - cx) / cx
    dy = 1.0 - np.abs(y - cy) / cy
    d = np.minimum(dx, dy)
    max_h = slope * (rows / 2) * hscale
    hf += max_h * d
    # flat platform in the middle
    plat = int(platform_size / hscale / 2)
    r0, r1 = int(cx) - plat, int(cx) + plat
    c0, c1 = int(cy) - plat, int(cy) + plat
    hmin = hf[r0:r1, c0:c1].min() if slope >= 0 else hf[r0:r1, c0:c1].max()
    hf[r0:r1, c0:c1] = hmin
    return hf


def random_uniform(hf: np.ndarray, hscale: float, rng: np.random.Generator,
                   min_height: float = -0.05, max_height: float = 0.05,
                   step: float = 0.005, downsampled_scale: float = 0.2) -> np.ndarray:
    """Random rough surface sampled on a coarse grid, nearest-upsampled."""
    rows, cols = hf.shape
    ds = max(int(downsampled_scale / hscale), 1)
    r_c, c_c = rows // ds + 1, cols // ds + 1
    levels = np.arange(min_height, max_height + step, step)
    coarse = rng.choice(levels, size=(r_c, c_c))
    up = np.repeat(np.repeat(coarse, ds, 0), ds, 1)[:rows, :cols]
    hf += up
    return hf


def pyramid_stairs(hf: np.ndarray, hscale: float, step_width: float,
                   step_height: float, platform_size: float = 1.0) -> np.ndarray:
    """Concentric square steps toward the center (negative height -> down)."""
    rows, cols = hf.shape
    sw = max(int(step_width / hscale), 1)
    height = 0.0
    r0, r1, c0, c1 = 0, rows, 0, cols
    while (r1 - r0) > max(int(platform_size / hscale), 1) and (c1 - c0) > max(
        int(platform_size / hscale), 1
    ):
        r0, r1, c0, c1 = r0 + sw, r1 - sw, c0 + sw, c1 - sw
        height += step_height
        hf[r0:r1, c0:c1] = height
    return hf


def discrete_obstacles(hf: np.ndarray, hscale: float, rng: np.random.Generator,
                       max_height: float, min_size: float = 1.0,
                       max_size: float = 2.0, num_rects: int = 20,
                       platform_size: float = 1.0) -> np.ndarray:
    """Random raised/sunken rectangles (terrain_utils discrete_obstacles)."""
    rows, cols = hf.shape
    heights = np.array([-max_height, -max_height / 2, max_height / 2, max_height])
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / hscale)
        l = int(rng.uniform(min_size, max_size) / hscale)
        r = int(rng.integers(0, max(rows - w, 1)))
        c = int(rng.integers(0, max(cols - l, 1)))
        hf[r:r + w, c:c + l] = rng.choice(heights)
    # flat platform at the center
    cx, cy = rows // 2, cols // 2
    plat = max(int(platform_size / hscale / 2), 1)
    hf[cx - plat:cx + plat, cy - plat:cy + plat] = 0.0
    return hf


def stepping_stones(hf: np.ndarray, hscale: float, rng: np.random.Generator,
                    stone_size: float, stone_distance: float,
                    max_height: float = 0.0, platform_size: float = 1.0,
                    depth: float = -10.0) -> np.ndarray:
    """Grid of stones over a deep trench (terrain_utils stepping_stones)."""
    rows, cols = hf.shape
    ss = max(int(stone_size / hscale), 1)
    sd = int(stone_distance / hscale)
    hf[:] = depth
    c = 0
    while c < cols:
        r = int(rng.integers(0, ss)) - ss
        while r < rows:
            r0, r1 = max(r, 0), min(r + ss, rows)
            hf[r0:r1, c:c + ss] = rng.uniform(-max_height, max_height)
            r += ss + sd
        c += ss + sd
    cx, cy = rows // 2, cols // 2
    plat = max(int(platform_size / hscale / 2), 1)
    hf[cx - plat:cx + plat, cy - plat:cy + plat] = 0.0
    return hf


def gap(hf: np.ndarray, hscale: float, gap_size: float,
        platform_size: float = 1.0, depth: float = -8.0) -> np.ndarray:
    """Square moat around a center platform (reference terrain.py:166-177)."""
    rows, cols = hf.shape
    g = int(gap_size / hscale)
    p = max(int(platform_size / hscale / 2), 1)
    cx, cy = rows // 2, cols // 2
    hf[cx - p - g:cx + p + g, cy - p - g:cy + p + g] = depth
    hf[cx - p:cx + p, cy - p:cy + p] = 0.0
    return hf


def pit(hf: np.ndarray, hscale: float, depth: float,
        platform_size: float = 1.0) -> np.ndarray:
    """Sunken center platform with raised rim (reference terrain.py:179-187)."""
    rows, cols = hf.shape
    p = max(int(platform_size / hscale / 2), 1)
    cx, cy = rows // 2, cols // 2
    hf[cx - p:cx + p, cy - p:cy + p] = -depth
    return hf
