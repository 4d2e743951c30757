"""Table and plane terrain of the PyTorch port (terrain/heightfield.py,
terrain/grid.py) vs pointfoot_tpu.terrain.

The generators and `build_terrain` run the same float64 numpy from one
seeded generator, so heights, the derived min3 and slope fields and the
env origins are bit-identical (`np.array_equal`).  The three queries run in
float32 on both sides and agree within 1e-6, heights and normals, at seeded
random points inside and outside the grid and on the clip's edge.  Then the
cases of tests/test_terrain.py and the table half of
tests/test_stairs_cap.py, under the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.terrain import grid as jgrid
from pointfoot_tpu.terrain import heightfield as jhf
from pointfoot_tpu_torch.terrain import grid as tgrid
from pointfoot_tpu_torch.terrain import heightfield as hf
from pointfoot_tpu_torch.terrain import procedural
from pointfoot_tpu_torch.terrain.grid import TerrainCfg, build_terrain, \
    flat_grid

QUERY_ATOL = 1e-6

# (generator, arguments after (hf, hscale[, rng])), rng drawn when seeded
GENERATORS = [
    ("pyramid_sloped", False, dict(slope=0.4, platform_size=1.0)),
    ("pyramid_sloped", False, dict(slope=-0.3, platform_size=3.0)),
    ("random_uniform", True, dict(min_height=-0.05, max_height=0.05,
                                  step=0.005, downsampled_scale=0.2)),
    ("pyramid_stairs", False, dict(step_width=0.31, step_height=-0.2,
                                   platform_size=3.0)),
    ("discrete_obstacles", True, dict(max_height=0.15, platform_size=3.0)),
    ("stepping_stones", True, dict(stone_size=0.8, stone_distance=0.1,
                                   max_height=0.05, platform_size=4.0)),
    ("gap", False, dict(gap_size=0.6, platform_size=3.0)),
    ("pit", False, dict(depth=0.7, platform_size=4.0)),
]


@pytest.mark.parametrize("name,seeded,kw", GENERATORS,
                         ids=[f"{g[0]}-{i}" for i, g in
                              enumerate(GENERATORS)])
def test_generator_bit_identical(name, seeded, kw):
    args = lambda s: (np.random.default_rng(s),) if seeded else ()  # noqa
    got = getattr(hf, name)(np.zeros((80, 72)), 0.1, *args(4), **kw)
    want = getattr(jhf, name)(np.zeros((80, 72)), 0.1, *args(4), **kw)
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


CFGS = {
    "small": TerrainCfg(num_rows=4, num_cols=5, border_size=5.0),
    "default": TerrainCfg(),
    "no_curriculum": TerrainCfg(num_rows=3, num_cols=6, border_size=2.0,
                                curriculum=False),
    "extended": TerrainCfg(num_rows=2, num_cols=8, border_size=2.0,
                           terrain_length=4.0, terrain_width=4.0,
                           terrain_proportions=(0.1, 0.1, 0.2, 0.1, 0.1,
                                                0.1, 0.2, 0.1)),
    "stairs_cap": TerrainCfg(num_rows=10, num_cols=20,
                             stairs_up_height_cap=0.12),
    "selected": TerrainCfg(num_rows=2, num_cols=3, border_size=2.0,
                           selected=True,
                           selected_kwargs={"type": "discrete_obstacles",
                                            "max_height": 0.1}),
}


def _jax_cfg(cfg):
    return jgrid.TerrainCfg(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def grids():
    """name -> (port grid, JAX grid), built once."""
    return {k: (build_terrain(c, seed=3), jgrid.build_terrain(_jax_cfg(c),
                                                              seed=3))
            for k, c in CFGS.items()}


@pytest.mark.parametrize("name", list(CFGS))
def test_build_terrain_bit_identical(grids, name):
    got, want = grids[name]
    for field in ("height", "min3", "slope", "env_origins"):
        g = getattr(got, field)
        assert g.dtype == torch.float32, field
        assert np.array_equal(g.numpy(), np.asarray(getattr(want, field))), \
            field
    assert (got.hscale, got.border, got.num_levels, got.num_types,
            got.terrain_length) == (want.hscale, want.border,
                                    want.num_levels, want.num_types,
                                    want.terrain_length)


def _points(grid, n=4000, seed=0):
    """Seeded points over the grid and up to 5 m beyond it, and points on
    the clip's edge: exactly on cells R - 2 and C - 2 and just past them."""
    rng = np.random.default_rng(seed)
    R, C = grid.height.shape
    lo = -grid.border - 5.0
    hi_x = (R - 1) * grid.hscale - grid.border + 5.0
    hi_y = (C - 1) * grid.hscale - grid.border + 5.0
    x = rng.uniform(lo, hi_x, n)
    y = rng.uniform(lo, hi_y, n)
    ex = (R - 2) * grid.hscale - grid.border
    ey = (C - 2) * grid.hscale - grid.border
    x = np.r_[x, ex, ex, ex + 1e-3, -grid.border, ex]
    y = np.r_[y, ey, 0.0, ey + 1e-3, -grid.border, -grid.border - 1e-3]
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("name", ["small", "default", "extended"])
def test_queries_match_jax(grids, name):
    got, want = grids[name]
    x, y = _points(got)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(got.height_at(tx, ty).numpy(),
                               np.asarray(want.height_at(jx, jy)),
                               atol=QUERY_ATOL, rtol=0)
    np.testing.assert_allclose(got.height_scan_at(tx, ty).numpy(),
                               np.asarray(want.height_scan_at(jx, jy)),
                               atol=QUERY_ATOL, rtol=0)
    (h, n), (jh, jn) = got.surface_at(tx, ty), want.surface_at(jx, jy)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=QUERY_ATOL,
                               rtol=0)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=QUERY_ATOL,
                               rtol=0)
    assert h.shape == (len(x),) and n.shape == (len(x), 3)


def test_query_index_on_clip_edge(grids):
    """A point exactly on cell R - 2 reads that cell (the last row whose +x
    neighbour exists), and points beyond it clip to it."""
    got, _ = grids["small"]
    R, C = got.height.shape
    ex = (R - 2) * got.hscale - got.border
    x = torch.tensor([ex, ex + 7.0], dtype=torch.float32)
    y = torch.tensor([1.0, 1.0], dtype=torch.float32)
    x0, y0, _, _, idx = got._cell_index(x, y)
    assert x0.tolist() == [R - 2, R - 2]
    assert idx.dtype == torch.int64
    assert idx.tolist() == [(R - 2) * C + int(y0[0])] * 2


def test_queries_keep_nan_without_indexing_out_of_range(grids):
    got, _ = grids["small"]
    x = torch.tensor([float("nan"), 0.0])
    y = torch.tensor([0.0, float("nan")])
    h = got.height_at(x, y)
    hs, n = got.surface_at(x, y)
    assert torch.isnan(h).all() and torch.isnan(hs).all()
    assert got.height_scan_at(x, y).shape == (2,)


def test_flat_grid_matches_jax():
    got = flat_grid(size=404.0, num_levels=64, num_types=64, spacing=3.0)
    want = jgrid.flat_grid(size=404.0, num_levels=64, num_types=64,
                           spacing=3.0)
    for field in ("height", "min3", "slope", "env_origins"):
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field))), field
    assert (got.border, got.hscale, got.terrain_length) == (202.0, 0.5,
                                                            404.0)
    x = torch.tensor([1.0, -300.0, 150.0])
    assert got.height_at(x, x).abs().max() == 0.0
    h, n = got.surface_at(x, x)
    assert h.abs().max() == 0.0
    assert torch.equal(n, torch.tensor([[0.0, 0.0, 1.0]] * 3))


def test_procedural_keeps_the_config_name():
    assert procedural.TerrainCfg is TerrainCfg is tgrid.TerrainCfg


# JAX TerrainCfg fields that no terrain or curriculum of either package
# reads (legged_gym's Isaac Gym settings)
UNREAD_JAX_TERRAIN_FIELDS = ("vertical_scale", "dynamic_friction",
                             "restitution", "slope_treshold",
                             "measure_heights")


def test_terrain_cfg_fields_match_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(TerrainCfg)
           if f.name != "selected_kwargs"]
    want = [(f.name, f.default) for f in dataclasses.fields(jgrid.TerrainCfg)
            if f.name not in ("selected_kwargs",) + UNREAD_JAX_TERRAIN_FIELDS]
    assert got == want
    jax_names = {f.name for f in dataclasses.fields(jgrid.TerrainCfg)}
    assert set(UNREAD_JAX_TERRAIN_FIELDS) <= jax_names
    assert TerrainCfg().selected_kwargs == {}


# ------------------------------------- tests/test_terrain.py, under the port

def test_pyramid_sloped_monotone_to_center():
    a = hf.pyramid_sloped(np.zeros((80, 80)), 0.1, slope=0.4,
                          platform_size=1.0)
    assert a[40, 40] > a[0, 0]
    assert a[0, 0] == 0.0
    inv = hf.pyramid_sloped(np.zeros((80, 80)), 0.1, slope=-0.4)
    assert inv[40, 40] < inv[0, 0]


def test_random_uniform_bounds_and_determinism():
    rng = np.random.default_rng(7)
    a = hf.random_uniform(np.zeros((50, 50)), 0.1, rng, -0.05, 0.05, 0.005,
                          0.2)
    assert a.min() >= -0.0501 and a.max() <= 0.0501
    b = hf.random_uniform(np.zeros((50, 50)), 0.1,
                          np.random.default_rng(7), -0.05, 0.05, 0.005, 0.2)
    np.testing.assert_array_equal(a, b)


def test_pyramid_stairs_step_heights():
    a = hf.pyramid_stairs(np.zeros((80, 80)), 0.1, step_width=0.31,
                          step_height=0.1, platform_size=1.0)
    levels = np.unique(np.round(a, 6))
    np.testing.assert_allclose(np.diff(levels), 0.1, atol=1e-9)
    assert a[40, 40] == levels[-1]


def test_discrete_obstacles_center_platform():
    a = hf.discrete_obstacles(np.zeros((80, 80)), 0.1,
                              np.random.default_rng(0), 0.15)
    assert a[40, 40] == 0.0
    assert np.abs(a).max() <= 0.15 + 1e-9


def test_stepping_stones_trench():
    a = hf.stepping_stones(np.zeros((80, 80)), 0.1, np.random.default_rng(1),
                           stone_size=1.0, stone_distance=0.3,
                           platform_size=2.0)
    assert a.min() == -10.0
    assert a[40, 40] == 0.0


def test_gap_and_pit():
    g = hf.gap(np.zeros((80, 80)), 0.1, gap_size=0.6, platform_size=1.0)
    assert g[40, 40] == 0.0
    assert g.min() == -8.0
    p = hf.pit(np.zeros((80, 80)), 0.1, depth=0.7, platform_size=1.0)
    assert p[40, 40] == -0.7


def test_build_terrain_grid_shape_and_origins():
    cfg = TerrainCfg(num_rows=4, num_cols=5, terrain_length=8.0,
                     terrain_width=8.0, border_size=5.0, curriculum=True)
    grid = build_terrain(cfg, seed=0)
    assert grid.env_origins.shape == (4, 5, 3)
    assert grid.height.shape == (4 * 80 + 2 * 50, 5 * 80 + 2 * 50)
    assert torch.equal(grid.height, build_terrain(cfg, seed=0).height)


def test_default_proportions_have_no_pits():
    cfg = TerrainCfg(num_rows=4, num_cols=10, border_size=2.0,
                     terrain_length=4.0, terrain_width=4.0, curriculum=True)
    assert float(build_terrain(cfg, seed=0).height.min()) > -3.0


def test_extended_proportions_reach_gap_and_pit():
    cfg = TerrainCfg(num_rows=2, num_cols=8, border_size=2.0,
                     terrain_length=4.0, terrain_width=4.0, curriculum=True,
                     terrain_proportions=(0.1, 0.1, 0.2, 0.1, 0.1, 0.1,
                                          0.2, 0.1))
    assert float(build_terrain(cfg, seed=0).height.min()) <= -5.0


def test_height_sampling_consistency():
    cfg = TerrainCfg(num_rows=2, num_cols=2, border_size=5.0,
                     curriculum=True)
    grid = build_terrain(cfg, seed=3)
    h = grid.height.numpy()
    x = torch.from_numpy(np.arange(20, 40) * grid.hscale - grid.border)
    y = torch.from_numpy(np.arange(30, 50) * grid.hscale - grid.border)
    got = grid.height_at(x.float(), y.float()).numpy()
    np.testing.assert_allclose(got, h[20:40, 30:50].diagonal(), atol=1e-5)
    scan = grid.height_scan_at(x.float(), y.float()).numpy()
    assert np.all(scan <= got + 1e-5)


def test_flat_grid():
    g = flat_grid(size=20.0, num_levels=2, num_types=2, spacing=3.0)
    assert float(g.height_at(torch.tensor(1.0), torch.tensor(1.0))) == 0.0
    assert g.env_origins.shape == (2, 2, 3)


# -------------------------- tests/test_stairs_cap.py, the table half

CAP = 0.12
N_RINGS = 8  # (80-cell cell - 30-cell platform) / 2 // 3-cell ring width


def _stairs_up_step(terrain, cfg, level, col):
    """Per-ring step height of the stairs cell (level, col): the
    center-to-rim height range over the ring count."""
    ox, oy = terrain.env_origins[level, col, :2].tolist()
    xs = np.linspace(ox, ox + 0.5 * cfg.terrain_length - 0.2, 160)
    ys = np.full_like(xs, oy)
    h = terrain.height_at(torch.tensor(xs, dtype=torch.float32),
                          torch.tensor(ys, dtype=torch.float32)).numpy()
    return float(h.max() - h.min()) / N_RINGS


def test_stairs_up_cap_applies_table(grids):
    base = TerrainCfg(num_rows=10, num_cols=20)
    col, level = 6, 9  # stairs_up column at max difficulty (step 0.23 m)
    ref = build_terrain(base, seed=0)
    capped = build_terrain(dataclasses.replace(base,
                                               stairs_up_height_cap=CAP),
                           seed=0)
    s_ref = _stairs_up_step(ref, base, level, col)
    s_cap = _stairs_up_step(capped, base, level, col)
    assert s_ref > 0.2, s_ref
    assert s_cap <= CAP * 1.2, s_cap
    d_ref = _stairs_up_step(ref, base, level, 12)
    d_cap = _stairs_up_step(capped, base, level, 12)
    np.testing.assert_allclose(d_cap, d_ref, atol=1e-5)
    lo_ref = _stairs_up_step(ref, base, 1, col)
    lo_cap = _stairs_up_step(capped, base, 1, col)
    np.testing.assert_allclose(lo_cap, lo_ref, atol=1e-5)
