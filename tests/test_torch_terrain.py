"""Procedural terrain of the PyTorch port vs pointfoot_tpu.terrain.procedural.

The hash must be bit-exact (every committed rough policy trained on this
realization); heights, scans and surfaces agree to atol 1e-6.  The port's
table route (the closed form materialized, as on a CUDA device) equals its
closed-form route bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.terrain import procedural as jp
from pointfoot_tpu_torch.terrain import procedural as tp
from pointfoot_tpu_torch.terrain.grid import TerrainCfg
from pointfoot_tpu_torch.utils import profiling

from _torch_parity import assert_bits_equal, procedural_points

I_GRID = np.arange(-3, 50, 7)
J_GRID = np.arange(0, 53, 7) * 3


@pytest.mark.parametrize("seed", [0, 2, 12345])
def test_hash_u32_bit_exact(seed):
    i = I_GRID[:, None]
    j = J_GRID[None, :]
    for d in (0, 1, 7, 158):
        want = np.asarray(jp.hash_u32(seed, jnp.asarray(i), jnp.asarray(j),
                                      d))
        got = tp.hash_u32(seed, torch.from_numpy(i), torch.from_numpy(j), d)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 2, 12345])
def test_hash_prefix_bit_exact(seed):
    """hash_prefix + hash_unif_from reproduce JAX's hash_unif exactly."""
    i = torch.from_numpy(I_GRID)
    j = torch.from_numpy(J_GRID)
    pfx = tp.hash_prefix(seed, i, j)
    want_pfx = np.asarray(jp.hash_prefix(seed, jnp.asarray(I_GRID),
                                         jnp.asarray(J_GRID)))
    np.testing.assert_array_equal(pfx.numpy(), want_pfx.astype(np.int64))
    for d in (0, 1, 7, 158):
        want = np.asarray(jp.hash_unif(seed, jnp.asarray(I_GRID),
                                       jnp.asarray(J_GRID), d))
        np.testing.assert_array_equal(tp.hash_unif_from(pfx, d).numpy(),
                                      want)
        np.testing.assert_array_equal(tp.hash_unif(seed, i, j, d).numpy(),
                                      want)


SPECS = {
    "flagship": dict(seed=3),
    "randomized": dict(curriculum=False, seed=3),
    # all eight families (stepping stones, gap, pit too) and a stairs cap
    "all_families": dict(proportions=(0.1, 0.1, 0.2, 0.1, 0.1, 0.2, 0.1, 0.1),
                         stairs_up_cap=0.12, seed=5),
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_cell_height_matches_jax(spec):
    """Every family of the curriculum grid, border cells included."""
    spec_kw = SPECS[spec]
    js, ts = jp.ProcSpec(**spec_kw), tp.ProcSpec(**spec_kw)
    rng = np.random.default_rng(4)
    R, C = js.shape
    gi = rng.integers(-5, R + 5, 20000)
    gj = rng.integers(-5, C + 5, 20000)
    want = np.asarray(jp.cell_height(js, jnp.asarray(gi), jnp.asarray(gj)))
    got = tp.cell_height(ts, torch.from_numpy(gi), torch.from_numpy(gj))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def terrains():
    spec = dict(seed=0)
    origins = np.zeros((10, 20, 3), np.float32)
    jt = jp.ProceduralTerrain(jp.ProcSpec(**spec), jnp.asarray(origins), 8.0)
    tt = tp.ProceduralTerrain(tp.ProcSpec(**spec), torch.from_numpy(origins),
                              8.0)
    rng = np.random.default_rng(5)
    # the whole curriculum grid plus the border, in envs x points layout
    x = rng.uniform(-26.0, 106.0, (64, 121)).astype(np.float32)
    y = rng.uniform(-26.0, 186.0, (64, 121)).astype(np.float32)
    return jt, tt, x, y


@pytest.mark.parametrize("query", ["height_at", "height_scan_at",
                                   "surface_at"])
def test_queries_match_jax(terrains, query):
    jt, tt, x, y = terrains
    want = getattr(jt, query)(jnp.asarray(x), jnp.asarray(y))
    got = getattr(tt, query)(torch.from_numpy(x), torch.from_numpy(y))
    if query == "surface_at":
        (wh, wn), (gh, gn) = want, got
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=1e-6,
                                   rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_parity_terrain_matches_flagship_terrain():
    """The parity tests' terrain proportions change no cell of the columns
    their 8 envs use (tests/_torch_parity.py)."""
    from _torch_parity import B, ROUGH_PATCH

    props = ROUGH_PATCH["terrain"]["terrain_proportions"]
    flag, parity = tp.ProcSpec(), tp.ProcSpec(proportions=props)
    gi = torch.arange(flag.shape[0])[:, None]
    gj = torch.arange(flag.border, flag.border + B * flag.cell_c)[None, :]
    torch.testing.assert_close(tp.cell_height(parity, gi, gj),
                               tp.cell_height(flag, gi, gj), atol=0, rtol=0)


def test_materialize_matches_jax():
    """The port's materialized grid against JAX's, on a small spec."""
    spec_kw = dict(SPECS["all_families"], num_rows=2, border=3)
    want = jp.materialize(jp.ProcSpec(**spec_kw))
    got = tp.materialize(tp.ProcSpec(**spec_kw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module", params=sorted(SPECS))
def routes(request):
    """(table route, closed-form route) of a small spec: 3 difficulty
    levels, every type column, a 1 m border."""
    spec = tp.ProcSpec(num_rows=3, border=10, **SPECS[request.param])
    origins = torch.zeros(spec.num_rows, spec.num_cols, 3)
    table = tp.ProceduralTerrain(spec, origins, 8.0, table=True)
    closed = tp.ProceduralTerrain(spec, origins, 8.0)
    assert table.table is not None and closed.table is None
    return table, closed


@pytest.mark.parametrize("query", ["height_at", "height_scan_at",
                                   "surface_at"])
def test_table_route_is_the_closed_form_bit_for_bit(routes, query):
    """Points over the whole grid and border, on the clip edges, beyond
    the grid, NaN and infinite: the same float32 bits."""
    table, closed = routes
    x, y = procedural_points(table.spec, 64, 121)
    got = getattr(table, query)(x, y)
    want = getattr(closed, query)(x, y)
    if query == "surface_at":
        assert_bits_equal(got[0], want[0])
        assert_bits_equal(got[1], want[1])
    else:
        assert_bits_equal(got, want)


def test_cpu_terrain_keeps_the_closed_form():
    cfg = TerrainCfg(num_rows=2, num_cols=3, border_size=1.0)
    terrain = tp.build_procedural(cfg, seed=0, device="cpu")
    assert terrain.table is None
    x, y = procedural_points(terrain.spec, 8, 9)
    before = profiling.counters()
    terrain.surface_at(x, y)
    terrain.height_scan_at(x, y)
    after = profiling.counters()
    assert after["terrain.points"] - before.get("terrain.points", 0) == 144
    assert (after.get("terrain.table_points", 0)
            == before.get("terrain.table_points", 0))
