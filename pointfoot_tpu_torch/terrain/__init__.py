"""Terrain: heightfield generators, the curriculum grid, procedural and
analytic terrain (pointfoot_tpu/terrain/)."""

from pointfoot_tpu_torch.terrain.grid import (TerrainCfg, TerrainGrid,
                                              build_terrain)
from pointfoot_tpu_torch.terrain.heightfield import (discrete_obstacles, gap,
                                                     pit, pyramid_sloped,
                                                     pyramid_stairs,
                                                     random_uniform,
                                                     stepping_stones)

__all__ = [
    "pyramid_sloped", "random_uniform", "pyramid_stairs",
    "discrete_obstacles", "stepping_stones", "gap", "pit", "TerrainGrid",
    "TerrainCfg", "build_terrain",
]
