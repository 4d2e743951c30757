"""Data parallelism over `torch.distributed` ranks
(pointfoot_tpu/parallel/): each rank steps its shard of the env batch on
its own device, parameters and optimizer state replicate, and the runner
and PPO reduce across ranks (mesh.py).
"""

from pointfoot_tpu_torch.parallel.mesh import (Mesh, all_gather_rows,
                                               all_reduce_mean_,
                                               all_reduce_sum_, env_sharding,
                                               init_distributed, make_mesh,
                                               replicated, shard_batch)

__all__ = ["make_mesh", "env_sharding", "replicated", "shard_batch",
           "init_distributed", "Mesh", "all_reduce_sum_", "all_reduce_mean_",
           "all_gather_rows"]
