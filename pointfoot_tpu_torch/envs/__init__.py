"""Vectorized environments and task configs (pointfoot_tpu/envs/)."""

from pointfoot_tpu_torch.envs.config import LeggedEnvCfg, TrainCfg, override
from pointfoot_tpu_torch.envs.legged_env import EnvState, LeggedEnv, StepOutput

__all__ = ["LeggedEnvCfg", "TrainCfg", "override", "EnvState", "LeggedEnv",
           "StepOutput"]
