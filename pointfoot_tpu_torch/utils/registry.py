"""Task registry: name -> (env cfg, train cfg)
(pointfoot_tpu/utils/registry.py)."""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Tuple

from pointfoot_tpu_torch.envs import pointfoot_config as pf
from pointfoot_tpu_torch.envs.config import LeggedEnvCfg, TrainCfg, override
from pointfoot_tpu_torch.envs.legged_env import LeggedEnv

TASKS: Dict[str, Tuple[LeggedEnvCfg, TrainCfg]] = {
    "pointfoot_rough": (pf.POINTFOOT_ROUGH_CFG, pf.POINTFOOT_ROUGH_PPO),
}


def get_cfgs(name: str) -> Tuple[LeggedEnvCfg, TrainCfg]:
    if name not in TASKS:
        raise KeyError(f"Task '{name}' not registered. "
                       f"Available: {sorted(TASKS)}")
    return TASKS[name]


def make_env(name: str, num_envs: Optional[int] = None, device=None,
             cfg_patch: Optional[dict] = None) -> LeggedEnv:
    """Build the env on `device` (CUDA unless given).  `cfg_patch` is a
    nested {group: {field: value}} overlay applied through
    `config.override`."""
    env_cfg, _ = get_cfgs(name)
    if num_envs is not None:
        env_cfg = replace(env_cfg, env=replace(env_cfg.env,
                                               num_envs=num_envs))
    if cfg_patch:
        env_cfg = override(env_cfg, **cfg_patch)
    return LeggedEnv(env_cfg, device=device)
