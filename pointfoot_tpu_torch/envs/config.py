"""Environment and policy configuration (pointfoot_tpu/envs/config.py).

Frozen dataclasses, overlaid with `override` (base -> robot -> terrain
variant).  Reward scales are a tuple of (name, scale); only non-zero
entries select reward terms.  Only the fields the ported slice reads are
here; the JAX package's other knobs (command curriculum, low-command
oversampling, alternative promotion/demotion rules, relative tracking
width, ...) arrive with the slices that implement them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from pointfoot_tpu_torch.terrain.procedural import TerrainCfg


@dataclass(frozen=True)
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 27
    num_privileged_obs: Optional[int] = 148
    num_actions: int = 6
    episode_length_s: float = 20.0


@dataclass(frozen=True)
class CommandsCfg:
    resampling_time: float = 10.0
    heading_command: bool = True  # wz recomputed from heading error
    lin_vel_x: Tuple[float, float] = (-1.0, 1.0)
    lin_vel_y: Tuple[float, float] = (-1.0, 1.0)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    heading: Tuple[float, float] = (-3.14, 3.14)


@dataclass(frozen=True)
class InitStateCfg:
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.68)
    rot: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    default_joint_angles: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class ControlCfg:
    control_type: str = "P"  # 'P' position, 'V' velocity, 'T' torque
    stiffness: Tuple[Tuple[str, float], ...] = ()  # per joint-name substring
    damping: Tuple[Tuple[str, float], ...] = ()
    action_scale: float = 0.5
    decimation: int = 4
    use_actuator_network: bool = False


@dataclass(frozen=True)
class AssetCfg:
    model_name: str = "pointfoot"
    foot_name: str = "foot"
    penalize_contacts_on: Tuple[str, ...] = ("base", "abad", "hip", "knee")
    terminate_after_contacts_on: Tuple[str, ...] = ("abad", "base")


@dataclass(frozen=True)
class DomainRandCfg:
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.2, 1.6)
    num_friction_buckets: int = 64
    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (-1.0, 2.0)
    randomize_base_com: bool = True
    rand_com_vec: Tuple[float, float, float] = (0.03, 0.02, 0.03)
    push_robots: bool = True
    push_interval_s: float = 7.0
    max_push_vel_xy: float = 0.6


@dataclass(frozen=True)
class RewardsCfg:
    scales: Tuple[Tuple[str, float], ...] = ()
    # guard band on the per-step total reward and per-term values (not
    # reference semantics; healthy per-step magnitudes are O(1))
    clip_reward: float = 20.0
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 0.97
    soft_dof_vel_limit: float = 0.9
    soft_torque_limit: float = 0.8
    base_height_target: float = 0.62
    max_contact_force: float = 200.0
    clearance_height_target: float = -0.2
    min_feet_distance: float = 0.1
    min_feet_air_time: float = 0.25
    max_feet_air_time: float = 0.65


@dataclass(frozen=True)
class NormalizationCfg:
    lin_vel_scale: float = 2.0
    ang_vel_scale: float = 0.25
    dof_pos_scale: float = 1.0
    dof_vel_scale: float = 0.05
    height_meas_scale: float = 5.0
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclass(frozen=True)
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    ang_vel: float = 0.2
    gravity: float = 0.05
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    height_measurements: float = 0.1


@dataclass(frozen=True)
class SimCfg:
    dt: float = 0.005
    gravity: float = 9.81
    contact_stiffness: float = 1.2e4
    contact_damping: float = 1.2e3


@dataclass(frozen=True)
class HeightScanCfg:
    """Critic-only height scan grid: 11 x 11 points over ±0.5 m."""

    points_x: Tuple[float, ...] = tuple(-0.5 + 0.1 * i for i in range(11))
    points_y: Tuple[float, ...] = tuple(-0.5 + 0.1 * i for i in range(11))


@dataclass(frozen=True)
class LeggedEnvCfg:
    env: EnvCfg = EnvCfg()
    terrain: TerrainCfg = TerrainCfg()
    commands: CommandsCfg = CommandsCfg()
    init_state: InitStateCfg = InitStateCfg()
    control: ControlCfg = ControlCfg()
    asset: AssetCfg = AssetCfg()
    domain_rand: DomainRandCfg = DomainRandCfg()
    rewards: RewardsCfg = RewardsCfg()
    normalization: NormalizationCfg = NormalizationCfg()
    noise: NoiseCfg = NoiseCfg()
    sim: SimCfg = SimCfg()
    height_scan: HeightScanCfg = HeightScanCfg()
    # which env family implements obs/reward semantics ('pointfoot'|'legged')
    obs_style: str = "pointfoot"

    @property
    def dt(self) -> float:
        """Policy dt = decimation * sim dt."""
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        return int(self.env.episode_length_s / self.dt + 0.5)


@dataclass(frozen=True)
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    activation: str = "elu"


@dataclass(frozen=True)
class TrainCfg:
    """The policy half of the training config; the PPO algorithm and
    runner settings come with the training slice of the port."""

    seed: int = 1
    policy: PolicyCfg = PolicyCfg()


def override(cfg, **groups):
    """Overlay helper: override(cfg, rewards=dict(base_height_target=0.6))."""
    updates = {}
    for name, changes in groups.items():
        sub = getattr(cfg, name)
        updates[name] = (replace(sub, **changes) if isinstance(changes, dict)
                         else changes)
    return replace(cfg, **updates)
