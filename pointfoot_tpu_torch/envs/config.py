"""Environment and policy configuration (pointfoot_tpu/envs/config.py).

Frozen dataclasses, overlaid with `override` (base -> robot -> terrain
variant).  Reward scales are a tuple of (name, scale); only non-zero
entries select reward terms.  Every field that an env, training or
evaluation path of either package reads is here, with the JAX package's
name and default; the JAX dataclasses' fields that neither package reads
(legged_gym's Isaac Gym settings) are left out.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from pointfoot_tpu_torch.terrain.grid import TerrainCfg


@dataclass(frozen=True)
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 27
    num_privileged_obs: Optional[int] = 148
    num_actions: int = 6
    env_spacing: float = 3.0  # [m] origin lattice of plane terrain
    episode_length_s: float = 20.0


@dataclass(frozen=True)
class CommandsCfg:
    # command curriculum: widen lin_vel_x by 0.5 a side, up to
    # ±max_curriculum, when the episodes ending on an episode-length tick
    # tracked above 80% of the tracking reward's scale
    curriculum: bool = False
    max_curriculum: float = 1.0
    resampling_time: float = 10.0
    heading_command: bool = True  # wz recomputed from heading error
    lin_vel_x: Tuple[float, float] = (-1.0, 1.0)
    lin_vel_y: Tuple[float, float] = (-1.0, 1.0)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    heading: Tuple[float, float] = (-3.14, 3.14)
    # with this probability a resampled vx is drawn from the band
    # [0.2, low_cmd_band] of magnitudes, sign random, instead of the full
    # range (0 = the reference's uniform draw)
    low_cmd_oversample: float = 0.0
    low_cmd_band: float = 0.4


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
    # clip the weighted sum at 0 before the termination term is added
    only_positive_rewards: bool = False
    # guard band on the per-step total reward and per-term values (not
    # reference semantics; healthy per-step magnitudes are O(1))
    clip_reward: float = 20.0
    tracking_sigma: float = 0.25
    # command-relative tracking width: for v > 0 the lin-vel tracking
    # width is tracking_sigma * clip(|cmd|^2 / v^2, 0.04, 1), equally
    # selective in relative error at every command (0 = the reference's
    # fixed width)
    tracking_rel_vref: float = 0.0
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
    lin_vel: float = 0.1
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
    """Height scan grid, by default 11 x 11 points over ±0.5 m: the
    critic's privileged input (PointFoot) or the tail of the actor's
    observation (LeggedRobot family)."""

    measure_heights: bool = True
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


# ---------------- PPO / training config (rsl_rl replacement) ----------------


@dataclass(frozen=True)
class PolicyCfg:
    """legged_robot_config.py:220-228."""

    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    activation: str = "elu"
    # the recurrent variant (runner.policy_class_name
    # "ActorCriticRecurrent"): rnn_hidden_size sizes its LSTM cells.  As in
    # the JAX package it is always one LSTM cell a branch, so rnn_type and
    # rnn_num_layers are read by nothing
    rnn_type: str = ""
    rnn_hidden_size: int = 256
    rnn_num_layers: int = 1


@dataclass(frozen=True)
class AlgorithmCfg:
    """legged_robot_config.py:230-243, with the JAX package's rails."""

    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    schedule: str = "adaptive"  # adaptive KL targeting
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    # the adaptive-LR corridor: the x1.5-per-minibatch growth is capped at
    # max_lr (rsl_rl's 1e-2 let a perturbed policy be destroyed within an
    # iteration at 4096 envs) and the /1.5 shrink floored at min_lr
    max_lr: float = 1e-3
    min_lr: float = 1e-5
    # exploration-noise rails: log_std is projected into
    # [log min_noise_std, log max_noise_std] after every SGD step, so the
    # entropy bonus alone cannot inflate the noise when every advantage is 0
    max_noise_std: float = 1.5
    min_noise_std: float = 0.01
    # Winsorized KL for the adaptive-LR rule: when > 0, each sample's KL is
    # capped at this value before the mean (0 = the plain rsl_rl mean), so
    # a few rogue samples cannot rail the learning rate
    kl_winsor: float = 0.0


@dataclass(frozen=True)
class RunnerCfg:
    """legged_robot_config.py:245-258."""

    num_steps_per_env: int = 24
    max_iterations: int = 1500
    save_interval: int = 100
    experiment_name: str = "pointfoot_rough"
    run_name: str = ""
    resume: bool = False
    load_run: str = ""
    checkpoint: str = ""
    policy_class_name: str = "ActorCritic"


@dataclass(frozen=True)
class TrainCfg:
    seed: int = 1
    policy: PolicyCfg = PolicyCfg()
    algorithm: AlgorithmCfg = AlgorithmCfg()
    runner: RunnerCfg = RunnerCfg()


def override(cfg, **groups):
    """Overlay helper: override(cfg, rewards=dict(base_height_target=0.6))."""
    updates = {}
    for name, changes in groups.items():
        sub = getattr(cfg, name)
        updates[name] = (replace(sub, **changes) if isinstance(changes, dict)
                         else changes)
    return replace(cfg, **updates)
