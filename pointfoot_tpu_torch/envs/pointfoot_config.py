"""PointFoot (LimX PF_P441A) task configs, rough and flat
(pointfoot_tpu/envs/pointfoot_config.py)."""

from dataclasses import replace

from pointfoot_tpu_torch.envs.config import (
    AlgorithmCfg, AssetCfg, CommandsCfg, ControlCfg, DomainRandCfg, EnvCfg,
    HeightScanCfg, InitStateCfg, LeggedEnvCfg, NoiseCfg, NormalizationCfg,
    PolicyCfg, RewardsCfg, RunnerCfg, SimCfg, TrainCfg, override,
)
from pointfoot_tpu_torch.terrain.grid import TerrainCfg

_JOINTS = ("abad_L_Joint", "hip_L_Joint", "knee_L_Joint",
           "abad_R_Joint", "hip_R_Joint", "knee_R_Joint")

_ROUGH_SCALES = (
    ("action_rate", -0.01),
    ("ang_vel_xy", -0.05),
    ("base_height", -10.0),
    ("collision", -50.0),
    ("dof_acc", -2.5e-07),
    ("dof_pos_limits", -0.0),
    ("dof_vel", -0.0),
    ("feet_air_time", 60.0),
    ("feet_contact_forces", -0.01),
    ("feet_stumble", -0.0),
    ("lin_vel_z", -0.5),
    ("no_fly", 1.0),
    ("orientation", -5.0),
    ("stand_still", -1.0),
    ("termination", -0.0),
    ("torque_limits", -0.1),
    ("torques", -2.5e-05),
    ("tracking_ang_vel", 5.0),
    ("tracking_lin_vel", 10.0),
    ("unbalance_feet_air_time", -300.0),
    ("unbalance_feet_height", -60.0),
    ("feet_distance", -100.0),
    ("survival", 100.0),
)

POINTFOOT_ROUGH_CFG = LeggedEnvCfg(
    env=EnvCfg(
        num_envs=4096, num_observations=27, num_privileged_obs=148,
        num_actions=6, episode_length_s=20.0,
    ),
    terrain=TerrainCfg(
        mesh_type="trimesh", horizontal_scale=0.1, border_size=25.0,
        curriculum=True, static_friction=0.4, max_init_terrain_level=5,
        terrain_length=8.0, terrain_width=8.0, num_rows=10, num_cols=20,
        terrain_proportions=(0.1, 0.1, 0.35, 0.25, 0.2),
    ),
    commands=CommandsCfg(
        curriculum=False, resampling_time=10.0, heading_command=True,
        lin_vel_x=(-1.0, 1.0), lin_vel_y=(-0.2, 0.2), ang_vel_yaw=(-1.0, 1.0),
        heading=(-3.14, 3.14),
    ),
    init_state=InitStateCfg(
        pos=(0.0, 0.0, 0.62),
        default_joint_angles=tuple((j, 0.0) for j in _JOINTS),
    ),
    control=ControlCfg(
        control_type="P",
        stiffness=tuple((j, 40.0) for j in _JOINTS),
        damping=tuple((j, 1.5) for j in _JOINTS),
        action_scale=0.5, decimation=4,
    ),
    asset=AssetCfg(
        model_name="pointfoot", foot_name="foot",
        penalize_contacts_on=("base", "abad", "hip", "knee"),
        terminate_after_contacts_on=("abad", "base"),
    ),
    domain_rand=DomainRandCfg(
        randomize_friction=True, friction_range=(0.0, 1.6),
        randomize_base_mass=True, added_mass_range=(-1.0, 2.0),
        randomize_base_com=True, rand_com_vec=(0.03, 0.02, 0.03),
        push_robots=True, push_interval_s=7.0, max_push_vel_xy=1.0,
    ),
    rewards=RewardsCfg(
        scales=_ROUGH_SCALES, base_height_target=0.62,
        soft_dof_pos_limit=0.95, soft_dof_vel_limit=0.9, soft_torque_limit=0.8,
        max_contact_force=200.0, min_feet_distance=0.1,
        min_feet_air_time=0.25, max_feet_air_time=0.65, tracking_sigma=0.25,
    ),
    normalization=NormalizationCfg(),
    noise=NoiseCfg(),
    sim=SimCfg(dt=0.005),
    height_scan=HeightScanCfg(),
    obs_style="pointfoot",
)

# the flat variant: plane terrain, no height scan, no heading command
POINTFOOT_FLAT_CFG = override(
    POINTFOOT_ROUGH_CFG,
    env=dict(num_privileged_obs=27),
    terrain=dict(mesh_type="plane", curriculum=False),
    height_scan=dict(measure_heights=False),
    commands=dict(heading_command=False, resampling_time=4.0,
                  ang_vel_yaw=(-1.5, 1.5)),
    domain_rand=dict(friction_range=(0.0, 1.5)),
    rewards=dict(
        max_contact_force=350.0,
        scales=tuple(
            dict(_ROUGH_SCALES, feet_air_time=5.0,
                 unbalance_feet_air_time=1.0).items()),
    ),
)

POINTFOOT_ROUGH_PPO = TrainCfg(
    seed=1,
    policy=PolicyCfg(init_noise_std=1.0,
                     actor_hidden_dims=(512, 256, 128),
                     critic_hidden_dims=(512, 256, 128),
                     activation="elu"),
    algorithm=AlgorithmCfg(),
    runner=RunnerCfg(num_steps_per_env=24, max_iterations=100000,
                     save_interval=100, experiment_name="pointfoot_rough"),
)

POINTFOOT_FLAT_PPO = replace(
    POINTFOOT_ROUGH_PPO,
    policy=replace(POINTFOOT_ROUGH_PPO.policy,
                   actor_hidden_dims=(128, 64, 32),
                   critic_hidden_dims=(128, 64, 32)),
    runner=replace(POINTFOOT_ROUGH_PPO.runner,
                   experiment_name="pointfoot_flat", max_iterations=30000),
)
