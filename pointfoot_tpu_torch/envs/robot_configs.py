"""Task configs of the LeggedRobot-family robots: ANYmal C and B, A1,
Cassie (pointfoot_tpu/envs/robot_configs.py).

These tasks use `obs_style='legged'`: observations lead with the base
linear velocity and carry the commands before the joint state, the height
scan goes to the actor's observation, pushes set the base velocity, and the
feet_air_time and stand_still rewards take the LeggedRobot formulas.
"""

from dataclasses import replace

from pointfoot_tpu_torch.envs.config import (
    AlgorithmCfg, AssetCfg, CommandsCfg, ControlCfg, DomainRandCfg, EnvCfg,
    HeightScanCfg, InitStateCfg, LeggedEnvCfg, NoiseCfg, NormalizationCfg,
    PolicyCfg, RewardsCfg, RunnerCfg, SimCfg, TrainCfg, override,
)
from pointfoot_tpu_torch.terrain.grid import TerrainCfg

# base legged_gym reward scales
_LR_SCALES = (
    ("termination", -0.0),
    ("tracking_lin_vel", 1.0),
    ("tracking_ang_vel", 0.5),
    ("lin_vel_z", -2.0),
    ("ang_vel_xy", -0.05),
    ("orientation", -0.0),
    ("torques", -0.00001),
    ("dof_vel", -0.0),
    ("dof_acc", -2.5e-7),
    ("base_height", -0.0),
    ("feet_air_time", 1.0),
    ("collision", -1.0),
    ("feet_stumble", -0.0),
    ("action_rate", -0.01),
    ("stand_still", -0.0),
)

# LeggedRobot height-scan grid: 17 x 11 = 187 points
_LR_SCAN = HeightScanCfg(
    measure_heights=True,
    points_x=tuple(-0.8 + 0.1 * i for i in range(17)),
    points_y=tuple(-0.5 + 0.1 * i for i in range(11)),
)

_ANYMAL_JOINT_ANGLES = (
    ("LF_HAA", 0.0), ("LH_HAA", 0.0), ("RF_HAA", -0.0), ("RH_HAA", -0.0),
    ("LF_HFE", 0.4), ("LH_HFE", -0.4), ("RF_HFE", 0.4), ("RH_HFE", -0.4),
    ("LF_KFE", -0.8), ("LH_KFE", 0.8), ("RF_KFE", -0.8), ("RH_KFE", 0.8),
)

ANYMAL_C_ROUGH_CFG = LeggedEnvCfg(
    env=EnvCfg(num_envs=4096, num_observations=235, num_privileged_obs=None,
               num_actions=12),
    terrain=TerrainCfg(mesh_type="trimesh"),
    commands=CommandsCfg(),
    init_state=InitStateCfg(pos=(0.0, 0.0, 0.6),
                            default_joint_angles=_ANYMAL_JOINT_ANGLES),
    control=ControlCfg(
        stiffness=(("HAA", 80.0), ("HFE", 80.0), ("KFE", 80.0)),
        damping=(("HAA", 2.0), ("HFE", 2.0), ("KFE", 2.0)),
        action_scale=0.5, decimation=4,
        use_actuator_network=True,
    ),
    asset=AssetCfg(model_name="anymal_c", foot_name="FOOT",
                   penalize_contacts_on=("SHANK", "THIGH"),
                   terminate_after_contacts_on=("base",)),
    domain_rand=DomainRandCfg(
        friction_range=(0.5, 1.25), randomize_base_mass=True,
        added_mass_range=(-5.0, 5.0), randomize_base_com=False,
        push_interval_s=15.0),
    rewards=RewardsCfg(scales=_LR_SCALES, only_positive_rewards=True,
                       base_height_target=0.5, max_contact_force=500.0,
                       soft_dof_pos_limit=1.0, soft_dof_vel_limit=1.0,
                       soft_torque_limit=1.0),
    normalization=NormalizationCfg(),
    noise=NoiseCfg(),
    sim=SimCfg(),
    height_scan=_LR_SCAN,
    obs_style="legged",
)

ANYMAL_C_FLAT_CFG = override(
    ANYMAL_C_ROUGH_CFG,
    env=dict(num_observations=48),
    terrain=dict(mesh_type="plane", curriculum=False),
    height_scan=dict(measure_heights=False),
    commands=dict(heading_command=False, resampling_time=4.0,
                  ang_vel_yaw=(-1.5, 1.5)),
    domain_rand=dict(friction_range=(0.0, 1.5)),
    rewards=dict(
        max_contact_force=350.0,
        scales=tuple(dict(_LR_SCALES, orientation=-5.0, torques=-0.000025,
                          feet_air_time=2.0).items())),
)

ANYMAL_B_CFG = override(
    ANYMAL_C_ROUGH_CFG,
    asset=dict(model_name="anymal_b"),
    control=dict(
        stiffness=(("HAA", 80.0), ("HFE", 80.0), ("KFE", 80.0)),
        damping=(("HAA", 2.0), ("HFE", 2.0), ("KFE", 2.0)),
        use_actuator_network=False),
)

A1_CFG = LeggedEnvCfg(
    env=EnvCfg(num_envs=4096, num_observations=235, num_privileged_obs=None,
               num_actions=12),
    terrain=TerrainCfg(mesh_type="trimesh"),
    commands=CommandsCfg(),
    init_state=InitStateCfg(
        pos=(0.0, 0.0, 0.42),
        default_joint_angles=(
            ("FL_hip_joint", 0.1), ("RL_hip_joint", 0.1),
            ("FR_hip_joint", -0.1), ("RR_hip_joint", -0.1),
            ("FL_thigh_joint", 0.8), ("RL_thigh_joint", 1.0),
            ("FR_thigh_joint", 0.8), ("RR_thigh_joint", 1.0),
            ("FL_calf_joint", -1.5), ("RL_calf_joint", -1.5),
            ("FR_calf_joint", -1.5), ("RR_calf_joint", -1.5),
        )),
    control=ControlCfg(stiffness=(("joint", 20.0),),
                       damping=(("joint", 0.5),),
                       action_scale=0.25, decimation=4),
    asset=AssetCfg(model_name="a1", foot_name="foot",
                   penalize_contacts_on=("thigh", "calf"),
                   terminate_after_contacts_on=("trunk",)),
    domain_rand=DomainRandCfg(friction_range=(0.5, 1.25),
                              randomize_base_com=False,
                              push_interval_s=15.0),
    rewards=RewardsCfg(
        scales=tuple(dict(_LR_SCALES, torques=-0.0002,
                          dof_pos_limits=-10.0).items()),
        only_positive_rewards=True, base_height_target=0.25,
        soft_dof_pos_limit=0.9, max_contact_force=100.0),
    normalization=NormalizationCfg(),
    noise=NoiseCfg(),
    sim=SimCfg(),
    height_scan=_LR_SCAN,
    obs_style="legged",
)

CASSIE_CFG = LeggedEnvCfg(
    env=EnvCfg(num_envs=4096, num_observations=169, num_privileged_obs=None,
               num_actions=12),
    terrain=TerrainCfg(mesh_type="trimesh"),
    commands=CommandsCfg(),
    init_state=InitStateCfg(
        pos=(0.0, 0.0, 1.0),
        default_joint_angles=(
            ("hip_abduction_left", 0.1), ("hip_rotation_left", 0.0),
            ("hip_flexion_left", 1.0), ("thigh_joint_left", -1.8),
            ("ankle_joint_left", 1.57), ("toe_joint_left", -1.57),
            ("hip_abduction_right", -0.1), ("hip_rotation_right", 0.0),
            ("hip_flexion_right", 1.0), ("thigh_joint_right", -1.8),
            ("ankle_joint_right", 1.57), ("toe_joint_right", -1.57),
        )),
    control=ControlCfg(
        stiffness=(("hip_abduction", 100.0), ("hip_rotation", 100.0),
                   ("hip_flexion", 200.0), ("thigh_joint", 200.0),
                   ("ankle_joint", 200.0), ("toe_joint", 40.0)),
        damping=(("hip_abduction", 3.0), ("hip_rotation", 3.0),
                 ("hip_flexion", 6.0), ("thigh_joint", 6.0),
                 ("ankle_joint", 6.0), ("toe_joint", 1.0)),
        action_scale=0.5, decimation=4),
    asset=AssetCfg(model_name="cassie", foot_name="toe",
                   penalize_contacts_on=(),
                   terminate_after_contacts_on=("pelvis",)),
    domain_rand=DomainRandCfg(friction_range=(0.5, 1.25),
                              randomize_base_com=False,
                              push_interval_s=15.0),
    rewards=RewardsCfg(
        scales=tuple(dict(
            _LR_SCALES, termination=-200.0, tracking_ang_vel=1.0,
            torques=-5e-6, dof_acc=-2e-7, lin_vel_z=-0.5, feet_air_time=5.0,
            dof_pos_limits=-1.0, no_fly=0.25).items()),
        only_positive_rewards=False, soft_dof_pos_limit=0.95,
        soft_dof_vel_limit=0.9, soft_torque_limit=0.9,
        max_contact_force=300.0),
    normalization=NormalizationCfg(),
    noise=NoiseCfg(),
    sim=SimCfg(),
    # the 11 x 11 scan: 121 + 48 = 169
    height_scan=HeightScanCfg(measure_heights=True),
    obs_style="legged",
)

_LR_PPO = TrainCfg(
    policy=PolicyCfg(), algorithm=AlgorithmCfg(),
    runner=RunnerCfg(max_iterations=1500, experiment_name="legged"),
)


def _ppo(name: str, max_iterations: int = 1500,
         small: bool = False) -> TrainCfg:
    p = (PolicyCfg(actor_hidden_dims=(128, 64, 32),
                   critic_hidden_dims=(128, 64, 32)) if small
         else PolicyCfg())
    return replace(_LR_PPO, policy=p,
                   runner=replace(_LR_PPO.runner, experiment_name=name,
                                  max_iterations=max_iterations))


TASKS = {
    "anymal_c_rough": (ANYMAL_C_ROUGH_CFG, _ppo("rough_anymal_c")),
    "anymal_c_flat": (ANYMAL_C_FLAT_CFG, _ppo("flat_anymal_c", 300, True)),
    "anymal_b": (ANYMAL_B_CFG, _ppo("rough_anymal_b")),
    "a1": (A1_CFG, _ppo("rough_a1")),
    "cassie": (CASSIE_CFG, _ppo("rough_cassie")),
}
