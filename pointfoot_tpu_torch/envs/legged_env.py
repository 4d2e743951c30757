"""Vectorized legged-robot environment (pointfoot_tpu/envs/legged_env.py).

PointFoot and LeggedRobot observation styles on plane, table
(terrain/grid.py) or procedural (terrain/procedural.py) terrain.  `step`
is a state transition over dataclasses of tensors; resets, curricula,
command resampling and pushes are masked updates, so a step never waits on
the host.  Random draws come from the env's `torch.Generator`, seeded by
`init_state`; they cannot reproduce the JAX package's threefry streams, so
parity tests start both from one JAX-made state and compare deterministic
stretches.

The decimation loop takes one of two paths, as the JAX env does
(pointfoot_tpu/envs/legged_env.py:442-499): the fused rollout
(ops/cuda/substep.rollout_substeps) for PD control at MEGA_MIN_BATCH envs or
more, else the scan path, a loop of physics/dynamics.step_batched substeps
with the torque of the PD law or of the actuator network.  Either runs the
CUDA kernels on the card and their plain versions on the CPU.  On plane
terrain the physics sees flat ground at z = 0 (no surface query; the fused
rollout runs without surface rows), there is no height scan, and the env
origins lie on a square lattice: with as many levels as types, level and
type come from one formula, so the origins fall on the lattice's diagonal,
as in the JAX env (envs do not interact, so the physics is unaffected).

On one card `step` replays its body as one CUDA graph (envs/step_graph.py):
the same kernels, ~1000 host dispatches fewer a step.  Everything the body
does on the card is therefore capturable: constants and index sets live on
the device, made once, and no value is read back to the host.

For data-parallel training (parallel/mesh.py) the runner sets `shard_mesh`:
the env then steps one rank's shard of `global_num_envs` (`num_envs` is
the shard's size, checked across ranks once, when the mesh is attached),
gates the fused rollout on the shard's width, and the command curriculum
judges the episodes of all ranks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pointfoot_tpu_torch.device import const, resolve_device
from pointfoot_tpu_torch.envs import step_graph
from pointfoot_tpu_torch.envs.config import LeggedEnvCfg
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.ops.cuda.substep import rollout_substeps
from pointfoot_tpu_torch.parallel.mesh import (all_gather_rows,
                                               all_reduce_sum_, env_sharding,
                                               rank_seed, same_rows,
                                               shard_batch)
from pointfoot_tpu_torch.physics import actuator as act
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain.grid import build_terrain, flat_grid
from pointfoot_tpu_torch.terrain.procedural import build_procedural
from pointfoot_tpu_torch.utils import profiling

GRAVITY_VEC = (0.0, 0.0, -1.0)
# the phases of `step` after the physics, which `_ablate` can replace by
# zeros (bench --mode env_phases); `step` runs in the span `env.step`,
# its physics in `env.physics` and each phase in `env.<phase>`
PHASES = ("reward", "obs", "heights", "reset", "commands", "push")
STEP_PHASES = ("physics",) + PHASES


def phase_ms_per_step(row: dict) -> Dict[str, float]:
    """Each phase's self milliseconds a step in a row of utils/profiling
    (its own time: the terrain queries inside it count under `terrain.*`);
    {} where the row holds no env step, or steps whose phases ran in no
    span (a CUDA graph's replays, envs/step_graph.py)."""
    spans = row["spans"]
    steps = spans.get("env.step", {}).get("count", 0)
    if not steps or not any(f"env.{p}" in spans for p in STEP_PHASES):
        return {}
    out = {}
    for p in STEP_PHASES:
        s = spans.get(f"env.{p}")
        out[p] = s["self_s"] / steps * 1e3 if s else 0.0
    return out


@dataclass(frozen=True)
class EnvState:
    """Batched environment state (leading dim = num_envs)."""

    physics: PhysicsState
    params: PhysicsParams  # per-env domain-randomized physics parameters
    episode_step: torch.Tensor  # (B,) int64
    common_step: torch.Tensor  # () int64 global counter
    actions: torch.Tensor  # (B, na) current clipped actions
    last_actions: torch.Tensor  # (B, na)
    last_qvel: torch.Tensor  # (B, nj)
    torques: torch.Tensor  # (B, nj) last applied torques
    commands: torch.Tensor  # (B, 4) vx, vy, wz, heading
    cmd_pinned: torch.Tensor  # (B,) bool: commands pinned from outside
    lin_vel_x_range: torch.Tensor  # (2,) vx command range
    terrain_level: torch.Tensor  # (B,) int64
    terrain_type: torch.Tensor  # (B,) int64
    env_origin: torch.Tensor  # (B, 3)
    feet_air_time: torch.Tensor  # (B, nf)
    last_feet_air_time: torch.Tensor  # (B, nf)
    current_max_feet_height: torch.Tensor  # (B, nf)
    last_max_feet_height: torch.Tensor  # (B, nf)
    last_contacts: torch.Tensor  # (B, nf) bool
    push_force: torch.Tensor  # (B, 3) world force queued for next substep 0
    # (B, nj, LAYERS, 2, HIDDEN) actuator-network state, (B, 0) without one
    actuator_carry: torch.Tensor
    episode_sums: torch.Tensor  # (B, n_terms)
    terminate: torch.Tensor  # (B,) bool: contact (or NaN) termination
    time_out: torch.Tensor  # (B,) bool
    # (B,) integral of base velocity along the yaw-rotated command: the
    # terrain-curriculum demotion credit (equals displacement for straight
    # commands and arc length for turns)
    cmd_progress: torch.Tensor

    # the fields that are not per env: every rank of a data-parallel run
    # holds them whole
    REPLICATED = ("common_step", "lin_vel_x_range")

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class StepOutput(NamedTuple):
    obs: torch.Tensor  # (B, num_obs)
    privileged_obs: Optional[torch.Tensor]  # (B, num_priv) or None
    reward: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) bool
    extras: Dict[str, torch.Tensor]


class LeggedEnv:
    """Static environment definition: config, model, terrain, generator."""

    def __init__(self, cfg: LeggedEnvCfg, device=None):
        self.device = resolve_device(device)
        if cfg.obs_style not in ("pointfoot", "legged"):
            raise ValueError(f"unknown obs_style '{cfg.obs_style}'")
        self.cfg = cfg
        # phase ablation for throughput profiling only (bench.py --mode
        # env_phases): names of the post-physics phases ("heights",
        # "commands", "push", "reward", "reset", "obs") whose work `step`
        # skips, putting zeros of the right shape in its place.  Empty (the
        # default, and the only value for training and evaluation) leaves
        # `step` exact.  The zeros are built from shapes alone: eager torch
        # would otherwise still pay for the phase.
        self._ablate: frozenset = frozenset()
        dev = self.device
        self.model = get_model(cfg.asset.model_name).to(dev)
        m = self.model
        self.global_num_envs = cfg.env.num_envs
        self._shard_mesh = None
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_actions = cfg.env.num_actions
        self.dt = cfg.dt
        self.max_episode_length = cfg.max_episode_length
        self.max_episode_length_s = cfg.env.episode_length_s
        self.generator = torch.Generator(device=dev)
        # `step`'s CUDA graphs by `step_graph.graph_key`, on one card
        self._graphs: Dict[tuple, step_graph.StepGraph] = {}

        self.is_plane = cfg.terrain.mesh_type == "plane"
        if self.is_plane:
            side = int(np.ceil(np.sqrt(self.global_num_envs)))
            self.terrain = flat_grid(
                size=max(2 * side * cfg.env.env_spacing + 20, 60),
                num_levels=side, num_types=side,
                spacing=cfg.env.env_spacing, device=dev)
        elif cfg.terrain.procedural:
            self.terrain = build_procedural(cfg.terrain, seed=0, device=dev)
        else:
            self.terrain = build_terrain(cfg.terrain, seed=0, device=dev)
        self.height_fn = self._height_fn()

        # per-joint static arrays from name-keyed config pairs
        def by_name(pairs, default=0.0):
            out = np.full(m.nj, default, np.float32)
            for i, jn in enumerate(m.joint_names):
                for key, val in pairs:
                    if key in jn:
                        out[i] = val
                        break
            return out

        dq = by_name(cfg.init_state.default_joint_angles)
        self.default_qpos_values = tuple(float(v) for v in dq)
        self.default_qpos = torch.from_numpy(dq).to(dev)
        self.kp = torch.from_numpy(by_name(cfg.control.stiffness)).to(dev)
        self.kd = torch.from_numpy(by_name(cfg.control.damping)).to(dev)
        self.torque_limit = m.effort_limit
        self.qvel_limit = m.velocity_limit

        # collision-sphere index sets by link name
        self.feet_idx = m.collision_indices(cfg.asset.foot_name)
        term = []
        for s in cfg.asset.terminate_after_contacts_on:
            term += list(m.collision_indices(s))
        self.termination_idx = tuple(sorted(set(term)))
        pen = []
        for s in cfg.asset.penalize_contacts_on:
            pen += list(m.collision_indices(s))
        # penalized excludes feet (they legitimately touch the ground)
        self.penalized_idx = tuple(sorted(set(pen) - set(self.feet_idx)))
        self.nf = len(self.feet_idx)
        # the same sets as index tensors on the device: indexing by a list
        # copies it to the card and waits, which a CUDA graph cannot capture
        self.feet_index, self.termination_index, self.penalized_index = (
            torch.tensor(ix, dtype=torch.int64, device=dev)
            for ix in (self.feet_idx, self.termination_idx,
                       self.penalized_idx))
        if not self.feet_idx:
            raise ValueError(f"no feet matched '{cfg.asset.foot_name}' in "
                             f"{m.collision_names}")
        if not self.termination_idx:
            raise ValueError(
                f"no termination bodies matched "
                f"{cfg.asset.terminate_after_contacts_on} in "
                f"{m.collision_names}")

        # height-scan grid (base frame, yaw-rotated at query time)
        hx = np.asarray(cfg.height_scan.points_x, np.float32)
        hy = np.asarray(cfg.height_scan.points_y, np.float32)
        gx, gy = np.meshgrid(hx, hy, indexing="ij")
        self.height_points = torch.from_numpy(np.stack(
            [gx.ravel(), gy.ravel(), np.zeros_like(gx.ravel())], -1)).to(dev)
        self.num_height_points = self.height_points.shape[0]
        self.measure_heights = (cfg.height_scan.measure_heights
                                and not self.is_plane)

        # reward table: (name, scale * dt)
        scales = dict(cfg.rewards.scales)
        self.termination_scale = scales.pop("termination", 0.0)
        self.reward_terms = tuple(
            (name, scale * self.dt) for name, scale in scales.items()
            if scale != 0.0)
        self.reward_names = tuple(n for n, _ in self.reward_terms) + (
            ("termination",) if self.termination_scale else ())

        self.use_actuator_net = cfg.control.use_actuator_network
        if self.use_actuator_net:
            self.actuator_weights = act.load_anydrive_weights(dev)
        self.push_interval = int(np.ceil(
            cfg.domain_rand.push_interval_s / self.dt))
        self.resample_interval = int(cfg.commands.resampling_time / self.dt)
        self.cmd_scale = torch.tensor([
            cfg.normalization.lin_vel_scale,
            cfg.normalization.lin_vel_scale,
            cfg.normalization.ang_vel_scale,
        ], device=dev)

        # noise magnitudes aligned to the actual obs layout
        self.noise_vec = torch.from_numpy(self._build_noise_vec()).to(dev)
        nhp = self.num_height_points
        self.priv_noise_vec = (
            torch.full((nhp,), cfg.noise.height_measurements
                       * cfg.noise.noise_level
                       * cfg.normalization.height_meas_scale, device=dev)
            if (self.num_privileged_obs or 0) > self.num_obs else None)

    # ------------------------------------------------------- data parallelism

    @property
    def shard_mesh(self):
        """The data-parallel mesh (parallel/mesh.py) whose rank's shard of
        the `global_num_envs` envs this env steps, or None.  Set by the
        runner; raises when the global batch does not divide, or (a
        collective) when the ranks' shards differ in size."""
        return self._shard_mesh

    @shard_mesh.setter
    def shard_mesh(self, mesh) -> None:
        if mesh is not None:
            env_sharding(mesh, self.global_num_envs)
            same_rows(mesh, self.global_num_envs // mesh.world_size)
        self._shard_mesh = mesh

    @property
    def num_envs(self) -> int:
        """The envs this process steps: all of them, or its rank's
        shard."""
        mesh = self._shard_mesh
        return (self.global_num_envs if mesh is None
                else self.global_num_envs // mesh.world_size)

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (global_num_envs, ...) tensor; the tensor
        itself without a mesh."""
        mesh = self._shard_mesh
        return x if mesh is None else x[env_sharding(mesh,
                                                     self.global_num_envs)]

    def shard_state(self, state: EnvState) -> EnvState:
        """This rank's rows of a state of the global batch."""
        return shard_batch(state, self._shard_mesh,
                           batch=self.global_num_envs,
                           replicate=EnvState.REPLICATED)

    def gather_state(self, state: EnvState) -> EnvState:
        """The state of the global batch from every rank's rows (a
        collective); the state itself without a mesh."""
        return all_gather_rows(state, self._shard_mesh,
                               batch=self.num_envs,
                               replicate=EnvState.REPLICATED)

    # ------------------------------------------------------------------ init

    def _build_noise_vec(self) -> np.ndarray:
        """Noise magnitudes aligned to the observation layout of the style
        (`_compute_observations`)."""
        n = self.cfg.noise
        s = self.cfg.normalization
        nj, na = self.model.nj, self.num_actions
        legged = self.cfg.obs_style == "legged"
        parts = []
        if legged:
            parts.append(np.full(3, n.lin_vel * n.noise_level
                                 * s.lin_vel_scale))
        parts += [
            np.full(3, n.ang_vel * n.noise_level * s.ang_vel_scale),
            np.full(3, n.gravity * n.noise_level),
        ]
        if legged:
            parts.append(np.zeros(3))  # commands
        parts += [
            np.full(nj, n.dof_pos * n.noise_level * s.dof_pos_scale),
            np.full(nj, n.dof_vel * n.noise_level * s.dof_vel_scale),
            np.zeros(na),  # previous actions
        ]
        if not legged:
            parts.append(np.zeros(3))  # commands last (PointFoot layout)
        vec = np.concatenate(parts).astype(np.float32)
        if legged and self.measure_heights and self.num_obs > len(vec):
            vec = np.concatenate([vec, np.full(
                self.num_height_points,
                n.height_measurements * n.noise_level * s.height_meas_scale,
                np.float32)])
        return vec[: self.num_obs]

    def _uniform(self, shape, lo, hi) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return lo + (hi - lo) * u

    def _randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=self.generator,
                             device=self.device)

    def _sample_params(self, B: int) -> PhysicsParams:
        """Domain randomization at init of B envs: friction buckets, added
        base mass, base CoM shift."""
        cfg = self.cfg.domain_rand
        nc = len(self.model.collision_body)
        if cfg.randomize_friction:
            buckets = self._uniform((cfg.num_friction_buckets,),
                                    *cfg.friction_range)
            ids = self._randint((B,), 0, cfg.num_friction_buckets)
            friction = buckets[ids][:, None].expand(B, nc).contiguous()
        else:
            friction = torch.full((B, nc), self.cfg.terrain.static_friction,
                                  device=self.device)
        added_mass = (self._uniform((B,), *cfg.added_mass_range)
                      if cfg.randomize_base_mass
                      else torch.zeros(B, device=self.device))
        com = (self._uniform((B, 3), -1.0, 1.0)
               * torch.tensor(cfg.rand_com_vec, device=self.device)
               if cfg.randomize_base_com
               else torch.zeros(B, 3, device=self.device))
        nominal = PhysicsParams.nominal(
            self.model, B, self.device,
            contact_stiffness=self.cfg.sim.contact_stiffness,
            contact_damping=self.cfg.sim.contact_damping)
        return dataclasses.replace(
            nominal, friction=friction, added_mass=added_mass, com_offset=com,
            kp=self.kp.expand(B, self.model.nj).clone(),
            kd=self.kd.expand(B, self.model.nj).clone())

    def init_state(self, seed: int = 0,
                   random_episode_step: bool = False) -> EnvState:
        """Fresh state: domain randomization, terrain cells, first reset of
        every env, and with `random_episode_step` episode steps drawn in
        [0, max_episode_length).  Seeds the env's generator.

        With a shard mesh every rank draws the state of the global batch
        from `seed`, as one process would, and keeps its rows (the JAX
        runner's init, then `shard_batch`); the generator then goes on
        from a seed of the rank's own."""
        self.generator.manual_seed(seed)
        B = self.global_num_envs
        m = self.model
        dev = self.device
        params = self._sample_params(B)
        max_init = min(self.cfg.terrain.max_init_terrain_level,
                       self.terrain.num_levels - 1)
        if self.cfg.terrain.curriculum and not self.is_plane:
            level = self._randint((B,), 0, max_init + 1)
        else:
            level = (torch.arange(B, device=dev)
                     // max(B // self.terrain.num_levels, 1)
                     ) % self.terrain.num_levels
        ttype = (torch.arange(B, device=dev)
                 // max(B // self.terrain.num_types, 1)
                 ) % self.terrain.num_types
        origin = self.terrain.env_origins[level, ttype]

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        nc = len(m.collision_body)
        physics = PhysicsState(
            base_pos=origin + torch.tensor(self.cfg.init_state.pos,
                                           device=dev),
            base_quat=torch.tensor(self.cfg.init_state.rot, device=dev
                                   ).expand(B, 4).clone(),
            base_lin_vel=zeros(B, 3), base_ang_vel=zeros(B, 3),
            qpos=self.default_qpos.expand(B, m.nj).clone(),
            qvel=zeros(B, m.nj), contact_force=zeros(B, nc, 3),
        )
        state = EnvState(
            physics=physics, params=params,
            episode_step=zeros(B, dtype=torch.int64),
            common_step=zeros(dtype=torch.int64),
            actions=zeros(B, self.num_actions),
            last_actions=zeros(B, self.num_actions),
            last_qvel=zeros(B, m.nj), torques=zeros(B, m.nj),
            commands=zeros(B, 4), cmd_pinned=zeros(B, dtype=torch.bool),
            lin_vel_x_range=torch.tensor(self.cfg.commands.lin_vel_x,
                                         dtype=torch.float32, device=dev),
            terrain_level=level, terrain_type=ttype, env_origin=origin,
            feet_air_time=zeros(B, self.nf),
            last_feet_air_time=zeros(B, self.nf),
            current_max_feet_height=zeros(B, self.nf),
            last_max_feet_height=zeros(B, self.nf),
            last_contacts=zeros(B, self.nf, dtype=torch.bool),
            push_force=zeros(B, 3),
            actuator_carry=(act.init_carry((B, m.nj), dev)
                            if self.use_actuator_net else zeros(B, 0)),
            episode_sums=zeros(B, len(self.reward_names)),
            terminate=zeros(B, dtype=torch.bool),
            time_out=zeros(B, dtype=torch.bool),
            cmd_progress=zeros(B),
        )
        state = self._reset_envs(state, torch.ones(B, dtype=torch.bool,
                                                   device=dev))
        if random_episode_step:
            state = state.replace(episode_step=self._randint(
                (B,), 0, self.max_episode_length))
        if self.num_envs < B:
            state = self.shard_state(state)
            self.generator.manual_seed(rank_seed(seed,
                                                      self._shard_mesh.rank))
        return state

    # ------------------------------------------------------------- internals

    def _height_fn(self):
        """The terrain as the physics reads it: a height function with
        `is_flat` and a `surface_fn` (height and unit normal) attached; on
        plane terrain the surface is z = 0 with normal (0, 0, 1)."""
        terrain = self.terrain

        def height(x, y):
            return terrain.height_at(x, y)

        height.is_flat = self.is_plane
        if self.is_plane:
            def surface(x, y):
                profiling.count("terrain.points", x.numel())
                with profiling.span("terrain.surface"):
                    n = torch.zeros(x.shape + (3,), dtype=x.dtype,
                                    device=x.device)
                    n[..., 2] = 1.0
                    return torch.zeros_like(x), n

            height.surface_fn = surface
        else:
            height.surface_fn = terrain.surface_at
        return height

    def _compute_torques(self, actions, qpos, qvel, last_qvel, params):
        """PD torque law (P, V or T), clipped to the effort limits."""
        c = self.cfg.control
        scaled = actions * c.action_scale
        if c.control_type == "P":
            tau = params.kp * (scaled + self.default_qpos - qpos) \
                - params.kd * qvel
        elif c.control_type == "V":
            tau = params.kp * (scaled - qvel) - params.kd * (
                qvel - last_qvel) / self.cfg.sim.dt
        elif c.control_type == "T":
            tau = scaled
        else:
            raise NameError(f"Unknown controller type: {c.control_type}")
        return torch.clamp(tau, -self.torque_limit, self.torque_limit)

    def _physics_rollout(self, state: EnvState, actions: torch.Tensor):
        """Decimation loop: torques recomputed each substep, the queued push
        applied on substep 0 only.  Returns (physics, last torques,
        actuator carry, sphere positions of the final state or None).

        PD control takes the fused rollout on this process's rows where
        they are wide enough for the kernels, as in JAX
        (pointfoot_tpu/envs/legged_env.py:442-472): MEGA_MIN_BATCH envs or
        more, of one process or of a rank's shard.  Otherwise the scan
        path runs on the same rows, where each tick of the actuator network
        runs in the span `actuator.torque` and adds the joint rows it takes
        (envs x nj) to the counter `actuator.rows`."""
        c = self.cfg.control
        sim_dt = self.cfg.sim.dt
        if (not self.use_actuator_net
                and self.num_envs >= dynamics.MEGA_MIN_BATCH):
            phys, tau, sphere_pos = rollout_substeps(
                self.model, state.params, state.physics, actions,
                state.last_qvel, state.push_force, self.height_fn, sim_dt,
                c.decimation, self.default_qpos_values, c.action_scale,
                c.control_type, gravity=self.cfg.sim.gravity)
            return phys, tau, state.actuator_carry, sphere_pos

        # the scan path: one step_batched per substep
        phys, last_qvel = state.physics, state.last_qvel
        act_carry = state.actuator_carry
        no_push = torch.zeros_like(state.push_force)
        for i in range(c.decimation):
            if self.use_actuator_net:
                pos_err = (actions * c.action_scale + self.default_qpos
                           - phys.qpos)
                profiling.count("actuator.rows", pos_err.numel())
                with profiling.span("actuator.torque"):
                    tau, act_carry = act.actuator_net_torque(
                        self.actuator_weights, act_carry, pos_err, phys.qvel)
                    tau = torch.clamp(tau, -self.torque_limit,
                                      self.torque_limit)
            else:
                tau = self._compute_torques(actions, phys.qpos, phys.qvel,
                                            last_qvel, state.params)
            new_phys = dynamics.step_batched(
                self.model, state.params, phys, tau, self.height_fn, sim_dt,
                external_force=state.push_force if i == 0 else no_push,
                gravity=self.cfg.sim.gravity)
            phys, last_qvel = new_phys, phys.qvel
        return phys, tau, act_carry, None

    def _base_frame_quantities(self, phys: PhysicsState):
        q = phys.base_quat
        base_lin_vel = quat_ops.rotate_inverse(q, phys.base_lin_vel)
        base_ang_vel = quat_ops.rotate_inverse(q, phys.base_ang_vel)
        proj_grav = quat_ops.rotate_inverse(
            q, const(GRAVITY_VEC, q).expand(phys.base_pos.shape))
        return base_lin_vel, base_ang_vel, proj_grav

    def _foot_positions(self, phys: PhysicsState, params) -> torch.Tensor:
        """(B, nf, 3) world foot-sphere centers by forward kinematics."""
        m = self.model
        kin = dynamics.forward_kinematics(m, phys, params)
        return torch.stack([
            kin.body_pos[:, m.collision_body[c]]
            + kin.body_rot[:, m.collision_body[c]] @ m.collision_offset[c]
            for c in self.feet_idx], dim=1)

    def _measured_heights(self, phys: PhysicsState) -> torch.Tensor:
        """(B, P) terrain heights at the yaw-rotated scan grid; zeros when
        the config measures none."""
        if not self.measure_heights:
            return phys.base_pos.new_zeros(phys.base_pos.shape[0],
                                           self.num_height_points)
        pts = quat_ops.apply_yaw(
            phys.base_quat[:, None, :], self.height_points[None, :, :]
        ) + phys.base_pos[:, None, :]
        return self.terrain.height_scan_at(pts[..., 0], pts[..., 1])

    def _feet_heights(self, foot_pos: torch.Tensor) -> torch.Tensor:
        if self.is_plane:
            return foot_pos[..., 2]
        h = self.terrain.height_scan_at(foot_pos[..., 0], foot_pos[..., 1])
        return foot_pos[..., 2] - h

    # ------------------------------------------------------------------ step

    @profiling.span("env.step")
    def step(self, state: EnvState, actions: torch.Tensor
             ) -> Tuple[EnvState, StepOutput]:
        """One policy step with masked resets: `_step_eager`, which on one
        card a CUDA graph of it serves (envs/step_graph.py: a capture for
        each `graph_key`, inside the span `env.graph_capture`; counters
        `env.graph_capture`, graphs captured, and `env.graph_replay`, steps
        a graph served).  The CPU, a rank of a shard mesh and an input that
        requires grad take the eager body."""
        args = (state, actions)
        tensors = step_graph.leaves(args)
        if not step_graph.graph_route(state.physics.base_pos.device,
                                      self._shard_mesh, tensors):
            return self._step_eager(state, actions)
        key = step_graph.graph_key(self, tensors)
        graph = self._graphs.get(key)
        if graph is None:
            with profiling.span("env.graph_capture"):
                graph = step_graph.StepGraph(self._step_eager, args,
                                             self.generator)
            self._graphs[key] = graph
            profiling.count("env.graph_capture")
        profiling.count("env.graph_replay")
        return graph(tensors)

    def _step_eager(self, state: EnvState, actions: torch.Tensor
                    ) -> Tuple[EnvState, StepOutput]:
        """`step`'s body, run op by op: its phases in the spans
        `env.<phase>` (`STEP_PHASES`).  Tools that measure the step's own
        parts call it by name (bench --mode env_phases, profile_substep)."""
        cfg = self.cfg
        B = self.num_envs
        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)
        state = state.replace(actions=actions)

        # --- physics (decimation substeps)
        with profiling.span("env.physics"):
            phys, torques, act_carry, sphere_pos = self._physics_rollout(
                state, actions)
        # curriculum credit: velocity along the commanded direction, with
        # the commands active during this tick's substeps (pre-resample)
        cmd_xy = state.commands[:, :2]
        cmd_norm = torch.linalg.vector_norm(cmd_xy, dim=-1, keepdim=True)
        cmd_dir_b = cmd_xy / torch.clamp_min(cmd_norm, 1e-6)
        cmd_dir_w = quat_ops.apply_yaw(
            phys.base_quat,
            torch.cat([cmd_dir_b, torch.zeros_like(cmd_norm)], dim=-1))
        progress = state.cmd_progress + self.dt * torch.where(
            cmd_norm[:, 0] > 0.05,
            torch.sum(phys.base_lin_vel[:, :2] * cmd_dir_w[:, :2], dim=-1),
            0.0)
        # the push was consumed by substep 0
        state = state.replace(
            physics=phys, torques=torques, actuator_carry=act_carry,
            push_force=torch.zeros_like(state.push_force),
            episode_step=state.episode_step + 1,
            common_step=state.common_step + 1,
            cmd_progress=progress)

        # --- derived quantities
        base_lin_vel, base_ang_vel, proj_grav = \
            self._base_frame_quantities(phys)
        feet = self.feet_index
        foot_pos = (sphere_pos[:, feet, :] if sphere_pos is not None
                    else self._foot_positions(phys, state.params))
        with profiling.span("env.heights"):
            if "heights" in self._ablate:
                measured_heights = phys.base_pos.new_zeros(
                    B, self.num_height_points)
            else:
                measured_heights = self._measured_heights(phys)
        contact_force = phys.contact_force  # (B, nc, 3)
        feet_force = contact_force[:, feet, :]

        # --- feet state: air time is already zeroed for feet in contact,
        # so first_contact fires only after a swing; the reward reads
        # air_old + dt
        contact = feet_force[..., 2] > 1.0
        contact_filt = contact | state.last_contacts
        not_filt = (~contact_filt).to(torch.float32)
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        air_for_reward = state.feet_air_time + self.dt
        last_feet_air_time = torch.where(
            first_contact, air_for_reward, state.last_feet_air_time)
        feet_air_time = air_for_reward * not_filt
        feet_height = self._feet_heights(foot_pos)
        last_max_feet_height = torch.where(
            first_contact, state.current_max_feet_height,
            state.last_max_feet_height)
        current_max_feet_height = torch.maximum(
            state.current_max_feet_height * not_filt, feet_height)
        state = state.replace(
            feet_air_time=feet_air_time,
            last_feet_air_time=last_feet_air_time,
            current_max_feet_height=current_max_feet_height,
            last_max_feet_height=last_max_feet_height,
            last_contacts=contact)

        # --- commands: resample / heading controller
        with profiling.span("env.commands"):
            if "commands" not in self._ablate:
                state = self._update_commands(state, phys)

        # --- pushes: PointFoot queues a world force for the next substep 0,
        # with F_max = mean base mass * max_push_vel / sim_dt; the
        # LeggedRobot family sets the base velocity
        with profiling.span("env.push"):
            push = cfg.domain_rand.push_robots and "push" not in self._ablate
            if push and cfg.obs_style == "legged":
                push_step = (state.common_step % self.push_interval) == 0
                vmax = cfg.domain_rand.max_push_vel_xy
                vel_xy = self._uniform((B, 2), -vmax, vmax)
                new_lin = torch.cat([vel_xy, phys.base_lin_vel[:, 2:]], dim=-1)
                phys = dataclasses.replace(phys, base_lin_vel=torch.where(
                    push_step, new_lin, phys.base_lin_vel))
                state = state.replace(physics=phys)
            elif push:
                push_step = (state.common_step % self.push_interval) == 0
                mean_mass = torch.mean(self.model.mass[0]
                                       + state.params.added_mass)
                fmax = mean_mass * cfg.domain_rand.max_push_vel_xy / cfg.sim.dt
                raw = self._uniform((B, 3), -fmax, fmax)
                world = quat_ops.rotate(phys.base_quat, raw)
                world = world * const((1.0, 1.0, 0.5), world)
                state = state.replace(push_force=torch.where(
                    push_step, world, torch.zeros_like(world)))

        # --- termination: contact force on base/abad spheres
        term_force = contact_force[:, self.termination_index, :]
        terminate = torch.any(
            torch.linalg.vector_norm(term_force, dim=-1) > 1.0, dim=-1)
        # NaN quarantine: an exploded env resets instead of poisoning the
        # batch; one sum per env carries any NaN/Inf into the probe
        probe = (phys.base_pos.sum(-1) + phys.base_quat.sum(-1)
                 + phys.qpos.sum(-1) + phys.qvel.sum(-1)
                 + phys.base_lin_vel.sum(-1) + phys.base_ang_vel.sum(-1))
        bad = ~torch.isfinite(probe)
        terminate = terminate | bad
        time_out = state.episode_step > self.max_episode_length
        done = terminate | time_out
        state = state.replace(terminate=terminate, time_out=time_out)

        # --- rewards (pre-reset state)
        ctx = dict(
            base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel,
            proj_grav=proj_grav, phys=phys, torques=torques,
            measured_heights=measured_heights, foot_pos=foot_pos,
            feet_force=feet_force, contact_force=contact_force,
            first_contact=first_contact, contact_filt=contact_filt,
            feet_air_time=air_for_reward, done=done, time_out=time_out,
            state=state)
        with profiling.span("env.reward"):
            if "reward" in self._ablate:
                reward = phys.base_pos.new_zeros(B)
                term_values = phys.base_pos.new_zeros(
                    B, len(self.reward_names))
            else:
                reward, term_values = self._compute_reward(ctx)
        # quarantined envs must not leak into a training batch
        clip_r = cfg.rewards.clip_reward
        reward = torch.where(bad, 0.0, torch.nan_to_num(reward))
        reward = torch.clamp(reward, -clip_r, clip_r)
        term_values = torch.where(bad[:, None], 0.0,
                                  torch.nan_to_num(term_values))
        term_values = torch.clamp(term_values, -clip_r, clip_r)
        episode_sums = state.episode_sums + term_values
        state = state.replace(episode_sums=episode_sums)

        # --- extras (episode logging before the sums reset)
        n_resets = done.sum()
        n_done = torch.clamp_min(n_resets, 1)
        extras = {
            "time_outs": time_out,
            "terminate": terminate,
            "num_resets": n_resets,
            "num_nan_quarantined": bad.sum(),
            "episode_rew": torch.where(
                n_resets > 0,
                torch.where(done[:, None], episode_sums, 0.0).sum(0)
                / n_done / self.max_episode_length_s,
                0.0),
            "terrain_level": state.terrain_level.to(torch.float32).mean(),
            "max_command_x": state.lin_vel_x_range[1],
        }

        # --- masked reset (curricula inside)
        with profiling.span("env.reset"):
            if "reset" not in self._ablate:
                state = self._reset_envs(state, done)

        # --- observations from the post-reset state; the height scan is
        # the one measured before the reset
        with profiling.span("env.obs"):
            if "obs" in self._ablate:
                obs = phys.base_pos.new_zeros(B, self.num_obs)
                priv = (None if self.num_privileged_obs is None else
                        phys.base_pos.new_zeros(B, self.num_privileged_obs))
            else:
                obs, priv = self._compute_observations(state,
                                                       measured_heights)
        state = state.replace(last_actions=state.actions,
                              last_qvel=state.physics.qvel)
        return state, StepOutput(obs, priv, reward, done, extras)

    # --------------------------------------------------------------- obs

    def _compute_observations(self, state: EnvState,
                              measured_heights: torch.Tensor):
        """PointFoot order: [ω·0.25, g_proj, q − q_def, q̇·0.05, a_prev,
        cmd·scale]; LeggedRobot order: [v·2, ω·0.25, g_proj, cmd·scale,
        q − q_def, q̇·0.05, a_prev].  The clipped height scan follows where
        num_observations (actor) or num_privileged_obs (critic) has room
        for it."""
        cfg = self.cfg
        phys = state.physics
        base_lin_vel, base_ang_vel, proj_grav = \
            self._base_frame_quantities(phys)
        s = cfg.normalization
        q_rel = (phys.qpos - self.default_qpos) * s.dof_pos_scale
        qd = phys.qvel * s.dof_vel_scale
        cmd = state.commands[:, :3] * self.cmd_scale
        if cfg.obs_style == "legged":
            parts = [base_lin_vel * s.lin_vel_scale,
                     base_ang_vel * s.ang_vel_scale, proj_grav, cmd, q_rel,
                     qd, state.actions]
        else:
            parts = [base_ang_vel * s.ang_vel_scale, proj_grav, q_rel, qd,
                     state.actions, cmd]
        obs = torch.cat(parts, dim=-1)
        heights = None
        if (self.num_privileged_obs or 0) > obs.shape[-1] or \
                self.num_obs > obs.shape[-1]:
            heights = torch.clamp(
                phys.base_pos[:, 2:3] - 0.5 - measured_heights, -1.0, 1.0
            ) * s.height_meas_scale
        if self.num_obs > obs.shape[-1] and heights is not None:
            obs = torch.cat([obs, heights], dim=-1)
        if obs.shape[-1] != self.num_obs:
            raise RuntimeError(
                f"obs size {obs.shape[-1]} != num_observations {self.num_obs}")

        priv = None
        if self.num_privileged_obs is not None:
            base = obs[:, : self.num_obs]
            if self.num_privileged_obs > base.shape[-1] and \
                    heights is not None:
                priv = torch.cat([base, heights], dim=-1)
            else:
                priv = base
            if priv.shape[-1] != self.num_privileged_obs:
                raise RuntimeError(
                    f"priv obs size {priv.shape[-1]} != "
                    f"num_privileged_obs {self.num_privileged_obs}")

        if cfg.noise.add_noise:
            noise = self._uniform(obs.shape, -1.0, 1.0) * self.noise_vec
            obs = obs + noise
            if priv is not None:
                if self.priv_noise_vec is not None and \
                        priv.shape[-1] > self.num_obs:
                    extra = self._uniform(
                        priv[:, self.num_obs:].shape, -1.0, 1.0
                    ) * self.priv_noise_vec
                    priv = priv + torch.cat([noise, extra], dim=-1)
                elif priv.shape[-1] == obs.shape[-1]:
                    priv = priv + noise
        clip = cfg.normalization.clip_observations
        # nan_to_num before clip: never hand NaN to the policy
        obs = torch.clamp(torch.nan_to_num(obs), -clip, clip)
        if priv is not None:
            priv = torch.clamp(torch.nan_to_num(priv), -clip, clip)
        return obs, priv

    # --------------------------------------------------------------- rewards

    def _compute_reward(self, ctx) -> Tuple[torch.Tensor, torch.Tensor]:
        """Weighted sum over the active terms, then the termination term."""
        values = []
        total = torch.zeros(self.num_envs, device=self.device)
        for name, scale in self.reward_terms:
            r = REWARD_FNS[name](self, ctx) * scale
            total = total + r
            values.append(r)
        if self.cfg.rewards.only_positive_rewards:
            total = torch.clamp_min(total, 0.0)
        if self.termination_scale:
            r = _reward_termination(self, ctx) * (
                self.termination_scale * self.dt)
            total = total + r
            values.append(r)
        return total, torch.stack(values, dim=-1)

    # --------------------------------------------------------------- commands

    def _resample_commands(self, state: EnvState, need: torch.Tensor
                           ) -> EnvState:
        """New commands where `need`, respecting pins."""
        cfg = self.cfg.commands
        B = need.shape[0]
        need = need & ~state.cmd_pinned
        lo, hi = state.lin_vel_x_range[0], state.lin_vel_x_range[1]
        vx = self._uniform((B,), lo, hi)
        if cfg.low_cmd_oversample > 0.0:
            # a share of the draws lands in the magnitudes [0.2, band]
            mag = self._uniform((B,), 0.2, cfg.low_cmd_band)
            sign = torch.where(self._uniform((B,), 0.0, 1.0) < 0.5, -1.0,
                               1.0)
            use_low = self._uniform((B,), 0.0, 1.0) < cfg.low_cmd_oversample
            vx = torch.where(use_low, sign * mag, vx)
        vy = self._uniform((B,), *cfg.lin_vel_y)
        cmds = state.commands.clone()
        cmds[:, 0] = torch.where(need, vx, cmds[:, 0])
        cmds[:, 1] = torch.where(need, vy, cmds[:, 1])
        if cfg.heading_command:
            heading = self._uniform((B,), *cfg.heading)
            cmds[:, 3] = torch.where(need, heading, cmds[:, 3])
        else:
            wz = self._uniform((B,), *cfg.ang_vel_yaw)
            cmds[:, 2] = torch.where(need, wz, cmds[:, 2])
        # zero small commands
        small = torch.linalg.vector_norm(cmds[:, :2], dim=-1) < 0.2
        keep = torch.where(need & small, 0.0, 1.0)
        cmds[:, :2] = cmds[:, :2] * keep[:, None]
        return state.replace(commands=cmds)

    def _update_commands(self, state: EnvState, phys: PhysicsState
                         ) -> EnvState:
        """Periodic resample + heading controller."""
        need = (state.episode_step % self.resample_interval) == 0
        state = self._resample_commands(state, need)
        if self.cfg.commands.heading_command:
            cmds = state.commands.clone()
            wz = quat_ops.heading_wz(cmds[:, 3], quat_ops.yaw(phys.base_quat))
            cmds[:, 2] = torch.where(state.cmd_pinned, cmds[:, 2], wz)
            state = state.replace(commands=cmds)
        return state

    # --------------------------------------------------------------- resets

    def _reset_envs(self, state: EnvState, done: torch.Tensor) -> EnvState:
        """Masked reset of done envs: curricula, state resample, buffer
        clears, fresh commands.  The command curriculum judges the episodes
        that end across all ranks."""
        cfg = self.cfg
        B = done.shape[0]
        m = self.model
        terrain = self.terrain

        # ---- terrain curriculum
        level = state.terrain_level
        origin = state.env_origin
        if cfg.terrain.curriculum and not self.is_plane:
            dist = torch.linalg.vector_norm(
                state.physics.base_pos[:, :2] - state.env_origin[:, :2],
                dim=-1)
            cmd_speed = torch.linalg.vector_norm(state.commands[:, :2],
                                                 dim=-1)
            if cfg.terrain.cmd_conditioned_promotion:
                # the required distance scales with the commanded speed
                required = torch.clamp(
                    0.5 * cmd_speed * self.max_episode_length_s,
                    2.0, terrain.terrain_length / 2)
                move_up = dist > required
            else:
                move_up = dist > terrain.terrain_length / 2
            if cfg.terrain.reference_exact_demotion:
                # the reference's rule: the full episode length, judged on
                # net displacement
                cmd_dist = cmd_speed * self.max_episode_length_s * 0.5
                move_down = (dist < cmd_dist) & ~move_up
            else:
                # the required distance scaled by the seconds the episode
                # ran, judged on the along-command progress credit
                ep_secs = state.episode_step.to(torch.float32) * self.dt
                cmd_dist = cmd_speed * ep_secs * 0.5
                move_down = (state.cmd_progress < cmd_dist) & ~move_up
            new_level = level + move_up.long() - move_down.long()
            rand_level = self._randint((B,), 0, terrain.num_levels)
            new_level = torch.where(new_level >= terrain.num_levels,
                                    rand_level, torch.clamp_min(new_level, 0))
            level = torch.where(done, new_level, level)
            origin = terrain.env_origins[level, state.terrain_type]

        # ---- command curriculum: widen the vx range on an episode-length
        # tick when the episodes ending there tracked well
        rng_range = state.lin_vel_x_range
        if cfg.commands.curriculum:
            idx = self.reward_names.index("tracking_lin_vel")
            track_scale = dict(self.reward_terms)["tracking_lin_vel"]
            n_done = done.sum().to(torch.float32)
            track = torch.where(done, state.episode_sums[:, idx], 0.0).sum()
            # a rank's shard sums with the others' (at init every rank
            # resets the global batch itself)
            if B < self.global_num_envs:
                all_reduce_sum_([n_done, track], self._shard_mesh)
            mean_track = track / torch.clamp_min(n_done, 1)
            trigger = (((state.common_step % self.max_episode_length) == 0)
                       & (n_done > 0)
                       & (mean_track / self.max_episode_length
                          > 0.8 * track_scale))
            mc = cfg.commands.max_curriculum
            widened = torch.stack([
                torch.clamp(rng_range[0] - 0.5, -mc, 0.0),
                torch.clamp(rng_range[1] + 0.5, 0.0, mc)])
            rng_range = torch.where(trigger, widened, rng_range)

        # ---- state resets
        qpos_new = self.default_qpos * self._uniform((B, m.nj), 0.5, 1.5)
        base_pos_new = origin + const(cfg.init_state.pos, origin)
        if not self.is_plane:
            base_pos_new = torch.cat([
                base_pos_new[:, :2] + self._uniform((B, 2), -1.0, 1.0),
                base_pos_new[:, 2:]], dim=-1)
        vel6 = self._uniform((B, 6), -0.5, 0.5)
        quat_new = const(cfg.init_state.rot, origin).expand(B, 4)

        d1 = done[:, None]
        phys = state.physics
        phys = PhysicsState(
            base_pos=torch.where(d1, base_pos_new, phys.base_pos),
            base_quat=torch.where(d1, quat_new, phys.base_quat),
            base_lin_vel=torch.where(d1, vel6[:, :3], phys.base_lin_vel),
            base_ang_vel=torch.where(d1, vel6[:, 3:], phys.base_ang_vel),
            qpos=torch.where(d1, qpos_new, phys.qpos),
            qvel=torch.where(d1, 0.0, phys.qvel),
            # cleared too, so a quarantined env leaves no NaN residue
            contact_force=torch.where(done[:, None, None], 0.0,
                                      phys.contact_force),
        )

        def clear(x):
            return torch.where(d1, torch.zeros_like(x), x)

        state = state.replace(
            physics=phys, terrain_level=level, env_origin=origin,
            lin_vel_x_range=rng_range,
            episode_step=torch.where(done, 0, state.episode_step),
            cmd_progress=torch.where(done, 0.0, state.cmd_progress),
            actions=clear(state.actions),
            last_actions=clear(state.last_actions),
            last_qvel=clear(state.last_qvel),
            feet_air_time=clear(state.feet_air_time),
            last_feet_air_time=clear(state.last_feet_air_time),
            current_max_feet_height=clear(state.current_max_feet_height),
            last_max_feet_height=clear(state.last_max_feet_height),
            last_contacts=clear(state.last_contacts),
            episode_sums=clear(state.episode_sums),
            actuator_carry=torch.where(
                done.reshape((B,) + (1,) * (state.actuator_carry.dim() - 1)),
                0.0, state.actuator_carry),
        )
        # fresh episodes get fresh commands
        return self._resample_commands(state, done)

    # ---------------------------------------------------------- external pins

    def update_frictions(self, state: EnvState, friction) -> EnvState:
        """Pin the per-joint dry friction: a scalar, (nj,) or (B, nj)."""
        f = torch.as_tensor(friction, dtype=torch.float32,
                            device=self.device).expand(
                                state.params.joint_friction.shape)
        return state.replace(params=dataclasses.replace(
            state.params, joint_friction=f.clone()))

    def update_ground_friction(self, state: EnvState, friction) -> EnvState:
        """Pin the ground friction of every collision sphere."""
        f = torch.as_tensor(friction, dtype=torch.float32,
                            device=self.device).expand(
                                state.params.friction.shape)
        return state.replace(params=dataclasses.replace(
            state.params, friction=f.clone()))

    def update_added_mass_and_base_com(self, state: EnvState, added_mass,
                                       com_offset) -> EnvState:
        """Pin the base payload and the base CoM shift."""
        p = state.params
        am = torch.as_tensor(added_mass, dtype=torch.float32,
                             device=self.device).expand(p.added_mass.shape)
        co = torch.as_tensor(com_offset, dtype=torch.float32,
                             device=self.device).expand(p.com_offset.shape)
        return state.replace(params=dataclasses.replace(
            p, added_mass=am.clone(), com_offset=co.clone()))

    def update_cmd(self, state: EnvState, cmd) -> EnvState:
        """Pin commands from outside (evaluation, sys-ID)."""
        cmd = torch.as_tensor(cmd, dtype=torch.float32, device=self.device)
        cmds = state.commands.clone()
        cmds[:, : cmd.shape[-1]] = cmd
        return state.replace(
            commands=cmds,
            cmd_pinned=torch.ones(cmds.shape[0], dtype=torch.bool,
                                  device=self.device))


# ---------------------------------------------------------------------------
# Reward terms.  Each fn: (env, ctx) -> (B,)
# ---------------------------------------------------------------------------

def _sq(x):
    return x * x


def _reward_lin_vel_z(env, ctx):
    return _sq(ctx["base_lin_vel"][:, 2])


def _reward_ang_vel_xy(env, ctx):
    return _sq(ctx["base_ang_vel"][:, :2]).sum(-1)


def _reward_orientation(env, ctx):
    return _sq(ctx["proj_grav"][:, :2]).sum(-1)


def _reward_base_height(env, ctx):
    h = torch.mean(
        ctx["phys"].base_pos[:, 2:3] - ctx["measured_heights"], dim=-1)
    return _sq(h - env.cfg.rewards.base_height_target)


def _reward_torques(env, ctx):
    return _sq(ctx["torques"]).sum(-1)


def _reward_dof_vel(env, ctx):
    return _sq(ctx["phys"].qvel).sum(-1)


def _reward_dof_acc(env, ctx):
    st = ctx["state"]
    return _sq((st.last_qvel - ctx["phys"].qvel) / env.dt).sum(-1)


def _reward_action_rate(env, ctx):
    st = ctx["state"]
    return _sq(st.last_actions - st.actions).sum(-1)


def _reward_collision(env, ctx):
    if not env.penalized_idx:
        return torch.zeros(env.num_envs, device=env.device)
    f = ctx["contact_force"][:, env.penalized_index, :]
    return (torch.linalg.vector_norm(f, dim=-1) > 0.1).to(
        torch.float32).sum(-1)


def _reward_termination(env, ctx):
    return (ctx["done"] & ~ctx["time_out"]).to(torch.float32)


def _reward_dof_pos_limits(env, ctx):
    # soft limits: mid ± 0.5 · range · soft_dof_pos_limit
    m = env.model
    soft = env.cfg.rewards.soft_dof_pos_limit
    mid = 0.5 * (m.q_lower + m.q_upper)
    half = 0.5 * (m.q_upper - m.q_lower) * soft
    q = ctx["phys"].qpos
    low = -torch.clamp_max(q - (mid - half), 0.0)
    high = torch.clamp_min(q - (mid + half), 0.0)
    return (low + high).sum(-1)


def _reward_dof_vel_limits(env, ctx):
    lim = env.qvel_limit * env.cfg.rewards.soft_dof_vel_limit
    return torch.clamp(torch.abs(ctx["phys"].qvel) - lim, 0.0, 1.0).sum(-1)


def _reward_torque_limits(env, ctx):
    lim = env.torque_limit * env.cfg.rewards.soft_torque_limit
    return torch.clamp_min(torch.abs(ctx["torques"]) - lim, 0.0).sum(-1)


def _reward_tracking_lin_vel(env, ctx):
    cmd = ctx["state"].commands[:, :2]
    err = _sq(cmd - ctx["base_lin_vel"][:, :2]).sum(-1)
    sigma = env.cfg.rewards.tracking_sigma
    vref = env.cfg.rewards.tracking_rel_vref
    if vref > 0.0:  # a width relative to the command; 0 = fixed width
        sigma = sigma * torch.clamp(_sq(cmd).sum(-1) / (vref * vref),
                                    0.04, 1.0)
    return torch.exp(-err / sigma)


def _reward_tracking_ang_vel(env, ctx):
    err = _sq(ctx["state"].commands[:, 2] - ctx["base_ang_vel"][:, 2])
    return torch.exp(-err / env.cfg.rewards.tracking_sigma)


def _reward_feet_air_time(env, ctx):
    """PointFoot: band penalty on the swing time at first contact.
    LeggedRobot family: (air time − 0.5) at first contact, gated on a
    nonzero command."""
    fc = ctx["first_contact"].to(torch.float32)
    air = ctx["feet_air_time"]
    if env.cfg.obs_style == "legged":
        rew = ((air - 0.5) * fc).sum(-1)
        moving = torch.linalg.vector_norm(
            ctx["state"].commands[:, :2], dim=-1) > 0.1
        return rew * moving
    r = env.cfg.rewards
    below = (torch.clamp_max(air - r.min_feet_air_time, 0.0) * fc).sum(-1)
    above = (torch.clamp_max(r.max_feet_air_time - air, 0.0) * fc).sum(-1)
    return below + above


def _reward_no_fly(env, ctx):
    contacts = ctx["feet_force"][..., 2] > 0.1
    return (contacts.to(torch.float32).sum(-1) == 1.0).to(torch.float32)


def _reward_unbalance_feet_air_time(env, ctx):
    return torch.var(ctx["state"].last_feet_air_time, dim=-1, correction=0)


def _reward_unbalance_feet_height(env, ctx):
    return torch.var(ctx["state"].last_max_feet_height, dim=-1, correction=0)


def _reward_feet_stumble(env, ctx):
    f = ctx["feet_force"]
    lateral = torch.linalg.vector_norm(f[..., :2], dim=-1)
    return torch.any(lateral > 5.0 * torch.abs(f[..., 2]), dim=-1).to(
        torch.float32)


def _reward_stand_still(env, ctx):
    """PointFoot: base velocity under an elementwise command gate.
    LeggedRobot family: joint displacement at a near-zero command."""
    cmd = ctx["state"].commands
    if env.cfg.obs_style == "legged":
        still = torch.linalg.vector_norm(cmd[:, :2], dim=-1) < 0.1
        return torch.abs(ctx["phys"].qpos - env.default_qpos).sum(-1) * still
    rew_lin = torch.abs(ctx["base_lin_vel"][:, :2]) * (cmd[:, :2] < 0.1)
    rew_ang = torch.abs(ctx["base_ang_vel"][:, 2:3]) * (cmd[:, 2:3] < 0.1)
    return torch.cat([rew_lin, rew_ang], dim=-1).sum(-1)


def _reward_feet_contact_forces(env, ctx):
    norm = torch.linalg.vector_norm(ctx["feet_force"], dim=-1)
    return torch.clamp_min(
        norm - env.cfg.rewards.max_contact_force, 0.0).sum(-1)


def _reward_feet_distance(env, ctx):
    """Pairwise form over all feet."""
    fp = ctx["foot_pos"]
    nf = fp.shape[1]
    total = torch.zeros(fp.shape[0], device=fp.device)
    for i in range(nf - 1):
        for j in range(i + 1, nf):
            d = torch.linalg.vector_norm(fp[:, i, :2] - fp[:, j, :2], dim=-1)
            total = total + torch.clamp(
                env.cfg.rewards.min_feet_distance - d, 0.0, 1.0)
    return total


def _reward_survival(env, ctx):
    return (~ctx["done"]).to(torch.float32) * env.dt


def _reward_feet_height(env, ctx):
    st = ctx["state"]
    target = env.cfg.rewards.clearance_height_target
    return _sq(st.current_max_feet_height - target).sum(-1)


REWARD_FNS = {
    "lin_vel_z": _reward_lin_vel_z,
    "ang_vel_xy": _reward_ang_vel_xy,
    "orientation": _reward_orientation,
    "base_height": _reward_base_height,
    "torques": _reward_torques,
    "dof_vel": _reward_dof_vel,
    "dof_acc": _reward_dof_acc,
    "action_rate": _reward_action_rate,
    "collision": _reward_collision,
    "termination": _reward_termination,
    "dof_pos_limits": _reward_dof_pos_limits,
    "dof_vel_limits": _reward_dof_vel_limits,
    "torque_limits": _reward_torque_limits,
    "tracking_lin_vel": _reward_tracking_lin_vel,
    "tracking_ang_vel": _reward_tracking_ang_vel,
    "feet_air_time": _reward_feet_air_time,
    "no_fly": _reward_no_fly,
    "unbalance_feet_air_time": _reward_unbalance_feet_air_time,
    "unbalance_feet_height": _reward_unbalance_feet_height,
    "feet_stumble": _reward_feet_stumble,
    "stand_still": _reward_stand_still,
    "feet_contact_forces": _reward_feet_contact_forces,
    "feet_distance": _reward_feet_distance,
    "survival": _reward_survival,
    "feet_height": _reward_feet_height,
}
