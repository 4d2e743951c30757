"""Plane terrain and pointfoot_flat under the port.

- The golden control-sequence anchor (tests/test_golden_trajectory.py):
  the JAX package makes the 1-env state (PRNGKey 42, noise and domain
  randomization off, command pinned to 0.3 m/s), the port steps it 50 times
  with the anchor's actions and must reproduce
  tests/golden/pointfoot_flat_50step.npz at the anchor's own tolerances.
  The robot falls and resets inside the window; the reset's random draws
  are JAX's, made from the JAX state's key as the JAX step would split it
  (trap (b) of ROADMAP §3: the two packages' random streams differ).
- An 8-env window against the JAX env (model_82000's actor, noise off),
  clear of resets, pushes and command resamples.
- tests/test_nan_quarantine.py, tests/test_tracking_rel.py and the
  pointfoot_flat cases of tests/test_env.py, under the port.
- The dispatch: at MEGA_MIN_BATCH envs the plane env takes the fused
  rollout with no surface rows and no surface query, and agrees with the
  scan path.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import export_fields
from pointfoot_tpu_torch.envs import legged_env as le
from pointfoot_tpu_torch.envs.config import override
from pointfoot_tpu_torch.envs.legged_env import LeggedEnv
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.utils import convert, policy_eval
from pointfoot_tpu_torch.utils.registry import get_cfgs, make_env

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "pointfoot_flat_50step.npz")
B = 8
ATOL = 2e-3


def _golden_patch():
    return dict(env=dict(num_envs=1), noise=dict(add_noise=False),
                domain_rand=dict(randomize_friction=False, push_robots=False,
                                 randomize_base_mass=False,
                                 randomize_base_com=False))


def _jax_reset_draws(key, nj):
    """The draws of the JAX env's `_reset_envs(state, done, k_reset)` for
    one env, keyed as the port's `_uniform` is called: (shape, lo, hi)."""
    k_reset = jax.random.split(key, 5)[2]
    k = jax.random.split(k_reset, 6)
    return {
        ((1, nj), 0.5, 1.5): np.array(jax.random.uniform(
            k[1], (1, nj), minval=0.5, maxval=1.5)),
        ((1, 6), -0.5, 0.5): np.array(jax.random.uniform(
            k[3], (1, 6), minval=-0.5, maxval=0.5)),
    }


def test_control_sequence_matches_golden(monkeypatch):
    from pointfoot_tpu.envs.config import override as joverride
    from pointfoot_tpu.envs.legged_env import LeggedEnv as JaxEnv
    from pointfoot_tpu.utils.registry import task_registry

    jenv = JaxEnv(joverride(task_registry.get_cfgs("pointfoot_flat")[0],
                            **_golden_patch()))
    js = jenv.init_state(jax.random.PRNGKey(42))
    js = jenv.update_cmd(js, [0.3, 0.0, 0.0])
    env = LeggedEnv(override(get_cfgs("pointfoot_flat")[0],
                             **_golden_patch()), device="cpu")
    state = convert.env_state_from_numpy(export_fields(js))
    key = js.rng
    reset = env._reset_envs
    resets = []

    def reset_with_jax_draws(st, done):
        own = env._uniform

        def uniform(shape, lo, hi):
            got = draws.get((tuple(shape), float(lo), float(hi)))
            return own(shape, lo, hi) if got is None else \
                torch.from_numpy(got)

        resets.append(bool(done.any()))
        monkeypatch.setattr(env, "_uniform", uniform)
        try:
            return reset(st, done)
        finally:
            monkeypatch.setattr(env, "_uniform", own)

    monkeypatch.setattr(env, "_reset_envs", reset_with_jax_draws)
    obs, tau = [], []
    for t in range(50):
        draws = _jax_reset_draws(key, env.model.nj)
        key = jax.random.split(key, 5)[0]
        a = (0.3 * np.sin(np.arange(6) * 1.0 + t * 0.1))[None, :]
        state, out = env.step(state, torch.tensor(a, dtype=torch.float32))
        obs.append(out.obs[0].numpy())
        tau.append(state.torques[0].numpy())
    assert any(resets), "the anchor's window should hold a reset"
    ref = np.load(GOLDEN)
    np.testing.assert_allclose(np.stack(tau), ref["torques"], atol=2e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(np.stack(obs), ref["obs"], atol=2e-3,
                               rtol=1e-4)


# --------------------------------------- an 8-env window against JAX

WARM, STEPS = 3, 5
NOISE_OFF = dict(noise=dict(add_noise=False))


@pytest.fixture(scope="module")
def window():
    from pointfoot_tpu.utils.registry import task_registry

    jenv = task_registry.make_env("pointfoot_flat", num_envs=B,
                                  cfg_patch=NOISE_OFF)
    tenv = make_env("pointfoot_flat", num_envs=B, device="cpu",
                    cfg_patch=NOISE_OFF)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(tenv, "pointfoot_flat"))
    step = jax.jit(jenv.step)
    js = jenv.init_state(jax.random.PRNGKey(0))
    js, out = step(js, jnp.zeros((B, 6)))
    for _ in range(WARM):
        a = policy(torch.tensor(np.asarray(out.obs))).numpy()
        js, out = step(js, jnp.asarray(a))
    ts = convert.env_state_from_numpy(export_fields(js))
    pairs = []
    for _ in range(STEPS):
        a = policy(torch.tensor(np.asarray(out.obs))).numpy()
        js, out = step(js, jnp.asarray(a))
        ts, tout = tenv.step(ts, torch.from_numpy(a))
        pairs.append((js, out, ts, tout))
    return jenv, tenv, pairs


def test_flat_window_is_deterministic(window):
    jenv, tenv, pairs = window
    assert tenv.is_plane and tenv.height_fn.is_flat
    for js, out, ts, tout in pairs:
        assert not np.asarray(out.done).any()
        assert not tout.done.any()
        assert int(js.common_step) % jenv.push_interval != 0
        assert (np.asarray(js.episode_step) % jenv.resample_interval
                != 0).all()


def test_flat_terrain_and_origins_match(window):
    jenv, tenv, _ = window
    assert torch.equal(tenv.terrain.env_origins,
                       torch.from_numpy(np.array(jenv.terrain.env_origins)))
    assert tenv.terrain.height.shape == tuple(jenv.terrain.height.shape)


@pytest.mark.parametrize("i", range(STEPS))
def test_flat_step_matches_jax(window, i):
    _, _, pairs = window
    js, out, ts, tout = pairs[i]
    assert tout.privileged_obs.shape == (B, 27)
    for name, got, want in [
            ("obs", tout.obs, out.obs),
            ("privileged_obs", tout.privileged_obs, out.privileged_obs),
            ("reward", tout.reward, out.reward)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {i} {name}")
    for f in dataclasses.fields(ts.physics):
        got = getattr(ts.physics, f.name).numpy()
        want = np.asarray(getattr(js.physics, f.name))
        if f.name == "contact_force":
            np.testing.assert_allclose(got, want, atol=0.05, rtol=1e-3,
                                       err_msg=f"step {i} {f.name}")
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                       err_msg=f"step {i} {f.name}")
    for name in ("feet_air_time", "current_max_feet_height", "commands",
                 "torques", "episode_sums", "cmd_progress"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy().astype(np.float64),
            np.asarray(getattr(js, name), np.float64), atol=ATOL, rtol=1e-3,
            err_msg=f"step {i} {name}")


# ---------------------------- tests/test_nan_quarantine.py, under the port

def test_nan_env_is_quarantined_and_batch_stays_finite():
    env = make_env("pointfoot_flat", num_envs=8, device="cpu")
    state = env.init_state(0)
    phys = state.physics
    qvel = phys.qvel.clone()
    qvel[3] = float("nan")
    lin = phys.base_lin_vel.clone()
    lin[3, 0] = float("inf")
    state = state.replace(physics=dataclasses.replace(
        phys, qvel=qvel, base_lin_vel=lin))
    state, out = env.step(state, torch.zeros(8, 6))
    assert bool(out.done[3]), "non-finite env must terminate"
    assert torch.isfinite(out.reward).all()
    assert torch.isfinite(state.physics.qvel).all()
    assert torch.isfinite(state.physics.base_lin_vel).all()
    assert not out.done[[0, 1, 2, 4, 5, 6, 7]].all()
    state, out2 = env.step(state, torch.zeros(8, 6))
    assert torch.isfinite(out2.obs).all()


# ------------------------------ tests/test_tracking_rel.py, under the port

def _track_reward(env, cmd_xy, vel_xy):
    n = len(cmd_xy)
    state = env.init_state(0)
    cmds = torch.zeros(n, 4)
    cmds[:, :2] = torch.tensor(cmd_xy)
    state = state.replace(commands=cmds)
    lin = torch.zeros(n, 3)
    lin[:, :2] = torch.tensor(vel_xy)
    return le._reward_tracking_lin_vel(
        env, {"state": state, "base_lin_vel": lin}).numpy()


def test_default_is_reference_exact():
    env = make_env("pointfoot_flat", num_envs=2, device="cpu")
    assert env.cfg.rewards.tracking_rel_vref == 0.0
    r = _track_reward(env, [[0.25, 0.0], [1.0, 0.0]],
                      [[0.45, 0.0], [1.2, 0.0]])
    np.testing.assert_allclose(r[0], r[1], rtol=1e-6)
    np.testing.assert_allclose(r, np.exp(-0.2 ** 2 / 0.25), rtol=1e-5)


def test_rel_width_equalizes_relative_error():
    env = make_env("pointfoot_flat", num_envs=3, device="cpu",
                   cfg_patch=dict(rewards=dict(tracking_rel_vref=1.0)))
    r = _track_reward(env, [[0.25, 0.0], [0.5, 0.0], [1.0, 0.0]],
                      [[0.30, 0.0], [0.60, 0.0], [1.20, 0.0]])
    np.testing.assert_allclose(r, np.exp(-0.16), rtol=1e-4)
    r1 = _track_reward(env, [[1.0, 0.0]] * 3, [[1.2, 0.0]] * 3)
    np.testing.assert_allclose(r1, np.exp(-0.04 / 0.25), rtol=1e-5)


def test_rel_width_floor_bounds_standstill_sharpness():
    env = make_env("pointfoot_flat", num_envs=1, device="cpu",
                   cfg_patch=dict(rewards=dict(tracking_rel_vref=1.0)))
    r = _track_reward(env, [[0.0, 0.0]], [[0.1, 0.0]])
    np.testing.assert_allclose(r, np.exp(-0.01 / 0.01), rtol=1e-4)


def test_low_cmd_oversample_shifts_distribution():
    def band_frac(patch):
        env = make_env("pointfoot_flat", num_envs=512, device="cpu",
                       cfg_patch=patch)
        state = env.init_state(0)
        state = state.replace(episode_step=torch.zeros(512,
                                                       dtype=torch.int64))
        state = env._resample_commands(state,
                                       torch.ones(512, dtype=torch.bool))
        vx = state.commands[:, 0].abs().numpy()
        return ((vx >= 0.2) & (vx <= 0.4)).mean()

    base = band_frac(None)
    over = band_frac(dict(commands=dict(low_cmd_oversample=0.5)))
    assert base < 0.2, base
    assert over > 0.35, over
    band = make_env("pointfoot_flat", num_envs=512, device="cpu",
                    cfg_patch=dict(commands=dict(low_cmd_oversample=1.0,
                                                 low_cmd_band=0.6)))
    s = band._resample_commands(band.init_state(1),
                                torch.ones(512, dtype=torch.bool))
    vx = s.commands[:, 0].abs()
    assert bool(((vx == 0.0) | ((vx >= 0.2) & (vx <= 0.6))).all())


# --------------------- the pointfoot_flat cases of tests/test_env.py

@pytest.fixture(scope="module")
def flat_env():
    return make_env("pointfoot_flat", num_envs=B, device="cpu")


@pytest.fixture(scope="module")
def flat_run(flat_env):
    state = flat_env.init_state(0)
    state, out = flat_env.step(state, torch.zeros(B, 6))
    return flat_env, state, out


def test_obs_shapes_and_layout(flat_run):
    env, state, out = flat_run
    assert out.obs.shape == (B, 27)
    assert out.privileged_obs.shape == (B, 27)
    assert bool((out.obs[:, 5] < -0.8).all())


def test_smoke_zero_actions_episode(flat_run):
    env, state, out = flat_run
    for _ in range(30):
        state, out = env.step(state, torch.zeros(B, 6))
    assert torch.isfinite(out.obs).all()
    assert torch.isfinite(out.reward).all()


def test_termination_on_fall(flat_env):
    env = flat_env
    state = env.init_state(2)
    phys = state.physics
    pos = phys.base_pos.clone()
    pos[:, 2] = 0.12
    quat = torch.tensor([0.7071, 0.0, 0.0, 0.7071]).expand(B, 4).clone()
    state = state.replace(physics=dataclasses.replace(
        phys, base_pos=pos, base_quat=quat))
    done_any = torch.zeros(B, dtype=torch.bool)
    for _ in range(10):
        state, out = env.step(state, torch.zeros(B, 6))
        done_any |= out.done
    assert done_any.all()


def test_timeout_and_bootstrapping_flag(flat_env):
    env = flat_env
    state = env.init_state(3)
    state = state.replace(episode_step=torch.full(
        (B,), env.max_episode_length, dtype=torch.int64))
    state, out = env.step(state, torch.zeros(B, 6))
    assert out.extras["time_outs"].all()
    assert out.done.all()
    assert int(state.episode_step.max()) == 0


def test_reset_randomization_ranges():
    env = make_env("pointfoot_flat", num_envs=64, device="cpu")
    state = env.init_state(4)
    v = state.physics.base_lin_vel
    assert float(v.abs().max()) <= 0.5 + 1e-5
    assert float(v.abs().std()) > 0.05
    np.testing.assert_allclose(state.physics.qpos.numpy(), 0.0, atol=1e-6)


def test_plane_reset_has_no_xy_jitter_and_diagonal_origins():
    """Plane terrain: the reset puts each env on its lattice origin without
    the table terrain's ±1 m jitter; with as many levels as types, level and
    type come from one formula, so every origin lies on the diagonal."""
    env = make_env("pointfoot_flat", num_envs=64, device="cpu")
    state = env.init_state(4)
    assert env.terrain.num_levels == env.terrain.num_types == 8
    assert torch.equal(state.terrain_level, state.terrain_type)
    origin = env.terrain.env_origins[state.terrain_level, state.terrain_type]
    assert torch.equal(state.physics.base_pos[:, :2], origin[:, :2])
    assert torch.equal(origin[:, 0], origin[:, 1])


def test_domain_randomization_params():
    env = make_env("pointfoot_flat", num_envs=64, device="cpu")
    state = env.init_state(5)
    fric = state.params.friction.numpy()
    assert fric.min() >= 0.0 and fric.max() <= 1.5 + 1e-6
    assert np.unique(fric[:, 0]).size > 4
    am = state.params.added_mass.numpy()
    assert am.min() >= -1.0 - 1e-6 and am.max() <= 2.0 + 1e-6
    com = state.params.com_offset.numpy()
    assert np.abs(com[:, 0]).max() <= 0.03 + 1e-6
    assert np.abs(com[:, 1]).max() <= 0.02 + 1e-6


def test_sysid_hooks(flat_env):
    env = flat_env
    state = env.init_state(6)
    fric6 = torch.tensor([0.01, 0.05, 0.1, 0.15, 0.02, 0.08])
    state = env.update_frictions(state, fric6)
    np.testing.assert_allclose(state.params.joint_friction.numpy(),
                               np.broadcast_to(fric6.numpy(), (B, 6)))
    state = env.update_ground_friction(state, 0.77)
    np.testing.assert_allclose(state.params.friction.numpy(), 0.77)
    state = env.update_added_mass_and_base_com(state, 1.5,
                                               [0.01, 0.0, -0.01])
    np.testing.assert_allclose(state.params.added_mass.numpy(), 1.5)
    np.testing.assert_allclose(state.params.com_offset.numpy(),
                               np.broadcast_to([0.01, 0.0, -0.01], (B, 3)))
    state = env.update_cmd(state, [0.5, 0.0, 0.1])
    state2, out = env.step(state, torch.zeros(B, 6))
    np.testing.assert_allclose(state2.commands[:, 0].numpy(), 0.5)
    np.testing.assert_allclose(state2.commands[:, 2].numpy(), 0.1,
                               rtol=1e-6)


def test_determinism(flat_env):
    env = flat_env
    a = torch.ones(B, 6) * 0.1
    outs = []
    for _ in range(2):
        s = env.init_state(7)
        for _ in range(5):
            s, o = env.step(s, a)
        outs.append(o)
    assert torch.equal(outs[0].obs, outs[1].obs)
    assert torch.equal(outs[0].reward, outs[1].reward)


def test_push_queues_force(flat_env):
    env = flat_env
    state = env.init_state(8)
    state = state.replace(common_step=torch.tensor(env.push_interval - 1))
    state, _ = env.step(state, torch.zeros(B, 6))
    assert float(state.push_force.abs().max()) > 0.0
    state, _ = env.step(state, torch.zeros(B, 6))
    np.testing.assert_allclose(state.push_force.numpy(), 0.0)


class TestRewardGoldenValues:
    """Single reward terms against hand-computed values
    (tests/test_env.py::TestRewardGoldenValues)."""

    def _ctx(self, env, state, **over):
        n = env.num_envs
        ctx = dict(
            base_lin_vel=torch.zeros(n, 3), base_ang_vel=torch.zeros(n, 3),
            proj_grav=torch.tensor([0.0, 0.0, -1.0]).expand(n, 3),
            phys=state.physics, torques=torch.zeros(n, 6),
            measured_heights=torch.zeros(n, env.num_height_points),
            foot_pos=torch.zeros(n, 2, 3), feet_force=torch.zeros(n, 2, 3),
            contact_force=state.physics.contact_force,
            first_contact=torch.zeros(n, 2, dtype=torch.bool),
            contact_filt=torch.zeros(n, 2, dtype=torch.bool),
            feet_air_time=state.feet_air_time + env.dt,
            done=torch.zeros(n, dtype=torch.bool),
            time_out=torch.zeros(n, dtype=torch.bool), state=state)
        ctx.update(over)
        return ctx

    def test_tracking_lin_vel(self, flat_env):
        env = flat_env
        state = env.init_state(9)
        cmds = state.commands.clone()
        cmds[:, 0], cmds[:, 1] = 0.5, 0.0
        state = state.replace(commands=cmds)
        v = torch.tensor([0.5, 0.0, 0.0]).expand(B, 3)
        r = le.REWARD_FNS["tracking_lin_vel"](
            env, self._ctx(env, state, base_lin_vel=v))
        np.testing.assert_allclose(r.numpy(), 1.0, atol=1e-6)
        r2 = le.REWARD_FNS["tracking_lin_vel"](env, self._ctx(env, state))
        np.testing.assert_allclose(r2.numpy(), np.exp(-0.25 / 0.25),
                                   rtol=1e-5)

    def test_no_fly_single_contact(self, flat_env):
        env = flat_env
        state = env.init_state(10)
        ff = torch.zeros(B, 2, 3)
        ff[:, 0, 2] = 10.0
        r = le.REWARD_FNS["no_fly"](env, self._ctx(env, state, feet_force=ff))
        np.testing.assert_allclose(r.numpy(), 1.0)
        ff2 = ff.clone()
        ff2[:, 1, 2] = 10.0
        r2 = le.REWARD_FNS["no_fly"](env, self._ctx(env, state,
                                                    feet_force=ff2))
        np.testing.assert_allclose(r2.numpy(), 0.0)

    def test_feet_air_time_band(self, flat_env):
        env = flat_env
        state = env.init_state(11)
        fc = torch.zeros(B, 2, dtype=torch.bool)
        fc[:, 0] = True
        for air, want, tol in ((0.4, 0.0, 1e-6), (0.1, -0.15, 1e-6),
                               (1.0, -0.35, 1e-5)):
            r = le.REWARD_FNS["feet_air_time"](env, self._ctx(
                env, state, first_contact=fc,
                feet_air_time=torch.full((B, 2), air)))
            np.testing.assert_allclose(r.numpy(), want, atol=tol)

    def test_feet_distance_penalty(self, flat_env):
        env = flat_env
        state = env.init_state(12)
        fp = torch.zeros(B, 2, 3)
        fp[:, 1, 1] = 0.04
        r = le.REWARD_FNS["feet_distance"](env, self._ctx(env, state,
                                                          foot_pos=fp))
        np.testing.assert_allclose(r.numpy(), 0.1 - 0.04, atol=1e-6)
        fp[:, 1, 1] = 0.2
        r2 = le.REWARD_FNS["feet_distance"](env, self._ctx(env, state,
                                                           foot_pos=fp))
        np.testing.assert_allclose(r2.numpy(), 0.0)

    def test_survival_and_termination(self, flat_env):
        env = flat_env
        state = env.init_state(13)
        done = torch.zeros(B, dtype=torch.bool)
        done[0] = True
        ctx = self._ctx(env, state, done=done)
        surv = le.REWARD_FNS["survival"](env, ctx).numpy()
        assert surv[0] == 0.0 and np.allclose(surv[1:], env.dt)
        term = le.REWARD_FNS["termination"](env, ctx).numpy()
        assert term[0] == 1.0 and np.all(term[1:] == 0.0)

    def test_stand_still(self, flat_env):
        env = flat_env
        state = env.init_state(14)
        state = state.replace(commands=torch.zeros(B, 4))
        ctx = self._ctx(
            env, state,
            base_lin_vel=torch.tensor([0.3, -0.2, 0.0]).expand(B, 3),
            base_ang_vel=torch.tensor([0.0, 0.0, 0.4]).expand(B, 3))
        r = le.REWARD_FNS["stand_still"](env, ctx)
        np.testing.assert_allclose(r.numpy(), 0.3 + 0.2 + 0.4, atol=1e-6)


def test_cmd_progress_accumulates_and_resets(flat_env):
    env = flat_env
    state = env.init_state(3)
    state = env.update_cmd(state, torch.tensor([0.5, 0.0, 0.0]).expand(B, 3))
    np.testing.assert_array_equal(state.cmd_progress.numpy(), 0.0)
    state, _ = env.step(state, torch.zeros(B, 6))
    yaw = quat_ops.yaw(state.physics.base_quat).numpy()
    v = state.physics.base_lin_vel[:, :2].numpy()
    expect = env.dt * (v[:, 0] * np.cos(yaw) + v[:, 1] * np.sin(yaw))
    np.testing.assert_allclose(state.cmd_progress.numpy(), expect, atol=1e-5)
    state0 = env.update_cmd(state, torch.zeros(B, 3))
    state1, _ = env.step(state0, torch.zeros(B, 6))
    np.testing.assert_allclose(state1.cmd_progress.numpy(),
                               state0.cmd_progress.numpy(), atol=1e-6)


# ------------------------------------------------------------ dispatch

def test_plane_takes_the_fused_rollout_without_surface(monkeypatch):
    """At MEGA_MIN_BATCH envs the plane env runs the fused rollout with no
    surface rows (the JAX dispatch, envs/legged_env.py:442-455; the kernel
    built with has_surface False) and never queries a surface; it agrees
    with the scan path at the rollout tolerances of chip_smoke.py."""
    from pointfoot_tpu_torch.ops.cuda import substep as sp
    from pointfoot_tpu_torch.physics import dynamics

    env = make_env("pointfoot_flat", num_envs=B, device="cpu")
    state = env.init_state(0)
    for _ in range(3):
        state, _ = env.step(state, torch.zeros(B, 6))
    actions = 0.3 * torch.ones(B, 6)
    scan = env._physics_rollout(state, actions)
    assert scan[3] is None
    queried, surf_args = [], []
    real_rows = sp.surface_rows
    real_step = sp.rollout_step

    def rows(*args):
        queried.append(1)
        return real_rows(*args)

    def step(mc, state_rows, ctrl_rows, surf_rows, *rest):
        surf_args.append(surf_rows)
        return real_step(mc, state_rows, ctrl_rows, surf_rows, *rest)

    monkeypatch.setattr(sp, "surface_rows", rows)
    monkeypatch.setattr(sp, "rollout_step", step)
    monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", B)
    fused = env._physics_rollout(state, actions)
    assert fused[3] is not None and fused[3].shape == (B, 9, 3)
    assert not queried
    assert surf_args == [None] * env.cfg.control.decimation
    np.testing.assert_allclose(fused[0].qvel.numpy(), scan[0].qvel.numpy(),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(fused[0].base_pos.numpy(),
                               scan[0].base_pos.numpy(), atol=5e-5, rtol=0)
    np.testing.assert_allclose(fused[1].numpy(), scan[1].numpy(), atol=5e-3,
                               rtol=0)
