"""The slice as a whole: the port's LeggedEnv vs the JAX LeggedEnv.

A JAX pointfoot_rough env on procedural terrain (8 envs, no observation
noise) walks the flagship actor a few steps; its EnvState goes over to the
port through utils/convert.py, and both envs take 5 more steps with the
same actions, clear of push and command-resample ticks and of resets.
Observations, privileged observations, rewards and the physics state agree
at the golden-trajectory tolerance (atol 2e-3); contact forces, O(100 N),
at the substep kernel's (atol 0.05, rtol 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import B, export_fields, jax_rough_env, torch_rough_env
from pointfoot_tpu_torch.utils import convert, policy_eval

ATOL = 2e-3
WARM, STEPS = 3, 5


@pytest.fixture(scope="module")
def trajectories():
    jenv = jax_rough_env()
    tenv = torch_rough_env()
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(tenv, "pointfoot_rough"))
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


def test_window_is_deterministic(trajectories):
    """No resets, no push tick, no command resample inside the window."""
    jenv, _, pairs = trajectories
    for js, out, ts, tout in pairs:
        assert not np.asarray(out.done).any()
        assert not tout.done.any()
        step = int(js.common_step)
        assert step % jenv.push_interval != 0
        assert (np.asarray(js.episode_step) % jenv.resample_interval
                != 0).all()


def test_terrain_origins_match(trajectories):
    jenv, tenv, _ = trajectories
    np.testing.assert_allclose(tenv.terrain.env_origins.numpy(),
                               np.asarray(jenv.terrain.env_origins),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("i", range(STEPS))
def test_step_matches_jax(trajectories, i):
    _, _, pairs = trajectories
    js, out, ts, tout = pairs[i]
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
    for name in ("feet_air_time", "last_contacts", "commands", "torques",
                 "episode_sums", "cmd_progress"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy().astype(np.float64),
            np.asarray(getattr(js, name), np.float64), atol=ATOL, rtol=1e-3,
            err_msg=f"step {i} {name}")


# ------------------------------------------------ anymal_c_rough, the slice

ANYMAL_B = 4
ANYMAL_PATCH = dict(
    terrain=dict(procedural=True, terrain_proportions=(0.1, 0.1, 0.35, 0.45)),
    noise=dict(add_noise=False))


def _bench_actions(phase, t):
    """bench.py's deterministic action signal, 0.2 sin(phase + 0.1 t)."""
    return (0.2 * np.sin(phase + 0.1 * t)).astype(np.float32)


@pytest.fixture(scope="module")
def anymal_trajectories():
    """A JAX anymal_c_rough env on procedural terrain (4 envs on terrain
    columns 0-3, no observation noise) takes 5 steps of the bench signal;
    its EnvState, actuator carry included, goes over to the port, and both
    take 3 more steps with the same actions."""
    from pointfoot_tpu.utils.registry import task_registry
    from pointfoot_tpu_torch.utils.registry import make_env

    jenv = task_registry.make_env("anymal_c_rough", num_envs=ANYMAL_B,
                                  cfg_patch=ANYMAL_PATCH)
    tenv = make_env("anymal_c_rough", num_envs=ANYMAL_B, device="cpu",
                    cfg_patch=ANYMAL_PATCH)
    phase = np.random.default_rng(0).uniform(0.0, 6.28, (ANYMAL_B, 12))
    step = jax.jit(jenv.step)
    js = jenv.init_state(jax.random.PRNGKey(1))
    t = 0
    for t in range(5):
        js, _ = step(js, jnp.asarray(_bench_actions(phase, t)))
    ts = convert.env_state_from_numpy(export_fields(js))
    pairs = []
    for t in range(t + 1, t + 4):
        a = _bench_actions(phase, t)
        js, out = step(js, jnp.asarray(a))
        ts, tout = tenv.step(ts, torch.from_numpy(a))
        pairs.append((js, out, ts, tout))
    return jenv, tenv, pairs


def test_anymal_window_is_deterministic(anymal_trajectories):
    jenv, tenv, pairs = anymal_trajectories
    assert tenv.use_actuator_net and tenv.cfg.obs_style == "legged"
    for js, out, ts, tout in pairs:
        assert not np.asarray(out.done).any()
        assert not tout.done.any()
        assert int(js.common_step) % jenv.push_interval != 0
        assert (np.asarray(js.episode_step) % jenv.resample_interval
                != 0).all()


@pytest.mark.parametrize("i", range(3))
def test_anymal_step_matches_jax(anymal_trajectories, i):
    """The 48 proprioceptive observations, reward, physics state and
    actuator carry at atol 2e-3; contact forces, O(100 N), at the substep
    kernel's atol 0.05, rtol 1e-3.  The 187 height samples are held at
    atol 2e-3 to the JAX terrain scanned from the port's own base pose: a
    sample on a stair edge flips with the float32 roundoff between the two
    poses."""
    jenv, _, pairs = anymal_trajectories
    js, out, ts, tout = pairs[i]
    assert tout.obs.shape == (ANYMAL_B, 235)
    assert tout.privileged_obs is None and out.privileged_obs is None
    for name, got, want in [("obs", tout.obs[:, :48], out.obs[:, :48]),
                            ("reward", tout.reward, out.reward),
                            ("actuator_carry", ts.actuator_carry,
                             js.actuator_carry)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {i} {name}")
    pose = js.physics.replace(
        base_pos=jnp.asarray(ts.physics.base_pos.numpy()),
        base_quat=jnp.asarray(ts.physics.base_quat.numpy()))
    heights = np.clip(ts.physics.base_pos.numpy()[:, 2:3] - 0.5
                      - np.asarray(jenv._measured_heights(pose)), -1.0, 1.0)
    np.testing.assert_allclose(tout.obs[:, 48:].numpy(), 5.0 * heights,
                               atol=ATOL, rtol=0, err_msg=f"step {i} heights")
    for f in dataclasses.fields(ts.physics):
        got = getattr(ts.physics, f.name).numpy()
        want = np.asarray(getattr(js.physics, f.name))
        if f.name == "contact_force":
            assert np.abs(want).max() > 10.0, "the feet should bear load"
            np.testing.assert_allclose(got, want, atol=0.05, rtol=1e-3,
                                       err_msg=f"step {i} {f.name}")
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                       err_msg=f"step {i} {f.name}")
    np.testing.assert_allclose(ts.torques.numpy(), np.asarray(js.torques),
                               atol=ATOL, rtol=1e-3, err_msg=f"step {i}")


# --------------------------------------- every task the port can build

def _registered_tasks():
    from pointfoot_tpu_torch.utils.registry import TASKS

    return sorted(TASKS)


@pytest.mark.parametrize("task", _registered_tasks())
def test_registered_task_steps(task):
    """The port's counterpart of tests/test_env.py:283-298: each registered
    task builds with its registered config, no override (plane terrain for
    the flat tasks, table terrain for the others), and takes 3 steps with
    finite outputs."""
    from pointfoot_tpu_torch.terrain.grid import TerrainGrid
    from pointfoot_tpu_torch.utils.registry import get_cfgs, make_env

    cfg = get_cfgs(task)[0]
    assert not cfg.terrain.procedural
    env = make_env(task, num_envs=2, device="cpu")
    assert isinstance(env.terrain, TerrainGrid)
    assert env.is_plane == (cfg.terrain.mesh_type == "plane")
    state = env.init_state(0)
    for _ in range(3):
        state, out = env.step(state, torch.zeros(2, env.num_actions))
    assert out.obs.shape == (2, env.num_obs)
    assert torch.isfinite(out.obs).all()
    assert torch.isfinite(out.reward).all()
    if env.num_privileged_obs:
        assert out.privileged_obs.shape == (2, env.num_privileged_obs)


def test_physics_rollout_dispatch(monkeypatch):
    """As pointfoot_tpu/envs/legged_env.py:442-499: the fused rollout (which
    returns the final sphere positions) for PD control from MEGA_MIN_BATCH
    envs, the scan path of step_batched otherwise and always with the
    actuator network."""
    from pointfoot_tpu_torch.physics import dynamics
    from pointfoot_tpu_torch.utils.registry import make_env

    env = torch_rough_env()
    state = env.init_state(0)
    actions = torch.zeros(B, 6)
    assert dynamics.MEGA_MIN_BATCH == 4096
    assert env._physics_rollout(state, actions)[3] is None  # the scan path
    monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", B)
    fused = env._physics_rollout(state, actions)
    assert fused[3] is not None and fused[3].shape == (B, 9, 3)
    anymal = make_env("anymal_c_rough", num_envs=2, device="cpu",
                      cfg_patch=dict(terrain=dict(procedural=True)))
    monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", 2)
    astate = anymal.init_state(0)
    assert anymal._physics_rollout(astate, torch.zeros(2, 12))[3] is None
