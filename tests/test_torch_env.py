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
