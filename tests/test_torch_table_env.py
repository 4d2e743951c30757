"""Table terrain, the curriculum knobs and the registry under the port.

- pointfoot_rough with its registered config (table terrain, no
  observation noise): env origins equal to the JAX env's, and an 8-env
  window of model_100000's actor (trained on the table) against the JAX
  env, clear of resets, pushes and command resamples.
- The terrain-curriculum cases of tests/test_env.py
  (`test_terrain_curriculum_credits_arc_walking`,
  `test_cmd_conditioned_promotion_toggle`,
  `test_reference_exact_demotion_toggle`), `test_rough_env_priv_obs` and
  `test_reward_clamp_bounds_freak_envs`, and the command curriculum, under
  the port.
- Every registered config equals the JAX package's, field by field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import export_fields
from pointfoot_tpu_torch.utils import convert, policy_eval
from pointfoot_tpu_torch.utils.registry import TASKS, get_cfgs, make_env

B = 8
ATOL = 2e-3
WARM, STEPS = 3, 5
NOISE_OFF = dict(noise=dict(add_noise=False))
MODEL_100000 = policy_eval.WEIGHTS + "/pointfoot_rough_model_100000_actor.npz"


@pytest.fixture(scope="module")
def window():
    from pointfoot_tpu.utils.registry import task_registry

    jenv = task_registry.make_env("pointfoot_rough", num_envs=B,
                                  cfg_patch=NOISE_OFF)
    tenv = make_env("pointfoot_rough", num_envs=B, device="cpu",
                    cfg_patch=NOISE_OFF)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(tenv, "pointfoot_rough", MODEL_100000))
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


def test_table_window_is_deterministic(window):
    jenv, tenv, pairs = window
    assert not tenv.cfg.terrain.procedural and not tenv.is_plane
    assert type(tenv.terrain).__name__ == "TerrainGrid"
    for js, out, ts, tout in pairs:
        assert not np.asarray(out.done).any()
        assert not tout.done.any()
        assert int(js.common_step) % jenv.push_interval != 0
        assert (np.asarray(js.episode_step) % jenv.resample_interval
                != 0).all()


def test_table_origins_and_heights_equal_jax(window):
    jenv, tenv, _ = window
    for name in ("env_origins", "height", "min3", "slope"):
        assert torch.equal(getattr(tenv.terrain, name), torch.from_numpy(
            np.array(getattr(jenv.terrain, name)))), name


@pytest.mark.parametrize("i", range(STEPS))
def test_table_step_matches_jax(window, i):
    """Observations, reward, physics state and feet state at the golden
    trajectory's atol 2e-3; contact forces at the substep kernel's."""
    jenv, _, pairs = window
    js, out, ts, tout = pairs[i]
    for name, got, want in [
            ("obs", tout.obs, out.obs),
            ("privileged_obs", tout.privileged_obs[:, :27],
             out.privileged_obs[:, :27]),
            ("reward", tout.reward, out.reward)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"step {i} {name}")
    # the 121 height samples against the JAX terrain scanned from the port's
    # own base pose: a sample on a stair riser flips with the float32
    # roundoff between the two poses (as in test_torch_env.py's anymal case)
    pose = js.physics.replace(
        base_pos=jnp.asarray(ts.physics.base_pos.numpy()),
        base_quat=jnp.asarray(ts.physics.base_quat.numpy()))
    heights = np.clip(ts.physics.base_pos.numpy()[:, 2:3] - 0.5
                      - np.asarray(jenv._measured_heights(pose)), -1.0, 1.0)
    np.testing.assert_allclose(tout.privileged_obs[:, 27:].numpy(),
                               5.0 * heights, atol=ATOL, rtol=0,
                               err_msg=f"step {i} heights")
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


# ------------------------- the curriculum cases of tests/test_env.py

def _at_level(env, state, level, offset, cmd, steps, progress):
    """`state` with every env at `level`, `offset` (m, x) from its origin,
    commanded `cmd` (vx, vy, wz, heading), `steps` into its episode with
    `progress` m of along-command credit."""
    n = env.num_envs
    lvl = torch.full((n,), level, dtype=torch.int64)
    origin = env.terrain.env_origins[lvl, state.terrain_type]
    pos = state.physics.base_pos.clone()
    pos[:, :2] = origin[:, :2] + torch.tensor([offset, 0.0])
    return state.replace(
        terrain_level=lvl, env_origin=origin,
        physics=dataclasses.replace(state.physics, base_pos=pos),
        commands=torch.tensor(cmd, dtype=torch.float32).expand(n, 4).clone(),
        episode_step=torch.full((n,), steps, dtype=torch.int64),
        cmd_progress=torch.full((n,), float(progress)))


@pytest.fixture(scope="module")
def rough4():
    return make_env("pointfoot_rough", num_envs=4, device="cpu")


def test_terrain_curriculum_credits_arc_walking(rough4):
    env = rough4
    state = env.init_state(0)
    T = int(env.max_episode_length)
    full = 0.5 * T * env.dt
    state = _at_level(env, state, 3, 0.0, [0.5, 0.0, 1.0, 0.0], T, full)
    done = torch.ones(4, dtype=torch.bool)
    new = env._reset_envs(state, done)
    assert (new.terrain_level >= 3).all(), new.terrain_level
    new2 = env._reset_envs(state.replace(cmd_progress=torch.zeros(4)), done)
    assert (new2.terrain_level == 2).all(), new2.terrain_level


def test_cmd_conditioned_promotion_toggle():
    results = {}
    for on in (False, True):
        env = make_env("pointfoot_rough", num_envs=4, device="cpu",
                       cfg_patch=dict(terrain=dict(
                           cmd_conditioned_promotion=on)))
        T = int(env.max_episode_length)
        covered = 3.5
        assert covered < env.terrain.terrain_length / 2
        state = _at_level(env, env.init_state(0), 3, covered,
                          [0.3, 0.0, 0.0, 0.0], T, covered)
        results[on] = env._reset_envs(
            state, torch.ones(4, dtype=torch.bool)).terrain_level
    assert (results[False] == 3).all(), results[False]
    assert (results[True] == 4).all(), results[True]


def test_reference_exact_demotion_toggle():
    results = {}
    for exact in (False, True):
        env = make_env("pointfoot_rough", num_envs=4, device="cpu",
                       cfg_patch=dict(terrain=dict(
                           reference_exact_demotion=exact)))
        steps = int(env.max_episode_length) // 4
        covered = 0.5 * steps * env.dt
        assert covered < env.terrain.terrain_length / 2
        state = _at_level(env, env.init_state(0), 3, covered,
                          [0.5, 0.0, 0.0, 0.0], steps, covered)
        results[exact] = env._reset_envs(
            state, torch.ones(4, dtype=torch.bool)).terrain_level
    assert (results[False] == 3).all(), results[False]
    assert (results[True] == 2).all(), results[True]


def test_top_level_promotion_draws_a_random_level(rough4):
    env = rough4
    T = int(env.max_episode_length)
    state = _at_level(env, env.init_state(0), env.terrain.num_levels - 1,
                      5.0, [0.5, 0.0, 0.0, 0.0], T, 5.0)
    new = env._reset_envs(state, torch.ones(4, dtype=torch.bool))
    assert ((new.terrain_level >= 0)
            & (new.terrain_level < env.terrain.num_levels)).all()
    assert torch.equal(new.env_origin, env.terrain.env_origins[
        new.terrain_level, new.terrain_type])


def test_command_curriculum_widens_the_range():
    """commands.curriculum (the JAX env's _reset_envs): on an
    episode-length tick, when the envs that end there tracked above 80% of
    the tracking reward's scale, vx's range widens by 0.5 a side, clipped
    to ±max_curriculum; otherwise it stays."""
    env = make_env("pointfoot_rough", num_envs=4, device="cpu",
                   cfg_patch=dict(commands=dict(curriculum=True,
                                                max_curriculum=1.2,
                                                lin_vel_x=(-0.5, 0.5))))
    state = env.init_state(0)
    assert state.lin_vel_x_range.tolist() == [-0.5, 0.5]
    idx = env.reward_names.index("tracking_lin_vel")
    scale = dict(env.reward_terms)["tracking_lin_vel"]
    T = env.max_episode_length
    sums = state.episode_sums.clone()
    sums[:, idx] = 0.9 * scale * T
    good = state.replace(episode_sums=sums,
                         common_step=torch.tensor(2 * T))
    done = torch.ones(4, dtype=torch.bool)
    wide = env._reset_envs(good, done)
    assert wide.lin_vel_x_range.tolist() == [-1.0, 1.0]
    wider = env._reset_envs(wide.replace(episode_sums=sums,
                                         common_step=torch.tensor(3 * T)),
                            done)
    np.testing.assert_allclose(wider.lin_vel_x_range.numpy(), [-1.2, 1.2],
                               rtol=1e-6)
    # off the episode-length tick, with poor tracking, or with no env done
    for st, d in ((good.replace(common_step=torch.tensor(2 * T + 1)), done),
                  (good.replace(episode_sums=state.episode_sums), done),
                  (good, torch.zeros(4, dtype=torch.bool))):
        assert env._reset_envs(st, d).lin_vel_x_range.tolist() == \
            [-0.5, 0.5]
    # the widened range feeds the resampler
    cmds = env._resample_commands(wide, done).commands[:, 0]
    assert bool(((cmds >= -1.0) & (cmds <= 1.0)).all())
    off = make_env("pointfoot_rough", num_envs=4, device="cpu")
    s = off.init_state(0)
    assert torch.equal(off._reset_envs(s.replace(
        common_step=torch.tensor(0)), done).lin_vel_x_range,
        s.lin_vel_x_range)


def test_rough_env_priv_obs():
    env = make_env("pointfoot_rough", num_envs=4, device="cpu")
    state = env.init_state(1)
    state, out = env.step(state, torch.zeros(4, 6))
    assert out.obs.shape == (4, 27)
    assert out.privileged_obs.shape == (4, 148)
    assert float(out.privileged_obs[:, 27:].abs().max()) <= 5.0 + 1e-5


def test_reward_clamp_bounds_freak_envs(rough4):
    env = rough4
    state = env.init_state(0)
    phys = state.physics
    pos, lin, qvel = (phys.base_pos.clone(), phys.base_lin_vel.clone(),
                      phys.qvel.clone())
    pos[:2, 2] = -3.0
    lin[:2] = torch.tensor([30.0, -30.0, -45.0])
    qvel[:2] = 19.0
    state = state.replace(physics=dataclasses.replace(
        phys, base_pos=pos, base_lin_vel=lin, qvel=qvel))
    state, out = env.step(state, 100.0 * torch.ones(4, 6))
    assert torch.isfinite(out.reward).all()
    assert float(out.reward.abs().max()) <= 100.0
    sums = state.episode_sums
    assert torch.isfinite(sums).all() and float(sums.abs().max()) <= 2000.0


# ------------------------------------------------------------- registry

def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# the JAX dataclasses' fields that neither package reads: legged_gym's
# Isaac Gym settings, kept there for the reference's config files
UNREAD_JAX_FIELDS = {
    "env.send_timeouts", "commands.num_commands", "init_state.lin_vel",
    "init_state.ang_vel", "asset.self_collisions", "asset.fix_base_link",
    "terrain.vertical_scale", "terrain.dynamic_friction",
    "terrain.restitution", "terrain.slope_treshold",
    "terrain.measure_heights",
}


def _split(port, jax_side, prefix=""):
    """(port's values, JAX's values on the port's fields, JAX-only paths)."""
    extra = set()
    if not isinstance(jax_side, dict):
        return port, jax_side, extra
    shared = {}
    for k, v in jax_side.items():
        path = f"{prefix}{k}"
        if k not in port:
            extra.add(path)
            continue
        port[k], shared[k], sub = _split(port[k], v, path + ".")
        extra |= sub
    return port, shared, extra


@pytest.mark.parametrize("task", sorted(TASKS))
def test_registered_config_equals_jax(task):
    from pointfoot_tpu.utils.registry import task_registry

    jenv_cfg, jtrain_cfg = task_registry.get_cfgs(task)
    env_cfg, train_cfg = get_cfgs(task)
    port, jax_shared, extra = _split(_plain(dataclasses.asdict(env_cfg)),
                                     _plain(dataclasses.asdict(jenv_cfg)))
    assert port == jax_shared
    assert extra == UNREAD_JAX_FIELDS
    assert _plain(dataclasses.asdict(train_cfg)) == \
        _plain(dataclasses.asdict(jtrain_cfg))


def test_registry_names_equal_jax():
    from pointfoot_tpu.utils.registry import task_registry

    assert sorted(TASKS) == sorted(task_registry.task_names)
