"""rl/runner.py of the PyTorch port against the JAX package's runner, and
the training entry points (train.py, bench --mode train).

One training iteration of pointfoot_rough (procedural terrain, 8 envs,
4 steps an iteration, observation noise and pushes off): the JAX runner
takes a warm iteration from its fresh state, then its TrainState and
EnvState go over to the port (utils/convert.py) and both take one more
iteration with JAX's action-noise draws and minibatch permutations.  No
env resets or command resamples fall in the window, so the env is
deterministic on both sides.  The transitions agree at the env parity
tests' tolerance (atol 2e-3; measured 1.3e-5 on the observations); the
PPO metrics and parameters as in tests/test_torch_ppo.py, whose
module docstring explains the Adam bound.

The benchmark and the runs of `learn` take a bench lock of their own, not
the repository's, so that they never pause a trainer of another test
process.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_parity import (ROUGH_PATCH, adam_bound, export_fields,
                           jax_minibatches)
from pointfoot_tpu.utils.registry import task_registry
from pointfoot_tpu_torch import bench, train
from pointfoot_tpu_torch.envs.legged_env import STEP_PHASES
from pointfoot_tpu_torch.rl.ppo import Transition
from pointfoot_tpu_torch.utils import convert
from pointfoot_tpu_torch.utils.registry import (get_cfgs, make_alg_runner,
                                                make_env)


@pytest.fixture(autouse=True)
def private_bench_lock(tmp_path, monkeypatch):
    monkeypatch.setenv("POINTFOOT_BENCH_LOCK", str(tmp_path / "bench_lock"))


B, T = 8, 4
ATOL = 2e-3  # tests/test_torch_env.py
RTOL = 1e-5  # tests/test_torch_ppo.py
PATCH = dict(ROUGH_PATCH, domain_rand=dict(push_robots=False))
TINY = dict(terrain=dict(procedural=True))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _short(tc, **runner):
    return replace(tc, runner=replace(tc.runner, num_steps_per_env=T,
                                      **runner))


@pytest.fixture(scope="module")
def iteration_pair():
    jenv = task_registry.make_env("pointfoot_rough", num_envs=B,
                                  cfg_patch=PATCH)
    _, jtc = task_registry.get_cfgs("pointfoot_rough")
    jr = task_registry.make_alg_runner(jenv, "pointfoot_rough",
                                       train_cfg=_short(jtc))

    def iteration(ts, es, obs, priv, key):
        """JAX's `train_iteration`, also returning the rollout."""
        k_roll, k_update = jax.random.split(key)
        es, obs, priv, roll, infos = jr.rollout(ts, es, obs, priv, k_roll)
        last = jr.network.apply(ts.params, priv, method=jr.network.value)
        ts, metrics = jr.ppo.update(ts, roll, last, k_update)
        return jr._finish_iteration(ts, es, obs, priv, roll, infos,
                                    metrics) + (roll, last)

    it = jax.jit(iteration)
    ts, es = jr.init(jax.random.PRNGKey(0))
    # through numpy: drops the weak types init leaves on log_std, which
    # would make the second call compile again
    ts = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), ts)
    obs = jnp.zeros((B, jenv.num_obs))
    priv = jnp.zeros((B, jenv.num_privileged_obs))
    ts1, es1, obs1, priv1, _, _, _ = it(ts, es, obs, priv,
                                        jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    ts2, es2, _, _, jm, jroll, jlast = it(ts1, es1, obs1, priv1, key)

    k_roll, k_update = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 6)))
                      for k in jax.random.split(k_roll, T)])
    perms = [np.asarray(jax.random.permutation(k, T * B))
             for k in jax.random.split(k_update, 5)]
    mb, grads, ts_loop = jax_minibatches(jr.ppo, ts1, jroll, jlast, perms)

    tenv = make_env("pointfoot_rough", num_envs=B, device="cpu",
                    cfg_patch=PATCH)
    tr = make_alg_runner(tenv, "pointfoot_rough",
                         train_cfg=_short(get_cfgs("pointfoot_rough")[1]))
    tr.ppo.load_state_dict(convert.train_state_from_numpy(
        serialization.to_state_dict(jax.device_get(ts1))))
    tes = convert.env_state_from_numpy(export_fields(es1))
    tes2, _, _, tm = tr.train_iteration(
        tes, torch.from_numpy(np.asarray(obs1)),
        torch.from_numpy(np.asarray(priv1)), noise=torch.from_numpy(noise),
        perms=[torch.from_numpy(p.astype(np.int64)) for p in perms])
    return dict(jenv=jenv, es1=es1, es2=es2, jroll=jroll, jm=jm, ts2=ts2,
                mb=mb, grads=grads, ts_loop=ts_loop, tr=tr, tes2=tes2,
                tm=tm)


def test_window_is_deterministic(iteration_pair):
    """No done, no command resample in the window (pushes are off)."""
    p = iteration_pair
    assert not np.asarray(p["jroll"].done).any()
    assert not bool(p["tr"].storage.done.any())
    steps = np.asarray(p["es1"].episode_step)[None] + np.arange(1, T + 1)[
        :, None]
    assert (steps % p["jenv"].resample_interval != 0).all()
    np.testing.assert_array_equal(p["tes2"].episode_step.numpy(),
                                  np.asarray(p["es2"].episode_step))


@pytest.mark.parametrize("name", ["obs", "priv_obs", "action", "reward",
                                  "done", "time_out", "value", "log_prob",
                                  "mean", "std"])
def test_transitions_match_jax(iteration_pair, name):
    got = getattr(iteration_pair["tr"].storage, name).numpy()
    want = np.asarray(getattr(iteration_pair["jroll"], name))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), atol=ATOL, rtol=0,
                               err_msg=name)


def test_iteration_metrics_match_jax(iteration_pair):
    jm, tm = iteration_pair["jm"], iteration_pair["tm"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(tm[k], np.float64),
                                   np.asarray(jm[k], np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_iteration_lr_branches_match_jax(iteration_pair):
    got = iteration_pair["tr"].ppo.minibatch_metrics["lr_intra"].numpy()
    want = np.array([m["lr_intra"] for m in iteration_pair["mb"]])
    np.testing.assert_array_equal(np.sign(np.diff(got)),
                                  np.sign(np.diff(want)))
    np.testing.assert_allclose(got, want, rtol=len(got) * 1.2e-7, atol=0)


def test_iteration_params_match_jax(iteration_pair):
    p = iteration_pair
    want = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                        p["ts2"].params))
    loop = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, p["ts_loop"].params))
    state = p["tr"].ppo.state_dict()
    assert state["update_count"] == int(p["ts2"].update_count)
    for k, got in state["params"].items():
        # the unrolled loop whose gradients set the bound is JAX's update
        np.testing.assert_allclose(loop[k].numpy(), want[k].numpy(),
                                   atol=1e-7, rtol=0, err_msg=k)
        err = np.abs(got.numpy() - want[k].numpy())
        assert (err <= adam_bound(p["grads"], p["mb"], k)).all(), \
            (k, err.max())


# ---------------------------------------------------------- checkpoints

def _tiny_runner(num_envs, log_dir=None, task="pointfoot_rough"):
    env = make_env(task, num_envs=num_envs, device="cpu", cfg_patch=TINY)
    tc = get_cfgs(task)[1]
    tc = replace(tc, policy=replace(tc.policy, actor_hidden_dims=(32,),
                                    critic_hidden_dims=(32,)),
                 runner=replace(tc.runner, num_steps_per_env=2))
    return make_alg_runner(env, task, log_dir=log_dir, train_cfg=tc)


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_checkpoint.py:12-40 on the port's torch checkpoints:
    parameters, Adam state, rate, counts and env state come back."""
    runner = _tiny_runner(4, str(tmp_path))
    es = runner.init(0)
    es, out = runner.env.step(es, torch.zeros(4, 6))
    es, _, _, _ = runner.train_iteration(es, out.obs, out.privileged_obs)
    runner.ppo.learning_rate = np.float32(0.123)
    runner.current_iteration = 42
    path = runner.save(es)
    assert path.endswith("model_42.pt")

    runner2 = _tiny_runner(4)
    es0 = runner2.init(1)
    es2 = runner2.load(path, es0)
    assert runner2.current_iteration == 42
    assert runner2.ppo.learning_rate == np.float32(0.123)
    assert runner2.ppo.update_count == runner.ppo.update_count == 20
    a, b = runner.ppo.state_dict(), runner2.ppo.state_dict()
    assert a["adam_step"] == b["adam_step"] == 20
    for k, v in a["params"].items():
        torch.testing.assert_close(b["params"][k], v, rtol=0, atol=0)
        for m in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(b["adam"][k][m], a["adam"][k][m],
                                       rtol=0, atol=0)
    torch.testing.assert_close(es2.physics.base_pos, es.physics.base_pos,
                               rtol=0, atol=0)
    torch.testing.assert_close(es2.episode_step, es.episode_step, rtol=0,
                               atol=0)
    assert type(es2) is type(es0)


def test_checkpoint_load_with_different_env_batch(tmp_path):
    """A checkpoint of 4 envs loaded beside 2: the fresh env state stays,
    the train state comes back."""
    runner = _tiny_runner(4, str(tmp_path))
    es = runner.init(0)
    path = runner.save(es)
    runner2 = _tiny_runner(2)
    es0 = runner2.init(1)
    es2 = runner2.load(path, es0)
    assert es2 is es0
    for k, v in runner.ppo.state_dict()["params"].items():
        torch.testing.assert_close(runner2.network.state_dict()[k], v,
                                   rtol=0, atol=0)


# ---------------------------------------------- the training entry points

def test_learn_symmetric_critic_task(tmp_path):
    """tests/test_ppo.py:202-230 on the port: a1 has no privileged
    observations, so the observations stand in for them; two iterations
    of `learn` log, save, and give a finite inference policy."""
    env = make_env("a1", num_envs=8, device="cpu", cfg_patch=TINY)
    assert env.num_privileged_obs is None
    tc = get_cfgs("a1")[1]
    tc = replace(tc, policy=replace(tc.policy, actor_hidden_dims=(32,),
                                    critic_hidden_dims=(32,)),
                 runner=replace(tc.runner, num_steps_per_env=8))
    runner = make_alg_runner(env, "a1", log_dir=str(tmp_path),
                             train_cfg=tc)
    runner._writer = False  # metrics.jsonl only
    es = runner.learn(2, seed=0, log_every=1)
    assert runner.current_iteration == 2
    assert runner.storage.priv_obs is runner.storage.obs
    lines = [json.loads(s) for s in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["it"] for m in lines] == [1, 2]
    assert all(np.isfinite(m["kl"]) and np.isfinite(m["mean_reward"])
               for m in lines)
    # the row of each logged iteration (utils/profiling.py): the rollout,
    # update and host-wait split, the terrain and each env phase; no mesh,
    # no collectives
    phases = [f"env_{p}_ms" for p in STEP_PHASES]
    for m in lines:
        assert m["rollout_s"] > 0 and m["update_s"] > 0
        assert 0 < m["host_wait_s"] < m["update_s"]
        assert m["terrain_ms_per_step"] > 0 and m["terrain_ns_per_point"] > 0
        assert all(m[k] >= 0 for k in phases) and m["env_physics_ms"] > 0
        assert "collective_s" not in m and "dp_bytes" not in m
    assert (tmp_path / "model_2.pt").exists()
    a = runner.get_inference_policy()(torch.zeros(8, env.num_obs))
    assert a.shape == (8, env.num_actions)
    assert bool(torch.isfinite(a).all())
    assert bool(torch.isfinite(es.physics.base_pos).all())


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    common = ["--device", "cpu", "--num_envs", "4", "--log_dir",
              str(tmp_path), "--log_every", "1", "--override",
              "terrain.procedural=true", "--train_override",
              "runner.num_steps_per_env=2", "--train_override",
              "policy.actor_hidden_dims=(32,)", "--train_override",
              "policy.critic_hidden_dims=(32,)", "--train_override",
              "algorithm.max_lr=2.5e-4"]
    runner = train.main(common + ["--max_iterations", "1"])
    assert runner.cfg.algorithm.max_lr == 2.5e-4
    assert (tmp_path / "model_1.pt").exists()
    runner = train.main(common + ["--max_iterations", "1", "--resume",
                                  "--load_run",
                                  str(tmp_path / "model_1.pt")])
    assert "resumed from" in capsys.readouterr().out
    assert runner.current_iteration == 2
    assert (tmp_path / "model_2.pt").exists()
    cfgs = [json.loads(s) for s in
            (tmp_path / "run_config.jsonl").read_text().splitlines()]
    assert len(cfgs) == 2
    assert cfgs[0]["env_cfg"]["terrain"]["procedural"] is True
    assert cfgs[0]["train_cfg"]["algorithm"]["max_lr"] == 2.5e-4
    assert cfgs[1]["argv"][-3:] == ["--resume", "--load_run",
                                    str(tmp_path / "model_1.pt")]


def test_train_override_rejects_malformed():
    with pytest.raises(SystemExit):
        train.parse_override("algorithm.max_lr", "--train_override")
    assert train.parse_override("a.b=true", "--override") == ("a", "b", True)
    assert train.parse_override("a.b=(1, 2)", "--override") == \
        ("a", "b", (1, 2))


def test_bench_train_record(capsys):
    rec = bench.main(["--mode", "train", "--device", "cpu", "--num_envs",
                      "2", "--reps", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        rec
    assert rec["metric"] == "train_env_steps_per_sec@2envs_pointfoot_rough"
    assert rec["unit"] == "steps/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / (2 * 50.0),
                                               abs=1e-3)
    cond = rec["conditions"]
    assert cond["card"] == "cpu" and cond["iters"] == 1
    assert len(cond["reps_steps_per_sec"]) == 1
    assert cond["rollout_s"] > 0 and cond["update_s"] > 0
    assert cond["num_steps_per_env"] == 24


def test_rollout_storage_is_reused():
    """Preallocated (T, B, ...) storage, filled in place each iteration."""
    runner = _tiny_runner(2)
    es = runner.init(0)
    es, out = runner.env.step(es, torch.zeros(2, 6))
    es, obs, priv, roll, _ = runner.rollout(es, out.obs, out.privileged_obs)
    assert isinstance(roll, Transition) and roll.obs.shape[:2] == (2, 2)
    first = roll.obs.data_ptr()
    _, _, _, roll2, _ = runner.rollout(es, obs, priv)
    assert roll2.obs.data_ptr() == first
    assert not roll2.obs.requires_grad and roll2.action.grad_fn is None
